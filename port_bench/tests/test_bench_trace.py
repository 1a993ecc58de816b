"""The trace reduction on a hand-made Chrome trace."""

import json

import pytest

from port_bench.trace import reduce_trace


def ev(cat, name, ts, dur, **kw):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur, **kw}


def test_reduce_trace(tmp_path):
    events = [
        ev("user_annotation", "bench.window", 0, 100, tid=1),
        ev("user_annotation", "bench.entry", 0, 40, tid=1),
        ev("cpu_op", "aten::to", 0, 10, tid=1),
        ev("user_annotation", "bench.download", 60, 40, tid=1),
        ev("cpu_op", "aten::to", 60, 40, tid=1),
        ev("kernel", "void sgm_path_scan_kernel<float>", 10, 30,
           args={"device": 0}),
        ev("kernel", "void census_words_fixed<5, 5>", 40, 10,
           args={"device": 0}),
        ev("gpu_memcpy", "Memcpy DtoH", 90, 5, args={"device": 0}),
        ev("kernel", "void elementwise_kernel", 20, 20, args={"device": 1}),
        ev("kernel", "late", 150, 5, args={"device": 0}),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    red = reduce_trace(str(path), {"cost": ["census_words"],
                                   "sgm": ["sgm_path_scan"]})
    assert red["window_s"] == pytest.approx(100e-6)
    assert red["layer_s"] == pytest.approx(
        {"sgm": 30e-6, "cost": 10e-6, "other": 20e-6, "copy": 5e-6})
    busy = {d["device"]: d["busy_s"] for d in red["devices"]}
    assert busy == pytest.approx({0: 45e-6, 1: 20e-6})
    idle = dict(red["idle_gaps"])
    # a gap is labelled by what the host did when it began. Card 0 idles
    # 0-10 (in the entry's aten::to), 50-90 (between the spans), 95-100
    # (in the download's aten::to); card 1 idles 0-20 (entry) and 40-100
    # (the entry ended at 40)
    assert idle == pytest.approx({"bench.entry/aten::to": 30e-6,
                                  "bench.loop": 100e-6,
                                  "bench.download/aten::to": 5e-6})
    assert red["device_ops"][0] == ("void sgm_path_scan_kernel<float>",
                                    pytest.approx(30e-6))
