"""The port's spans and counters (``utils/profiling.py``) on the CPU."""

import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from stereo_match_tpu_torch.config import DisparityConfig
from stereo_match_tpu_torch.parallel.batch import batched_matcher
from stereo_match_tpu_torch.parallel.mesh import make_mesh
from stereo_match_tpu_torch.pipeline.stereo import StereoMatcher
from stereo_match_tpu_torch.utils import profiling

CFG = DisparityConfig(num_disparities=16, wls=False, speckle_window_size=0)
MATCH_SPANS = ("smt.cost", "smt.sgm", "smt.wta")


@pytest.fixture(autouse=True)
def clean_registry():
    profiling.reset()
    yield
    profiling.reset()


def _pairs(frames, H=12, W=40):
    rng = np.random.default_rng(3)
    return rng.integers(0, 256, (2, frames, H, W)).astype(np.uint8)


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_span_off_without_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with profiling.span("smt.test"):
        pass
    assert profiling.snapshot() == {"spans": {}, "counters": {}}


def test_span_records_inside_profiler_trace(tmp_path):
    with _cpu_profile() as prof:
        with record_function("outer"):
            with profiling.span("smt.test"):
                time.sleep(0.002)
    s = profiling.spans["smt.test"]
    assert s["calls"] == 1 and s["ns"] >= 2_000_000
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = {e["name"]: e for e in json.loads(path.read_text())
              ["traceEvents"] if e.get("cat") == "user_annotation"}
    inner, outer = events["smt.test"], events["outer"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    # the registry's time is taken inside the annotation, on its clock
    assert s["ns"] / 1e3 <= inner["dur"] + 1.0
    profiling.reset()
    assert profiling.snapshot() == {"spans": {}, "counters": {}}


@pytest.mark.parametrize("entry", ["matcher", "batched_matcher"])
def test_entry_spans_once_a_call_and_match_spans_once_a_frame(entry):
    lefts, rights = _pairs(2)
    if entry == "matcher":
        m = StereoMatcher(CFG, device="cpu")
        calls = [lambda: m(lefts[0], rights[0]),
                 lambda: m.batched(lefts, rights)]
    else:
        fn = batched_matcher(CFG, make_mesh(batch=2, devices=["cpu"] * 2))
        calls = [lambda: fn(lefts, rights), lambda: fn(lefts, rights)]
    frames = 3 if entry == "matcher" else 4
    with _cpu_profile():
        for call in calls:
            call()
    spans = profiling.snapshot()["spans"]
    assert spans["smt.upload"]["calls"] == 2
    assert {n: spans[n]["calls"] for n in MATCH_SPANS} == \
        dict.fromkeys(MATCH_SPANS, frames)
    assert set(spans) == {"smt.upload", *MATCH_SPANS}
    assert all(s["ns"] > 0 for s in spans.values())
    assert profiling.counters["frames"] == frames


def test_counters_count_without_profiler_and_upload_nothing_on_cpu():
    lefts, rights = _pairs(2)
    m = StereoMatcher(CFG, device="cpu")
    m(lefts[0], rights[0])
    m.batched(torch.from_numpy(lefts), torch.from_numpy(rights))
    assert profiling.snapshot() == {
        "spans": {}, "counters": {"frames": 3, "upload_bytes": 0}}
    profiling.count("upload_bytes", 7)
    profiling.count("upload_bytes", 5)
    assert profiling.counters["upload_bytes"] == 12
