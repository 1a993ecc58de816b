"""BENCHMARK.json against the benchmark's rules, and the harness finding a
new cell and a new metric from new files alone."""

import json
import re
import shutil
import time

import pytest

from port_bench import manifest
from port_bench.core import run_cell

BENCH = manifest.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = re.compile(r"(hidden|intermediate|latent|state|projection|_dim$|"
                    r"_rank$|head_size|expansion|feature_maps|experts_per)")


def line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_names_units_and_lines():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [c["name"] for c in BENCH["configs"]]
    names += [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    for group in ("end_to_end", "per_layer", "workloads", "configs"):
        got = [x["name"] for x in BENCH[group]]
        assert len(got) == len(set(got)), group
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    assert all(line(w["why"]) for w in BENCH["workloads"] + BENCH["configs"])
    assert all(line(c["source"]) for c in BENCH["configs"])
    assert all(line(m["layer"]) for m in BENCH["per_layer"])
    assert all(line(w) for w in BENCH["command"])
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_bounds_and_run_length():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25, m
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    s = BENCH["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    runs = 2 + 14 * 24
    assert runs * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_every_cell_finds_its_files():
    here = manifest.HERE
    for w in BENCH["workloads"]:
        for part, name in (("configs", w["config"]),
                           ("traffic", w["traffic"]),
                           ("checks", w["config"])):
            assert (here / part / f"{name}.json").is_file(), (part, name)
        cell = manifest.load_cell(w["name"])
        assert cell.chips in (1, 4)
        kind, entry = cell.traffic["kind"], cell.traffic["entry"]
        assert (here / "traffic" / f"{kind}.py").is_file(), kind
        assert (here / "entries" / f"{entry}.py").is_file(), entry
        ref = cell.checks["reference"]
        assert (here / "reference" / f"{ref}.py").is_file(), ref
    tables = manifest.kernel_tables()
    for m in BENCH["per_layer"]:
        assert (here / "metrics" / f"{m['name']}.py").is_file(), m["name"]
        if m["name"].endswith(("device_ms", "_roofline")):
            assert m["layer"] in tables, m
    for spec in manifest.layer_files():
        if "work" in spec:
            assert (here / "work" / f"{spec['work']}.py").is_file()


def test_configs_state_their_cuts():
    for c in BENCH["configs"]:
        data = json.loads((manifest.ROOT / c["file"]).read_text())
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        assert data["reduced"] == c["reduced"]
        assert all(k in data and not WIDTHS.search(k) for k in c["reduced"])
        assert data["name"] == c["name"] and data["source"] == c["source"]


def test_per_layer_metrics_come_with_what_they_move():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = [w["name"] for w in BENCH["workloads"]]
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert manifest.reports(e2e[m["moves"]], cell), (m, cell)
    for cell in cells:
        reported = [m for m in BENCH["per_layer"] if manifest.reports(m, cell)]
        assert reported and len([m for m in BENCH["end_to_end"]
                                 if manifest.reports(m, cell)]) >= 2


def test_at_most_one_four_chip_cell():
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)
    assert all(w["chips"] in (1, 4) for w in BENCH["workloads"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_command_stays_under_paths():
    assert BENCH["command"][:1] == ["python3"]
    for word in BENCH["command"][1:]:
        assert not word.startswith("/") and ".." not in word
        assert word.startswith(tuple(p + "/" for p in BENCH["paths"]))
    assert 1 <= len(BENCH["paths"]) <= 16


def test_new_cell_and_metric_from_new_files(tmp_path):
    """A later change adds a traffic mix, a cell and a per-layer metric as
    new files and entries; the harness runs them unchanged."""
    shutil.copytree(manifest.HERE, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    traffic = json.loads((manifest.HERE / "traffic/seq.json").read_text())
    traffic.update(pool=3, noise=0.0)
    (tmp_path / "port_bench/traffic/seq3.json").write_text(
        json.dumps(traffic))
    (tmp_path / "port_bench/metrics/entry.calls.py").write_text(
        "def read(r):\n    return r.frames / r.traffic['frames_per_call']\n")
    bench["workloads"].append({"name": "census_kitti.seq3",
                               "config": "census_kitti", "traffic": "seq3",
                               "chips": 1, "why": "a test cell"})
    bench["per_layer"].append({"name": "entry.calls", "unit": "calls",
                               "better": "higher", "source": "host_clock",
                               "layer": "entry", "moves": "fps",
                               "workloads": ["census_kitti.seq3"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    out = run_cell("census_kitti.seq3", 3, 0.2, True, time.perf_counter(),
                   on_card=False, size=(24, 48, 16), root=tmp_path,
                   log=lambda _: None)
    assert out["correct"]
    assert out["metrics"]["entry.calls"]["value"] == out["attempted"]
    assert set(out["metrics"]) == {"entry.calls"}
    with pytest.raises(SystemExit):
        manifest.load_cell("census_kitti.seq3")


KIND = '''
import time


def warm_up(fn, pool, mix):
    fn(*pool.call(0, 1)[:2]).cpu()


def run(fn, pool, mix, seconds, window):
    t0 = window.open()
    for c in range(mix["calls"]):
        ls, rs, pairs = pool.call(c, 1)
        due = t0 + c * mix["period_s"]
        with window.entry():
            out = fn(ls, rs)
        with window.download():
            maps = out.cpu().numpy()
        window.done(pairs, maps, due, time.perf_counter())
    window.close(time.perf_counter())
'''

ENTRY = '''
def build(cfg, devices, root):
    from port_bench import system
    from stereo_match_tpu_torch.pipeline.stereo import StereoMatcher
    matcher = StereoMatcher(system.disparity_config(cfg), device=devices[0])
    return lambda ls, rs: matcher.batched(ls[:1], rs[:1])[0]
'''


def test_new_traffic_kind_and_entry_from_new_files(tmp_path):
    """A later change adds a traffic kind (``traffic/<kind>.py``) and an
    entry (``entries/<entry>.py``) as new files; a mix names them and the
    harness runs the cell unchanged."""
    shutil.copytree(manifest.HERE, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "port_bench/traffic/paced.py").write_text(KIND)
    (tmp_path / "port_bench/entries/first.py").write_text(ENTRY)
    mix = json.loads((manifest.HERE / "traffic/seq.json").read_text())
    mix.update(kind="paced", entry="first", calls=5, period_s=0.0)
    (tmp_path / "port_bench/traffic/paced5.json").write_text(json.dumps(mix))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "census_kitti.paced5",
                               "config": "census_kitti", "traffic": "paced5",
                               "chips": 1, "why": "a test cell"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    out = run_cell("census_kitti.paced5", 4, 0.0, False, time.perf_counter(),
                   on_card=False, size=(24, 48, 16), root=tmp_path,
                   log=lambda _: None)
    assert out["correct"], out["check"]
    assert out["attempted"] == 5 and out["failed"] == 0
    assert out["metrics"]["fps"]["value"] > 0


def test_every_matching_setting_reaches_the_program():
    """Each key of a configuration that names a ``DisparityConfig`` field
    reaches the program; the benchmark's own keys do not."""
    from port_bench.system import disparity_config
    cfg = json.loads((manifest.HERE / "configs/census_kitti.json")
                     .read_text())
    cfg.update(wls=True, lmbda=1234.0, sigma=0.5, wls_iters=2,
               wls_lr_confidence=True, census_window=[7, 9],
               speckle_window_size=100)
    dc = disparity_config(cfg)
    assert (dc.wls, dc.lmbda, dc.sigma, dc.wls_iters) == (True, 1234.0,
                                                          0.5, 2)
    assert dc.wls_lr_confidence and dc.census_window == (7, 9)
    assert dc.speckle_window_size == 100 and dc.num_disparities == 128
    assert not hasattr(dc, "width")
