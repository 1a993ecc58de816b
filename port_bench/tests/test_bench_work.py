"""Each layer's work count against a figure worked out by hand."""

import json

import pytest

from port_bench import manifest
from port_bench.roofline import least_seconds, load_peaks

CONFIGS = manifest.HERE / "configs"


def config(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def test_census_cost_at_kitti():
    work = manifest.layer_work(config("census_kitti"))
    # the (128, 375, 1242) float32 volume out, two float32 images in
    assert 4 * 128 * 375 * 1242 == 238_464_000
    assert work["cost"]["bytes"] == 238_464_000 + 2 * 4 * 375 * 1242
    assert work["cost"]["tf32_flop"] == 0
    # bytes-bound: 242.19 MB at 3.35 TB/s
    assert least_seconds(work["cost"], load_peaks()) == pytest.approx(
        242_190_000 / 3.35e12)


def test_sgm_at_kitti():
    work = manifest.layer_work(config("census_kitti"))
    # the volume read once and the total written once
    assert work["sgm"]["bytes"] == 2 * 238_464_000
    assert least_seconds(work["sgm"], load_peaks()) == pytest.approx(
        476_928_000 / 3.35e12)


def test_mccnn_accurate_at_kitti():
    work = manifest.layer_work(config("mccnn_acc_kitti"))["cost"]
    pixels = 375 * 1242
    # per pixel and view: 2*9*1*112 for the first layer, 2*9*112*112 for
    # each of the other four
    tower = 2 * pixels * (2 * 9 * 112 + 4 * 2 * 9 * 112 * 112)
    assert tower == 843_178_896_000      # 8.43e11
    # the band: 2 * 112 a cell with x >= d, 375 * sum(1242 - d) cells
    cells = 375 * (128 * 1242 - 127 * 128 // 2)
    assert cells == 56_568_000
    assert work["tf32_flop"] == tower + 224 * cells
    assert work["tf32_flop"] == pytest.approx(8.56e11, rel=1e-3)
    # operations-bound: 1.73 ms on the TF32 peak
    assert least_seconds(work, load_peaks()) == pytest.approx(
        work["tf32_flop"] / 4.95e14)
    assert least_seconds(work, load_peaks()) == pytest.approx(1.729e-3,
                                                              rel=1e-3)


def test_least_time_takes_the_larger_bound():
    peaks = {"hbm_bytes_per_s": 1.0, "tf32_flop_per_s": 10.0,
             "fp32_flop_per_s": 2.0}
    assert least_seconds({"bytes": 3.0}, peaks) == 3.0
    assert least_seconds({"bytes": 1.0, "tf32_flop": 20.0, "flop": 4.0},
                         peaks) == 4.0


def test_wta_has_no_work_count():
    assert "wta" not in manifest.layer_work(config("census_kitti"))
