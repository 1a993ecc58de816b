"""A run with the timed path broken underneath comes out not correct.

Each case drives the rest of a run (``run_cell`` on the CPU, the program
on its plain paths at a small size) with one fault planted in the program
for the cells that can have it: an answer altered where it is produced,
an SGM direction left out, half of a call's frames left out, the gather
across cards left out. The sound run of every cell is correct. The
four-card mix (``traffic/dp4.json``), which ``BENCHMARK.json`` holds no
cell of yet, runs as a cell added in a copy of the benchmark.
"""

import json
import shutil
import time

import pytest
import torch

import stereo_match_tpu_torch.parallel.mesh as mesh
import stereo_match_tpu_torch.pipeline.stereo as stereo
from port_bench import manifest
from port_bench.core import run_cell

CELLS = ("census_kitti.seq", "mccnn_acc_kitti.seq", "census_kitti.batch8",
         "census_kitti.dp4")
SIZE = (24, 48, 16)


DP4 = {"name": "census_kitti.dp4", "config": "census_kitti",
       "traffic": "dp4", "chips": 4, "why": "the four-card mix"}


@pytest.fixture(scope="module")
def dp4_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("bench")
    shutil.copytree(manifest.HERE, root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = manifest.load_benchmark()
    bench["workloads"].append(DP4)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture
def run(dp4_root):
    def go(cell):
        root = dp4_root if cell == DP4["name"] else manifest.ROOT
        return run_cell(cell, 11, 0.2, False, time.perf_counter(),
                        on_card=False, size=SIZE, root=root,
                        log=lambda _: None)
    return go


def altered_answer(monkeypatch):
    wta = stereo.wta_lr

    def shifted(*args, **kw):
        disp, right = wta(*args, **kw)
        return disp + 1.0, right
    monkeypatch.setattr(stereo, "wta_lr", shifted)


def direction_left_out(monkeypatch):
    agg = stereo.aggregate_paths
    monkeypatch.setattr(stereo, "aggregate_paths",
                        lambda cost, p1, p2, n: agg(cost, p1, p2, n - 1))


def half_batch_left_out(monkeypatch):
    batched = stereo.StereoMatcher.batched

    def half(self, lefts, rights):
        n = len(lefts) // 2
        raw, filt = batched(self, lefts[:n], rights[:n])
        return torch.cat([raw, raw]), torch.cat([filt, filt])
    monkeypatch.setattr(stereo.StereoMatcher, "batched", half)


def half_shards_left_out(monkeypatch):
    shards = mesh.Split.shards

    def half(self, t):
        parts = shards(self, t)
        keep = len(parts) // 2
        return parts[:keep] + parts[:keep]
    monkeypatch.setattr(mesh.Split, "shards", half)


def gather_left_out(monkeypatch):
    monkeypatch.setattr(mesh.Split, "gather",
                        lambda self, parts, device: parts[0].to(device))


FAULTS = [(altered_answer, c) for c in CELLS] + \
    [(direction_left_out, c) for c in CELLS] + \
    [(half_batch_left_out, "census_kitti.batch8"),
     (half_shards_left_out, "census_kitti.dp4"),
     (gather_left_out, "census_kitti.dp4")]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, run):
    out = run(cell)
    assert out["correct"], out["check"]
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("plant,cell", FAULTS,
                         ids=[f"{p.__name__}-{c}" for p, c in FAULTS])
def test_fault_is_caught(plant, cell, monkeypatch, run):
    plant(monkeypatch)
    out = run(cell)
    assert not out["correct"], out["check"]
