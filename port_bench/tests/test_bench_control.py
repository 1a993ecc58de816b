"""The check's control fails its limit; sound runs pass it.

The control is the reference put in the program's place, computed in the
nearest precision below the configuration's (``checks/<config>.json``'s
``control``): bfloat16 volumes and SGM for the census configuration (its
float32 arithmetic is on whole numbers), TF32 products for MC-CNN's
float32 tower. The program's own lower-precision path (census int16
volumes, the bfloat16 tower) must fail too. Here on the CPU at a small
size; on the card at the cell's own size (``cuda``).
"""

import pytest
import torch

from port_bench import manifest
from port_bench.calibrate import readings

CELLS = ("census_kitti.seq", "mccnn_acc_kitti.seq")


def worst(cell_name, size, seeds, device):
    cell = manifest.load_cell(cell_name)
    cfg = dict(cell.config)
    if size:
        cfg.update(height=size[0], width=size[1], num_disparities=size[2])
    tol = cell.checks["tol_px"]
    lines = list(readings(cell, cfg, [device], seeds, (tol,)))
    return ({k: max(line[k][str(tol)] for line in lines)
             for k in ("program", "control", "program_lower")},
            {k: min(line[k][str(tol)] for line in lines)
             for k in ("control", "program_lower")},
            cell.checks["limits"]["mismatch_pct"])


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_cpu(cell):
    most, least, limit = worst(cell, (40, 128, 32), (1, 2), "cpu")
    assert most["program"] <= limit, most
    assert least["control"] > limit, least
    assert least["program_lower"] > limit, least


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the cell's own size runs there")
    most, least, limit = worst(cell, None, (31, 32, 33), "cuda:0")
    assert most["program"] <= limit, most
    assert least["control"] > 3 * max(limit, most["program"]), least
    assert least["program_lower"] > limit, least
