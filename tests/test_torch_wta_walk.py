"""K4's walk of the total (``ops/cuda_kernels.py::wta_walk_plain``, the
kernel's order of visits on the CPU) against the plain entries and the JAX
package, on volumes made to stress ties.

The kernel reads each cell of the total once: four d-phases a column for the
left statistics, combined as a (cost, d) lexicographic min, and the
right-view minima carried from tile to tile along the diagonals. The model
repeats that order; it must equal ``wta_stats_plain``, ``right_wta_plain``,
the JAX package's ``_wta_stats_rows``, ``right_disparity_from_volume``,
``wta_stats_pallas`` and ``right_wta_pallas`` (interpret mode) and, through
the elementwise tail, ``extract_disparity``, all bit for bit (the costs are
small integers, exact in float32 and int16).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_match_tpu.ops import wta as jwta
from stereo_match_tpu.ops.pallas_kernels import (_wta_stats_rows,
                                                 right_wta_pallas,
                                                 wta_stats_pallas)
from stereo_match_tpu_torch.ops import cuda_kernels as K
from stereo_match_tpu_torch.ops.wta import disparity_from_stats

# (D, H, W): tie-heavy rows at several depths; D <= 3 (second is 3e9); W < D
SHAPES = [(16, 12, 90), (7, 6, 37), (3, 6, 20), (2, 6, 11), (1, 6, 9),
          (40, 6, 25)]
TILES = [K.WTA_TILE, 16, 8]


def _total(D, H, W, dtype, seed=0):
    t = K.tie_heavy_total(D, H, W, seed)
    return t.astype(np.int16) if dtype == "int16" else t


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("dtype", ["float32", "int16"])
@pytest.mark.parametrize("D,H,W", SHAPES)
def test_walk_equals_plain_entries(D, H, W, dtype, tile):
    total = torch.from_numpy(_total(D, H, W, dtype))
    got = K.wta_walk_plain(total, tile)
    want = (*K.wta_stats_plain(total), K.right_wta_plain(total))
    for name, g, w in zip(("best", "idx", "c0", "c2", "second", "ridx"),
                          got, want):
        assert g.dtype == w.dtype, name
        assert torch.equal(g, w), name


@pytest.mark.parametrize("dtype", ["float32", "int16"])
@pytest.mark.parametrize("D,H,W", SHAPES)
def test_walk_equals_jax_stats_rows_and_right_view(D, H, W, dtype):
    agg = _total(D, H, W, dtype, seed=1)
    best, idx, c0, c2, second, ridx = K.wta_walk_plain(torch.from_numpy(agg))
    slab = jnp.asarray(agg.astype(np.float32).reshape(D, H * W))
    d_iota = jnp.broadcast_to(jnp.arange(D)[:, None], (D, H * W))
    for name, g, w in zip(("best", "idx", "c0", "c2", "second"),
                          (best, idx, c0, c2, second),
                          _wta_stats_rows(slab, d_iota)):
        np.testing.assert_array_equal(_np(g), np.asarray(w).reshape(H, W),
                                      err_msg=name)
    want = jwta.right_disparity_from_volume(jnp.asarray(agg), 0)
    np.testing.assert_array_equal(_np(ridx).astype(np.float32),
                                  np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "int16"])
def test_walk_equals_pallas_entries(dtype):
    agg = _total(16, 12, 37, dtype, seed=2)
    got = K.wta_walk_plain(torch.from_numpy(agg), 8)
    for g, w in zip(got[:5], wta_stats_pallas(jnp.asarray(agg),
                                              interpret=True)):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    np.testing.assert_array_equal(
        _np(got[5]), np.asarray(right_wta_pallas(jnp.asarray(agg),
                                                 interpret=True)))


@pytest.mark.parametrize("kw", [dict(), dict(min_disparity=3),
                                dict(subpixel=False),
                                dict(uniqueness_ratio=5, disp12_max_diff=2)])
@pytest.mark.parametrize("dtype", ["float32", "int16"])
@pytest.mark.parametrize("D,H,W", [(16, 12, 90), (3, 6, 20), (40, 6, 25)])
def test_walk_gives_extract_disparity(D, H, W, dtype, kw):
    """The walk's statistics through the elementwise tail and the disp12
    check give JAX's extract_disparity and wta_lr_plain's maps."""
    agg = _total(D, H, W, dtype, seed=3)
    min_d = kw.get("min_disparity", 0)
    ratio, tol = kw.get("uniqueness_ratio", 15), kw.get("disp12_max_diff", 1)
    subpixel = kw.get("subpixel", True)
    *stats, ridx = K.wta_walk_plain(torch.from_numpy(agg), 16)
    disp, mask = disparity_from_stats(tuple(stats), D, min_d, ratio,
                                      subpixel)
    right = (ridx + min_d).to(torch.float32)
    disp = torch.where(mask & K.lr_mask_plain(disp, right, tol), disp,
                       torch.nan)
    want = jwta.extract_disparity(jnp.asarray(agg), **kw)
    np.testing.assert_array_equal(_np(disp), np.asarray(want))
    plain, plain_right = K.wta_lr_plain(torch.from_numpy(agg), min_d, ratio,
                                        tol, subpixel)
    assert torch.equal(right, plain_right)
    np.testing.assert_array_equal(_np(disp), _np(plain))


def test_tie_heavy_total_has_its_ties():
    """Every row kind is there: constant planes, the minimum at d = 0 and
    at D - 1, equal minima over idx -+ 1, equal right-view diagonals."""
    D, H, W = 16, 12, 90
    t = torch.from_numpy(K.tie_heavy_total(D, H, W))
    best, idx, c0, c2, *_ = K.wta_stats_plain(t)
    assert bool((t[:, 1] == t[0, 1]).all())                  # constant
    assert bool((idx[2] == 0).all()) and bool((idx[3] == D - 1).any())
    assert bool(((c0[4] == best[4]) | (c2[4] == best[4])).all())
    xr = torch.arange(W)[None] - torch.arange(D)[:, None]
    diag = t[:, 5]
    assert bool((diag == 1.0 + (xr % 3 == 0)).all())
