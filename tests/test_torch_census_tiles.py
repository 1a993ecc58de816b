"""K1's tiling (``ops/cuda_kernels.py::census_words_tiled_plain``, the
kernel's arithmetic on the CPU) against the plain census and the JAX
package.

The kernel stages each 16 x 128 tile of a view with its halo by clamped
coordinates (the edge replication), compares a window row in passes of 16
columns (the last masked to the window), puts a pass's bits into a 64-bit accumulator a pixel and
writes a word whenever 32 have filled. The model repeats that order, tile
by tile; it must equal ``census_words_plain`` and ``census_transform`` of
the JAX package bit for bit (integer compares; NaN compares false). The
shapes make tiles straddle every edge: one pixel, one or two columns, one
row, widths one off a tile and odd widths (every 16-byte alignment of a
row, so every store kind of ``_store_kinds``), windows of one row or
one column, of 33 pixels (bit 31 set), of 3, 7 and 8 words, and wider than
one 16-column pass.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_match_tpu.ops.census import census_transform
from stereo_match_tpu_torch.ops import cuda_kernels as K

CASES = [(1, 1, (1, 3)), (1, 2, (3, 1)), (1, 1241, (5, 5)),
         (9, 1243, (7, 9)), (17, 130, (3, 11)), (12, 140, (15, 15)),
         (10, 150, (3, 17)), (5, 70, (1, 33)), (16, 129, (9, 9)),
         (20, 257, (5, 5)), (7, 3, (5, 5)), (11, 45, (15, 17))]


def _store_kinds(V, nw, H, W):
    """How K1 stores a lane's 4 words (``census.cu::store_words``), counted
    over the output: a 16-byte store where the lane's address in its word
    plane row is 16-byte aligned, two 8-byte stores where it is 8-byte
    aligned, four 4-byte ones otherwise, and scalars for a row's last
    pixels (fewer than 4)."""
    x = np.arange(0, W, K.CENSUS_PIXELS)
    full = x + K.CENSUS_PIXELS <= W
    rows = np.arange(V * nw * H)[:, None] * W + x[None, :]
    return {"v4": int((full & (rows % 4 == 0)).sum()),
            "v2": int((full & (rows % 4 == 2)).sum()),
            "scalar": int((full & (rows % 2 == 1)).sum()),
            "tail": int((~full).sum()) * V * nw * H}


def _views(H, W, seed):
    """Two views of small integer levels (many equal neighbours), with NaN
    pixels."""
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 8, (2, H, W)).astype(np.float32)
    imgs[rng.random((2, H, W)) < 0.02] = np.nan
    return imgs


@pytest.mark.parametrize("H,W,window", CASES)
def test_tiled_model_equals_plain_and_jax(H, W, window):
    imgs = _views(H, W, seed=H * W)
    got = K.census_words_tiled_plain(torch.from_numpy(imgs), window)
    assert got.shape == (2, K.n_census_words(window), H, W)
    assert torch.equal(got, K.census_words_plain(torch.from_numpy(imgs),
                                                 window))
    for v in range(2):
        want = np.moveaxis(np.asarray(census_transform(jnp.asarray(imgs[v]),
                                                       window)), -1, 0)
        np.testing.assert_array_equal(got[v].numpy(), want)


@pytest.mark.parametrize("tile", [(3, 8), (1, 4), (5, 12)])
def test_tiled_model_at_other_tiles(tile):
    """Small tiles put many tile seams inside the window's reach."""
    imgs = torch.from_numpy(_views(13, 37, seed=3))
    for window in ((5, 5), (7, 9), (3, 17)):
        assert torch.equal(K.census_words_tiled_plain(imgs, window, tile),
                           K.census_words_plain(imgs, window))


def test_store_kinds_cover_every_alignment():
    """W = 1242 (KITTI): every other row of a word plane is 8 bytes off a
    16-byte boundary, so a lane takes two 8-byte stores there; an odd width
    leaves rows 4 or 12 bytes off (four 4-byte stores) and a last pixel of
    each row to a scalar store."""
    kitti = _store_kinds(2, 1, 375, 1242)
    assert kitti["v4"] == kitti["v2"] > 0 and kitti["scalar"] == 0
    assert kitti["tail"] == 2 * 375                  # 1242 = 4 * 310 + 2
    assert sum(kitti.values()) == 2 * 375 * 311
    odd = _store_kinds(2, 2, 9, 1243)
    assert all(n > 0 for n in odd.values())
    assert _store_kinds(2, 1, 8, 1280)["v4"] == 2 * 8 * 320


def test_tile_bytes_and_pass_width():
    """The shared memory a window's tile takes on the card, as census.cu
    sizes it: rows of the tile and halo, each padded to whole 16-byte
    reads of the last pass (16 columns, whatever the window's width)."""
    assert K.CENSUS_PASS == 16
    assert K.census_tile_bytes((5, 5)) == 20 * 144 * 4
    assert K.census_tile_bytes((7, 9)) == 22 * 144 * 4
    assert K.census_tile_bytes((3, 17)) == 18 * 160 * 4
    assert K.census_tile_bytes((175, 175)) <= K.SMEM_MAX
    assert K.census_tile_bytes((177, 177)) > K.SMEM_MAX
