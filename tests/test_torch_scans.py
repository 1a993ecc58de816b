"""int16 volumes, scan carries, the census-fused scan and the WTA entries of
the port (plain versions, on the CPU) against the JAX package.

The Pallas kernels run in interpret mode; the XLA functions are the oracle
where the two differ. Everything here is integer arithmetic or the
reference's float operations in the reference's order, so the comparisons
are bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_match_tpu.config import DisparityConfig as JaxDisparityConfig
from stereo_match_tpu.data.synthetic import random_dot_pair, slanted_scene
from stereo_match_tpu.ops import cost_volume as jcv
from stereo_match_tpu.ops import sgm as jsgm
from stereo_match_tpu.ops import wta as jwta
from stereo_match_tpu.ops.census import census_transform
from stereo_match_tpu.ops.pallas_kernels import (census_volume_pallas,
                                                 census_volume_T_pallas,
                                                 lr_mask_pallas,
                                                 right_wta_pallas,
                                                 sgm_census_scan_pallas,
                                                 sgm_scan3_pallas,
                                                 sgm_scan_pallas,
                                                 wta_stats_pallas)
from stereo_match_tpu.pipeline.stereo import _match_core as jax_match_core
from stereo_match_tpu_torch.config import DisparityConfig
from stereo_match_tpu_torch.ops import cost_volume as tcv
from stereo_match_tpu_torch.ops import cuda_kernels as K
from stereo_match_tpu_torch.ops import sgm as tsgm
from stereo_match_tpu_torch.ops import wta as twta
from stereo_match_tpu_torch.pipeline.stereo import _match_core


def _images(H, W, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 255, (H, W)).astype(np.float32),
            rng.uniform(0, 255, (H, W)).astype(np.float32))


def _words(H, W, seed=0, window=(5, 5)):
    """(H, W) int32 census words of both views, as numpy."""
    return tuple(np.array(census_transform(jnp.asarray(img), window))[..., 0]
                 for img in _images(H, W, seed))


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


# ------------------------------------------------------------------ K2 ----

@pytest.mark.parametrize("dtype", ["float32", "int16"])
@pytest.mark.parametrize("H,W,D,min_d", [(20, 70, 32, 0), (17, 40, 16, 4)])
def test_census_volume_plain_matches_pallas(H, W, D, min_d, dtype):
    """K2's plain version, planes and transposed layout, float32 (1e4) and
    int16 (1024), against census_volume_pallas / census_volume_T_pallas."""
    cl, cr = _words(H, W, seed=1)
    jdt = jnp.dtype(dtype)
    want = np.asarray(census_volume_pallas(cl[None], cr[None], D, min_d,
                                           dtype=jdt, interpret=True))
    got = K.census_volume(torch.from_numpy(cl), torch.from_numpy(cr), D,
                          min_d, dtype)
    assert str(got.dtype) == f"torch.{dtype}"
    np.testing.assert_array_equal(_np(got), want)
    clT, crT = np.ascontiguousarray(cl.T), np.ascontiguousarray(cr.T)
    want = np.asarray(census_volume_T_pallas(clT[None], crT[None], D, min_d,
                                             dtype=jdt, interpret=True))
    got = K.census_volume(torch.from_numpy(clT), torch.from_numpy(crT), D,
                          min_d, dtype, transposed=True)
    np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("min_d,window", [(0, (5, 5)), (3, (3, 3))])
def test_build_cost_volume_int16_matches_jax(min_d, window):
    left, right = _images(20, 90, seed=2)
    want = np.asarray(jcv.build_cost_volume(
        jnp.asarray(left), jnp.asarray(right), num_disparities=32,
        min_disparity=min_d, cost="census", window=window, dtype="int16"))
    got = tcv.build_cost_volume(torch.from_numpy(left),
                                torch.from_numpy(right), 32, min_d,
                                window=window, dtype="int16")
    assert got.dtype == torch.int16 and want.dtype == np.int16
    np.testing.assert_array_equal(_np(got), want)
    with pytest.raises(ValueError):
        tcv.build_cost_volume(torch.from_numpy(left),
                              torch.from_numpy(right), 32, dtype="float16")


# ------------------------------------------------------------------ K3 ----

def test_int16_sgm_follows_xla_with_a_fractional_p1():
    """3x3 census: P1 = 8/3. The XLA int16 path truncates P1 to 2; the
    port follows it in every direction. The TPU kernel widens int16 to f32
    and keeps the fraction inside a block, so it differs from XLA (a
    difference of the reference, not of the port: ROADMAP.md section 3)."""
    rng = np.random.default_rng(3)
    vol = rng.integers(0, 9, (8, 24, 16)).astype(np.int16)
    for direction in tsgm.PATH_DIRECTIONS_8:
        want = np.asarray(jsgm.aggregate_direction(jnp.asarray(vol),
                                                   *direction, 8 / 3, 32.0))
        got = tsgm.aggregate_direction(torch.from_numpy(vol), *direction,
                                       8 / 3, 32.0)
        assert got.dtype == torch.int16
        np.testing.assert_array_equal(_np(got), want)
    total = K.aggregate_paths(torch.from_numpy(vol), 8 / 3, 32.0)
    np.testing.assert_array_equal(
        _np(total), np.asarray(jsgm.sgm_aggregate(jnp.asarray(vol), 8 / 3,
                                                  32.0)))
    pallas = np.asarray(sgm_scan_pallas(jnp.asarray(vol), None, 8 / 3, 32.0,
                                        interpret=True))
    xla = np.asarray(jsgm.scan_direction(jnp.asarray(vol), 8 / 3, 32.0))
    assert not np.array_equal(pallas, xla)


@pytest.mark.parametrize("dtype", [np.float32, np.int16])
@pytest.mark.parametrize("reverse", [False, True])
def test_scan_carry_matches_pallas(reverse, dtype):
    """One vertical direction with a carry in and out, against
    sgm_scan_pallas(init_carry, return_carry)."""
    rng = np.random.default_rng(4)
    vol = rng.integers(0, 25, (16, 16, 40)).astype(dtype)
    init = rng.integers(0, 40, (16, 40)).astype(dtype)
    want, want_carry = sgm_scan_pallas(jnp.asarray(vol), None, 8.0, 96.0,
                                       reverse=reverse,
                                       init_carry=jnp.asarray(init),
                                       return_carry=True, interpret=True)
    t = torch.from_numpy(vol)
    got, carry = K.sgm_path_scan(t, torch.empty_like(t), -1 if reverse else 1,
                                 0, 8.0, 96.0, False,
                                 init_carry=torch.from_numpy(init),
                                 return_carry=True)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    np.testing.assert_array_equal(_np(carry), np.asarray(want_carry))


@pytest.mark.parametrize("reverse", [False, True])
def test_scan3_carry_slab_matches_pallas(reverse):
    """The three downward (upward) directions with carries equal the fused
    scan3 with its (3, D, N) slab — vertical, then the diagonal whose
    predecessor is at x - 1, then x + 1, unshifted — in and out."""
    rng = np.random.default_rng(5)
    vol = rng.integers(0, 25, (16, 16, 40)).astype(np.float32)
    slab = rng.integers(0, 40, (3, 16, 40)).astype(np.float32)
    want, want_carry = sgm_scan3_pallas(jnp.asarray(vol), None, 8.0, 96.0,
                                        reverse=reverse,
                                        init_carry=jnp.asarray(slab),
                                        return_carry=True, interpret=True)
    dy = -1 if reverse else 1
    t = torch.from_numpy(vol)
    total = torch.empty_like(t)
    for i, dx in enumerate((0, 1, -1)):
        _, carry = K.sgm_path_scan(t, total, dy, dx, 8.0, 96.0, i > 0,
                                   init_carry=torch.from_numpy(slab[i]),
                                   return_carry=True)
        np.testing.assert_array_equal(_np(carry), np.asarray(want_carry[i]))
    np.testing.assert_array_equal(_np(total), np.asarray(want))


def test_scan_wrappers_validate():
    vol = torch.zeros(4, 6, 8)
    i16 = vol.to(torch.int16)
    with pytest.raises(ValueError):       # int16 cost, float32 total
        K.sgm_path_scan(i16, torch.zeros_like(vol), 1, 0, 8.0, 96.0, False)
    with pytest.raises(ValueError, match="no carry"):
        K.sgm_path_scan(vol, torch.zeros_like(vol), 0, 1, 8.0, 96.0, False,
                        return_carry=True)
    with pytest.raises(ValueError):       # carry of the wrong width
        K.sgm_path_scan(vol, torch.zeros_like(vol), 1, 0, 8.0, 96.0, False,
                        init_carry=torch.zeros(4, 7))
    words = torch.zeros(6, 8, dtype=torch.int32)
    with pytest.raises(ValueError):
        K.census_scan(words, words, torch.zeros(4, 6, 9), 0, 8.0, 96.0)
    with pytest.raises(ValueError):
        K.census_scan(words, words, vol, -1, 8.0, 96.0)
    with pytest.raises(ValueError):
        K.census_volume(words, words, 4, dtype=torch.float16)
    with pytest.raises(ValueError):
        K.wta_stats(torch.zeros(4, 6, 8, dtype=torch.float64))


# ----------------------------------------------------------------- K10 ----

# Each value of every option appears: forward and reverse, with and without
# accumulation, invalid_cost 1e4 and 1024, min_disparity 0 and 3.
@pytest.mark.parametrize("reverse,accumulate,invalid,min_d", [
    (False, False, 1e4, 0), (True, True, 1024.0, 3),
    (True, False, 1e4, 3), (False, True, 1024.0, 0)])
def test_census_scan_plain_matches_pallas(reverse, accumulate, invalid,
                                          min_d):
    H, W, D = 16, 40, 16
    cl, cr = _words(H, W, seed=6)
    start = np.random.default_rng(7).uniform(0, 99, (D, H, W)).astype(
        np.float32)
    accum = jnp.asarray(np.ascontiguousarray(start.transpose(0, 2, 1))) \
        if accumulate else None
    want = sgm_census_scan_pallas(
        jnp.asarray(cl.T[None]), jnp.asarray(cr.T[None]), accum, D, min_d,
        8.0, 96.0, reverse=reverse, invalid_cost=invalid, interpret=True)
    got = K.census_scan(torch.from_numpy(cl), torch.from_numpy(cr),
                        torch.from_numpy(start.copy()), min_d, 8.0, 96.0,
                        reverse, invalid, accumulate)
    np.testing.assert_array_equal(_np(got),
                                  np.asarray(want).transpose(0, 2, 1))
    if invalid == 1e4:            # K2's volume scanned by K3 along (0, +-1)
        vol = K.census_volume(torch.from_numpy(cl), torch.from_numpy(cr), D,
                              min_d)
        ref = K.sgm_path_scan(vol, torch.from_numpy(start.copy()), 0,
                              -1 if reverse else 1, 8.0, 96.0, accumulate)
        assert torch.equal(got, ref)


# ------------------------------------------------------------------ K4 ----

@pytest.mark.parametrize("dtype", [np.float32, np.int16])
def test_wta_entries_plain_match_pallas(dtype):
    rng = np.random.default_rng(8)
    agg = rng.integers(0, 900, (16, 21, 37)).astype(dtype)
    agg[:, 3, :] = 5                       # ties
    want = wta_stats_pallas(jnp.asarray(agg), interpret=True)
    got = K.wta_stats(torch.from_numpy(agg))
    for g, w in zip(got, want):
        assert str(g.dtype).endswith(str(np.asarray(w).dtype))
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    want = right_wta_pallas(jnp.asarray(agg), interpret=True)
    np.testing.assert_array_equal(_np(K.right_wta(torch.from_numpy(agg))),
                                  np.asarray(want))


@pytest.mark.parametrize("tol,min_d", [(1, 0), (0, 3), (2, 5), (-1, 0)])
def test_lr_mask_plain_matches_pallas(tol, min_d):
    """K4's lr_mask entry (its plain version here) against lr_mask_pallas
    in interpret mode: half-to-even rounding, NaN and out-of-frame samples.
    """
    rng = np.random.default_rng(10)
    H, W, D = 9, 70, 16
    dl = (rng.integers(0, D * 2, (H, W)) / 2.0 + min_d).astype(np.float32)
    dl[rng.random((H, W)) < 0.1] = np.nan
    dl[:, :3] = np.float32(min_d + 2.5)            # x - dl out of frame
    dr = (rng.integers(0, D, (H, W)) + min_d).astype(np.float32)
    got = K.lr_mask(torch.from_numpy(dl), torch.from_numpy(dr), tol)
    assert got.dtype == torch.bool
    if tol < 0:
        assert bool(got.all())
        return
    want = lr_mask_pallas(jnp.asarray(dl), jnp.asarray(dr), D, tol, min_d,
                          interpret=True)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


WTA_CASES = [dict(), dict(min_disparity=4, subpixel=False),
             dict(uniqueness_ratio=0, disp12_max_diff=-1, return_right=True),
             dict(disp12_max_diff=2, uniqueness_ratio=5, min_disparity=3)]


@pytest.mark.parametrize("dtype", [np.float32, np.int16])
@pytest.mark.parametrize("kw", WTA_CASES)
def test_extract_disparity_fast_and_int16_match_jax(kw, dtype):
    """The port's fast path (K4 entries) and the XLA-form extract_disparity
    on float32 and int16 volumes, against JAX's extract_disparity."""
    agg = np.random.default_rng(9).integers(0, 12, (16, 20, 90)).astype(dtype)
    want = jwta.extract_disparity(jnp.asarray(agg), **kw)
    for fn in (twta.extract_disparity, K.extract_disparity_fast):
        got = fn(torch.from_numpy(agg), **kw)
        for g, w in zip(*((got, want) if kw.get("return_right")
                          else ((got,), (want,)))):
            np.testing.assert_array_equal(_np(g), np.asarray(w))
    stats = K.wta_stats(torch.from_numpy(agg))
    np.testing.assert_array_equal(
        _np(K.extract_disparity_fast(torch.from_numpy(agg), stats=stats,
                                     **kw)[0] if kw.get("return_right")
            else K.extract_disparity_fast(torch.from_numpy(agg), stats=stats,
                                          **kw)),
        np.asarray(want[0] if kw.get("return_right") else want))


# ------------------------------------------------------- int16 matcher ----

@pytest.mark.parametrize("window,min_d", [((5, 5), 0), ((3, 3), 3)])
def test_match_core_int16_matches_jax(window, min_d):
    H, W, D = 40, 120, 32
    gt = slanted_scene(H, W, 3.0 + min_d, 20.0)
    left, right = random_dot_pair(H, W, gt, blur=1.0, seed=1)
    kw = dict(num_disparities=D, census_window=window, min_disparity=min_d,
              uniqueness_ratio=15, disp12_max_diff=1, wls=False,
              speckle_window_size=0, dtype="int16")
    cfg = DisparityConfig(**kw)
    want = np.asarray(jax_match_core(jnp.asarray(left), jnp.asarray(right),
                                     JaxDisparityConfig(**kw))[0])
    got, _ = _match_core(torch.from_numpy(left), torch.from_numpy(right), cfg)
    np.testing.assert_array_equal(_np(got), want)
    if cfg.P1 == int(cfg.P1):
        # with integral penalties the float32 path differs only where the
        # x < d sentinel (1024 against 1e4) reaches the subpixel parabola:
        # next to the left edge
        f32, _ = _match_core(torch.from_numpy(left), torch.from_numpy(right),
                             cfg.replace(dtype="float32"))
        np.testing.assert_array_equal(_np(got)[:, D + min_d:],
                                      _np(f32)[:, D + min_d:])
