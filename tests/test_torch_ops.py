"""The PyTorch port's ops and plain kernel versions against the JAX package.

The same numpy inputs, made from a seed, go through the JAX function (XLA,
or a Pallas kernel in interpret mode) and its port counterpart on the CPU.
Census words, Hamming costs, SGM totals, WTA indices and masks are compared
bit for bit; where a tolerance is used, its reason is stated beside it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_match_tpu.eval import metrics as jmetrics
from stereo_match_tpu.ops import census as jcensus
from stereo_match_tpu.ops import cost_volume as jcv
from stereo_match_tpu.ops import sgm as jsgm
from stereo_match_tpu.ops import wta as jwta
from stereo_match_tpu.ops.pallas_kernels import (census_volume_pallas,
                                                 census_words_pallas,
                                                 lr_mask_pallas,
                                                 sgm_aggregate_wta_pallas)
from stereo_match_tpu_torch.eval import metrics as tmetrics
from stereo_match_tpu_torch.ops import census as tcensus
from stereo_match_tpu_torch.ops import cost_volume as tcv
from stereo_match_tpu_torch.ops import cuda_kernels as K
from stereo_match_tpu_torch.ops import sgm as tsgm
from stereo_match_tpu_torch.ops import wta as twta


def _images(H, W, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 255, (H, W)).astype(np.float32),
            rng.uniform(0, 255, (H, W)).astype(np.float32))


def _t(a):
    """A writable tensor copy of a numpy or JAX array."""
    return torch.tensor(np.asarray(a))


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _census_volume(H, W, D, min_d, window=(5, 5), seed=0):
    left, right = _images(H, W, seed)
    return tcv.census_cost_volume(torch.from_numpy(left),
                                  torch.from_numpy(right), D, min_d, window)


# ------------------------------------------------------------- census ----

def test_popcount32_counts_every_bit():
    rng = np.random.default_rng(0)
    x = rng.integers(-2 ** 31, 2 ** 31, 4096, dtype=np.int64).astype(np.int32)
    x[:3] = [-1, -2 ** 31, 0]
    want = [bin(int(v) & 0xFFFFFFFF).count("1") for v in x]
    np.testing.assert_array_equal(_np(tcensus.popcount32(torch.from_numpy(x))),
                                  want)


# (3, 11) packs 32 bits, so bit 31 is set; (7, 7) and (9, 9) need 2 and 3
# words
@pytest.mark.parametrize("window", [(5, 5), (3, 3), (5, 3), (3, 11), (7, 7),
                                    (9, 9)])
def test_census_transform_matches_jax(window):
    left, _ = _images(37, 150)
    want = np.asarray(jcensus.census_transform(jnp.asarray(left), window))
    got = _np(tcensus.census_transform(torch.from_numpy(left), window))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    if window == (3, 11):
        assert (got < 0).any()          # bit 31 is exercised


def test_hamming_distance_matches_jax():
    left, right = _images(24, 60)
    a = jcensus.census_transform(jnp.asarray(left), (7, 7))
    b = jcensus.census_transform(jnp.asarray(right), (7, 7))
    want = np.asarray(jcensus.hamming_distance(a, b))
    got = tcensus.hamming_distance(_t(a), _t(b))
    np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("H,W,window", [(37, 150, (5, 5)), (24, 140, (3, 3)),
                                        (16, 130, (5, 3))])
def test_census_words_plain_matches_pallas(H, W, window):
    """Plain K1 against census_words_pallas (interpret mode), both views."""
    left, right = _images(H, W)
    want = np.asarray(census_words_pallas(jnp.stack([left, right]), window,
                                          interpret=True))
    got = K.census_words(torch.from_numpy(np.stack([left, right])), window)
    assert got.shape == (2, 1, H, W)                 # one word
    np.testing.assert_array_equal(_np(got[:, 0]), want)


def test_census_words_plain_32_bit_window():
    """A 33-pixel window fills the word; the Pallas kernel stops at 31 bits,
    so the XLA census is the reference here."""
    left, right = _images(20, 70, seed=3)
    got = _np(K.census_words(torch.from_numpy(np.stack([left, right])),
                             (3, 11)))
    for v, img in ((0, left), (1, right)):
        want = np.asarray(jcensus.census_transform(jnp.asarray(img),
                                                   (3, 11)))[..., 0]
        np.testing.assert_array_equal(got[v, 0], want)
    assert (got < 0).any()


# ---------------------------------------------------------- cost volume ----

@pytest.mark.parametrize("H,W,D,min_d", [(36, 150, 64, 0), (24, 160, 128, 4),
                                         (20, 320, 160, 0)])
def test_census_volume_plain_matches_pallas(H, W, D, min_d):
    """Plain K2 against census_volume_pallas (interpret mode), bit-equal."""
    left, right = _images(H, W)
    cl = jcensus.census_transform(jnp.asarray(left), (5, 5))[..., 0]
    cr = jcensus.census_transform(jnp.asarray(right), (5, 5))[..., 0]
    want = np.asarray(census_volume_pallas(cl[None], cr[None], D, min_d,
                                           dtype=jnp.float32, interpret=True))
    got = K.census_volume(_t(cl), _t(cr), D, min_d)
    np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("min_d,window", [(0, (5, 5)), (4, (5, 5)),
                                          (3, (3, 3)), (0, (7, 7))])
def test_build_cost_volume_matches_jax(min_d, window):
    left, right = _images(20, 90, seed=2)
    want = np.asarray(jcv.build_cost_volume(
        jnp.asarray(left), jnp.asarray(right), num_disparities=32,
        min_disparity=min_d, cost="census", window=window))
    got = tcv.build_cost_volume(torch.from_numpy(left),
                                torch.from_numpy(right), 32, min_d,
                                window=window)
    np.testing.assert_array_equal(_np(got), want)


def test_build_cost_volume_other_costs_not_ported():
    """Every family of the JAX package is ported (sad, ssd and bt are held
    to it in tests/test_torch_matchers.py); an unknown family and a
    negative min_disparity raise ValueError, as in the JAX package."""
    img = torch.zeros(8, 16)
    for cost in ("sad", "ssd", "bt"):
        vol = tcv.build_cost_volume(img, img, 16, cost=cost)
        assert vol.shape == (16, 8, 16) and vol.dtype == torch.float32
    with pytest.raises(ValueError, match="unknown cost family"):
        tcv.build_cost_volume(img, img, 16, cost="mccnn")
    with pytest.raises(ValueError, match="does not support"):
        tcv.build_cost_volume(img, img, 16, min_disparity=-1)


# ------------------------------------------------------------------ SGM ----

def test_scan_direction_matches_jax():
    rng = np.random.default_rng(0)
    cost = rng.uniform(0, 24, (16, 24, 40)).astype(np.float32)
    init = rng.uniform(0, 30, (16, 40)).astype(np.float32)
    for carry in (None, init):
        want = np.asarray(jsgm.scan_direction(
            jnp.asarray(cost), 8.0, 96.0,
            init_carry=None if carry is None else jnp.asarray(carry)))
        got = tsgm.scan_direction(
            torch.from_numpy(cost), 8.0, 96.0,
            init_carry=None if carry is None else torch.from_numpy(carry))
        np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("direction", tsgm.PATH_DIRECTIONS_8)
def test_aggregate_direction_matches_jax(direction):
    """Each direction bit-equal to the reference's shear/flip formulation,
    on a non-integer float volume (so every rounding must agree)."""
    rng = np.random.default_rng(1)
    cost = rng.uniform(0, 24, (8, 37, 23)).astype(np.float32)
    want = np.asarray(jsgm.aggregate_direction(jnp.asarray(cost), *direction,
                                               5.0, 40.0))
    got = tsgm.aggregate_direction(torch.from_numpy(cost), *direction,
                                   5.0, 40.0)
    np.testing.assert_array_equal(_np(got), want)


# (5, 5): P1 = 8, P2 = 96; (3, 3): P1 = 8/3 is not an integer. The port adds
# the directions in the reference's order with the reference's operations,
# so the totals are bit-equal in both cases.
@pytest.mark.parametrize("window", [(5, 5), (3, 3)])
@pytest.mark.parametrize("num_paths", [2, 4, 8])
def test_sgm_aggregate_and_plain_k3_match_jax(window, num_paths):
    bits = window[0] * window[1] - 1
    p1, p2 = bits / 3.0, bits * 4.0
    vol = _census_volume(20, 70, 32, 0, window)
    want = np.asarray(jsgm.sgm_aggregate(jnp.asarray(_np(vol)), p1, p2,
                                         num_paths))
    np.testing.assert_array_equal(_np(tsgm.sgm_aggregate(vol, p1, p2,
                                                         num_paths)), want)
    np.testing.assert_array_equal(
        _np(K.aggregate_paths(vol, p1, p2, num_paths)), want)


def _pallas_main_path(vol, words_l, words_r, D, min_d, p1, p2):
    """The TPU main path's aggregation (census-fused horizontal pair, scan3,
    scan3 + stats) in interpret mode; ``words_*``: (nw, H, W) K1 words."""
    clT = jnp.swapaxes(jnp.asarray(words_l), 1, 2)
    crT = jnp.swapaxes(jnp.asarray(words_r), 1, 2)
    return sgm_aggregate_wta_pallas(jnp.asarray(_np(vol)), p1, p2, 8,
                                    census_T=(clT, crT), min_disparity=min_d,
                                    interpret=True)


@pytest.mark.parametrize("H,W,D,min_d", [(36, 150, 64, 0), (24, 160, 64, 4)])
def test_plain_k3_matches_pallas_main_path(H, W, D, min_d):
    """Eight plain K3 directions over the K2 volume equal the TPU main
    path's totals bit for bit at 5x5 (integer costs and penalties)."""
    left, right = _images(H, W, seed=5)
    words = K.census_words(torch.from_numpy(np.stack([left, right])))
    vol = K.census_volume(words[0], words[1], D, min_d)
    want, _ = _pallas_main_path(vol, _np(words[0]), _np(words[1]), D, min_d,
                                8.0, 96.0)
    np.testing.assert_array_equal(_np(K.aggregate_paths(vol, 8.0, 96.0)),
                                  np.asarray(want))


def test_plain_k3_non_integer_p1_against_pallas_main_path():
    """3x3 census: P1 = 8/3. The TPU path adds (S + SE + SW) before adding
    into the total, the port adds one direction at a time, so the float32
    sums round differently: each total is a sum of 8 path costs, and
    reordering 7 additions moves it by at most 7 half-ulps of the total."""
    left, right = _images(24, 150, seed=6)
    words = K.census_words(torch.from_numpy(np.stack([left, right])), (3, 3))
    vol = K.census_volume(words[0], words[1], 64, 0)
    want, _ = _pallas_main_path(vol, _np(words[0]), _np(words[1]), 64, 0,
                                8 / 3, 32.0)
    want = np.asarray(want)
    got = _np(K.aggregate_paths(vol, 8 / 3, 32.0))
    tol = 7 * 0.5 * np.spacing(np.float32(want.max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_sgm_path_scan_plain_validates():
    vol = torch.zeros(4, 6, 8)
    with pytest.raises(ValueError):
        K.sgm_path_scan(vol, torch.zeros(4, 6, 7), 0, 1, 8.0, 96.0, False)
    with pytest.raises(ValueError):
        K.sgm_path_scan(vol, torch.zeros_like(vol), 0, 0, 8.0, 96.0, False)
    with pytest.raises(ValueError):
        K.sgm_path_scan(vol.transpose(1, 2), torch.zeros(4, 8, 6), 0, 1,
                        8.0, 96.0, False)


# ------------------------------------------------------------------ WTA ----

def _integer_volume(D, H, W, seed=0):
    """Small integer costs: many ties, so many exact-.5 subpixel offsets."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 12, (D, H, W)).astype(np.float32)


WTA_CASES = [dict(), dict(min_disparity=4), dict(subpixel=False),
             dict(uniqueness_ratio=0), dict(disp12_max_diff=-1),
             dict(disp12_max_diff=2, uniqueness_ratio=5, min_disparity=3)]


@pytest.mark.parametrize("kw", WTA_CASES)
def test_extract_disparity_and_plain_k4_match_jax(kw):
    agg = _integer_volume(16, 20, 90)
    want = np.asarray(jwta.extract_disparity(jnp.asarray(agg), **kw))
    got = _np(twta.extract_disparity(torch.from_numpy(agg), **kw))
    np.testing.assert_array_equal(got, want)          # NaN positions too
    args = (kw.get("min_disparity", 0), kw.get("uniqueness_ratio", 15),
            kw.get("disp12_max_diff", 1), kw.get("subpixel", True))
    disp, disp_right = K.wta_lr(torch.from_numpy(agg), *args)
    np.testing.assert_array_equal(_np(disp), want)
    want_right = np.asarray(jwta.right_disparity_from_volume(
        jnp.asarray(agg), args[0]))
    np.testing.assert_array_equal(_np(disp_right), want_right)
    if kw.get("subpixel", True):
        assert (np.abs(want % 1) == 0.5).any()       # exact .5 exercised


def test_plain_k4_matches_pallas_main_path():
    """Plain K4 on the final totals equals the TPU path's fused statistics
    + extract_disparity_fast (lr_mask_pallas), at a census volume."""
    H, W, D = 36, 150, 64
    left, right = _images(H, W, seed=7)
    words = K.census_words(torch.from_numpy(np.stack([left, right])))
    vol = K.census_volume(words[0], words[1], D, 0)
    total, stats = _pallas_main_path(vol, _np(words[0]), _np(words[1]), D, 0,
                                     8.0, 96.0)
    want, want_right = jwta.extract_disparity_fast(
        total, stats=stats, return_right=True, interpret=True)
    disp, disp_right = K.wta_lr(_t(total))
    np.testing.assert_array_equal(_np(disp), np.asarray(want))
    np.testing.assert_array_equal(_np(disp_right), np.asarray(want_right))


def test_extract_disparity_return_right():
    agg = _integer_volume(16, 12, 40, seed=1)
    want = jwta.extract_disparity(jnp.asarray(agg), return_right=True)
    got = twta.extract_disparity(torch.from_numpy(agg), return_right=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


@pytest.mark.parametrize("H,W,D,mind,tol", [(40, 300, 64, 0, 1),
                                            (33, 150, 32, 4, 2)])
def test_lr_consistency_mask_matches_jax(H, W, D, mind, tol):
    """NaN invalids and exact-.5 offsets (half-to-even rounding), against
    the XLA mask and lr_mask_pallas (interpret mode)."""
    rng = np.random.default_rng(0)
    dl = rng.uniform(mind, mind + D - 1, (H, W)).astype(np.float32)
    dl[::5, ::7] = np.round(dl[::5, ::7]) + 0.5
    dl[::9, ::11] = np.nan
    dr = rng.uniform(mind, mind + D - 1, (H, W)).astype(np.float32)
    dr[:, : W // 2] = np.round(dl[:, : W // 2])
    want = np.asarray(jwta.lr_consistency_mask(jnp.asarray(dl),
                                               jnp.asarray(dr), tol, mind))
    pallas = np.asarray(lr_mask_pallas(jnp.asarray(dl), jnp.asarray(dr), D,
                                       tol, mind, interpret=True))
    got = _np(twta.lr_consistency_mask(torch.from_numpy(dl),
                                       torch.from_numpy(dr), tol, mind))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pallas)
    assert not got[::9, ::11].any()                    # NaN -> False


def test_wta_pieces_match_jax():
    agg = _integer_volume(16, 10, 30, seed=2)
    ja, ta = jnp.asarray(agg), torch.from_numpy(agg)
    idx = jwta.wta_disparity(ja)
    np.testing.assert_array_equal(_np(twta.wta_disparity(ta)), np.asarray(idx))
    tidx = _t(idx)
    np.testing.assert_array_equal(_np(twta.subpixel_refine(ta, tidx)),
                                  np.asarray(jwta.subpixel_refine(ja, idx)))
    for ratio in (0, 15):
        np.testing.assert_array_equal(
            _np(twta.uniqueness_mask(ta, tidx, ratio)),
            np.asarray(jwta.uniqueness_mask(ja, idx, ratio)))


def test_fixed_point_round_trip_matches_jax():
    rng = np.random.default_rng(0)
    d = rng.uniform(0, 64, (12, 30)).astype(np.float32)
    d[0, :8] = np.arange(8) / 16 + 0.5 / 16            # exact half steps
    d[1, ::3] = np.nan
    for mind in (0, 3):
        want = np.asarray(jwta.to_fixed_point(jnp.asarray(d), mind))
        got = twta.to_fixed_point(torch.from_numpy(d), mind)
        assert got.dtype == torch.int16
        np.testing.assert_array_equal(_np(got), want)
        np.testing.assert_array_equal(
            _np(twta.from_fixed_point(got, mind)),
            np.asarray(jwta.from_fixed_point(jnp.asarray(want), mind)))


# ------------------------------------------------- wrappers and metrics ----

def test_wrappers_take_plain_versions_on_cpu_without_counting():
    left, right = _images(16, 40)
    imgs = torch.from_numpy(np.stack([left, right]))
    before = dict(K.launches)
    words = K.census_words(imgs)
    np.testing.assert_array_equal(_np(words),
                                  _np(K.census_words_plain(imgs)))
    vol = K.census_volume(words[0], words[1], 16)
    total = K.aggregate_paths(vol, 8.0, 96.0)
    K.wta_lr(total)
    assert K.launches == before        # counts are for kernel launches only


def test_wrappers_validate_inputs():
    imgs = torch.zeros(2, 8, 16)
    with pytest.raises(ValueError):
        K.census_words(imgs.double())
    with pytest.raises(ValueError):
        K.census_words(imgs, (4, 5))                  # even window
    with pytest.raises(ValueError):
        K.census_words(imgs.transpose(1, 2))          # not contiguous
    words = torch.zeros(8, 16, dtype=torch.int32)
    with pytest.raises(ValueError):
        K.census_volume(words, words, 16, -1)
    with pytest.raises(ValueError):
        K.wta_lr(torch.zeros(4, 8, 16, dtype=torch.float64))


def test_wrappers_reject_other_devices():
    """Only CPU (plain version) and CUDA (kernel) tensors are taken."""
    imgs = torch.zeros(2, 8, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        K.census_words(imgs)
    with pytest.raises(ValueError, match="different devices"):
        K.census_volume(torch.zeros(8, 16, dtype=torch.int32),
                        torch.zeros(8, 16, dtype=torch.int32, device="meta"),
                        16)


def test_find_nvcc_raises_without_a_compiler(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(K.os.path, "isfile",
                        lambda p: p != "/usr/local/cuda/bin/nvcc"
                        and K.os.path.exists(p))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        K.find_nvcc()


def test_metrics_match_jax():
    rng = np.random.default_rng(0)
    gt = rng.uniform(0, 40, (20, 30)).astype(np.float32)
    pred = gt + rng.normal(0, 3, gt.shape).astype(np.float32)
    pred[::4, ::5] = np.nan
    gt[1, :] = np.nan
    want = jmetrics.compare_disparities(pred, gt)
    got = tmetrics.compare_disparities(torch.from_numpy(pred), gt)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6), k
