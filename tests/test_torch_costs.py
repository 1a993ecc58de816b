"""The port's multiword census, classic cost volumes, BM pieces and image
filters against the JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through the JAX function (XLA,
or a Pallas kernel in interpret mode) and the port's plain version.
Census words, Hamming volumes (2 and 3 words, float32 and int16, planes and
transposed), the prefilters, the half-sample envelope and the median are
compared bit for bit. The sad, ssd and bt volumes and BM's box sums
subtract float32 cumulative sums, which XLA and torch add in other orders:
both packages are held to a float64 box filter of the same float32 input,
and the port's largest error may be at most twice JAX's (both printed).
SGM and WTA on one JAX volume: totals within rtol 1e-5 (the JAX tests'
own bound), disparities with the same NaN mask and within 1e-4 on at
least 99.9 % of the pixels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stereo_match_tpu.costs as jcosts
from stereo_match_tpu.config import DisparityConfig as JaxDisparityConfig
from stereo_match_tpu.ops import census as jcensus
from stereo_match_tpu.ops import cost_volume as jcv
from stereo_match_tpu.ops import filters as jfilters
from stereo_match_tpu.ops.pallas_kernels import (census_volume_pallas,
                                                 census_volume_T_pallas)
from stereo_match_tpu.ops.sgm import sgm_aggregate
from stereo_match_tpu.ops.wta import extract_disparity
from stereo_match_tpu.pipeline import block_matching as jbm
from stereo_match_tpu_torch.ops import cost_volume as tcv
from stereo_match_tpu_torch.ops import cuda_kernels as K
from stereo_match_tpu_torch.ops import filters as tfilters
from stereo_match_tpu_torch.pipeline import block_matching as tbm


def _images(H, W, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 255, (H, W)).astype(np.float32),
            rng.uniform(0, 255, (H, W)).astype(np.float32))


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------ multiword census --

@pytest.mark.parametrize("window,nw", [((7, 9), 2), ((9, 11), 4),
                                       ((7, 7), 2), ((9, 9), 3)])
def test_census_words_multiword_match_jax(window, nw):
    """K1's plain version: (V, nw, H, W) words equal to the XLA
    census_transform word for word (its fallback for windows over 33
    pixels)."""
    left, right = _images(23, 61, seed=4)
    got = K.census_words(torch.from_numpy(np.stack([left, right])), window)
    assert got.shape == (2, nw, 23, 61) and K.n_census_words(window) == nw
    for v, img in enumerate((left, right)):
        want = np.moveaxis(np.asarray(jcensus.census_transform(
            jnp.asarray(img), window)), -1, 0)
        np.testing.assert_array_equal(_np(got[v]), want)


@pytest.mark.parametrize("dtype", ["float32", "int16"])
@pytest.mark.parametrize("window", [(7, 9), (9, 9)])
def test_census_volume_multiword_matches_pallas(window, dtype):
    """K2's plain version over 2 and 3 words, planes and transposed,
    float32 and int16, against census_volume_pallas and
    census_volume_T_pallas (interpret mode), bit-equal."""
    H, W, D, min_d = 17, 48, 16, 3
    words = K.census_words(torch.from_numpy(np.stack(_images(H, W, 5))),
                           window)
    cl, cr = _np(words[0]), _np(words[1])
    jdt = jnp.dtype(dtype)
    want = np.asarray(census_volume_pallas(jnp.asarray(cl), jnp.asarray(cr),
                                           D, min_d, dtype=jdt,
                                           interpret=True))
    got = K.census_volume(words[0], words[1], D, min_d, dtype)
    np.testing.assert_array_equal(_np(got), want)
    clT, crT = (np.ascontiguousarray(w.transpose(0, 2, 1)) for w in (cl, cr))
    want = np.asarray(census_volume_T_pallas(
        jnp.asarray(clT), jnp.asarray(crT), D, min_d, dtype=jdt,
        interpret=True))
    got = K.census_volume(_t(clT), _t(crT), D, min_d, dtype, transposed=True)
    np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("dtype", ["float32", "int16"])
def test_build_cost_volume_7x9_matches_jax(dtype):
    left, right = _images(20, 72, seed=6)
    want = np.asarray(jcv.build_cost_volume(
        jnp.asarray(left), jnp.asarray(right), num_disparities=32,
        min_disparity=2, cost="census", window=(7, 9), dtype=dtype))
    got = tcv.build_cost_volume(torch.from_numpy(left),
                                torch.from_numpy(right), 32, 2,
                                window=(7, 9), dtype=dtype)
    np.testing.assert_array_equal(_np(got), want)


# ------------------------------------------------- classic cost volumes --

def _box64(x, size, before, mean):
    """float64 window sums (zero padded) or means (in-frame area) over the
    two trailing axes of a float32 array."""
    after = size - 1 - before

    def sums(a):
        lead = [(0, 0)] * (a.ndim - 2)
        c = np.cumsum(np.cumsum(np.pad(a, lead + [(before, after)] * 2), -2),
                      -1)
        c = np.pad(c, lead + [(1, 0), (1, 0)])
        return (c[..., size:, size:] - c[..., :-size, size:]
                - c[..., size:, :-size] + c[..., :-size, :-size])

    s = sums(x.astype(np.float64))
    return s / sums(np.ones(x.shape[-2:])) if mean else s


def _hold_to_float64(got, want, ref, what):
    """The float64 rule: the port's largest error against the float64
    reference at most twice JAX's."""
    e_port = float(np.abs(np.asarray(got, np.float64) - ref).max())
    e_jax = float(np.abs(np.asarray(want, np.float64) - ref).max())
    print(f"{what}: max |port - float64| {e_port}, |JAX - float64| {e_jax}")
    assert e_port <= 2.0 * e_jax, (what, e_port, e_jax)


def _planes(fn, D, min_d, W):
    """The float32 per-plane inputs of the box filter, (D, H, W), for
    shifts min_d + i; x < d cells are left as built (masked later)."""
    return np.stack([fn(min_d + i) for i in range(D)])


@pytest.mark.parametrize("cost,block", [("sad", 5), ("ssd", 5), ("bt", 5),
                                        ("sad", 9), ("bt", 3)])
def test_box_filtered_volumes_by_the_float64_rule(cost, block):
    H, W, D, min_d = 40, 96, 24, 1
    left, right = _images(H, W, seed=7)
    want = np.asarray(jcv.build_cost_volume(
        jnp.asarray(left), jnp.asarray(right), num_disparities=D,
        min_disparity=min_d, cost=cost, block_size=block, pre_filter_cap=31))
    got = _np(tcv.build_cost_volume(torch.from_numpy(left),
                                    torch.from_numpy(right), D, min_d,
                                    cost=cost, block_size=block,
                                    pre_filter_cap=31))
    assert got.dtype == np.float32 and got.shape == want.shape
    l, r = torch.from_numpy(left), torch.from_numpy(right)
    if cost == "bt":
        ls, rs = (tcv.sobel_x_clipped(a, 31) for a in (l, r))
        (l_lo, l_hi), (r_lo, r_hi) = (tcv._half_sample_envelope(a)
                                      for a in (ls, rs))

        def plane(d):
            sh = [tcv._shift_plane(a, d) for a in (rs, r_lo, r_hi)]
            d_lr = torch.maximum(ls - sh[2], sh[1] - ls).clamp(min=0.0)
            d_rl = torch.maximum(sh[0] - l_hi, l_lo - sh[0]).clamp(min=0.0)
            return _np(torch.minimum(d_lr, d_rl))
    else:
        def plane(d):
            diff = l - tcv._shift_plane(r, d)
            return _np(diff * diff if cost == "ssd" else diff.abs())
    ref = _box64(_planes(plane, D, min_d, W), block, block // 2, mean=True)
    mask = _np(tcv._invalid_mask(W, D, min_d)).repeat(H, 1)
    np.testing.assert_array_equal(got[mask], want[mask])      # INVALID 1e4
    _hold_to_float64(got[~mask], want[~mask], ref[~mask], f"{cost} {block}")


def test_prefilters_and_envelope_bit_equal():
    img = _images(30, 70, seed=8)[0]
    for cap in (31, 63):
        np.testing.assert_array_equal(
            _np(tcv.sobel_x_clipped(torch.from_numpy(img), cap)),
            np.asarray(jcv.sobel_x_clipped(jnp.asarray(img), cap)))
        np.testing.assert_array_equal(
            _np(tbm.bm_prefilter_xsobel(torch.from_numpy(img), cap)),
            np.asarray(jbm.bm_prefilter_xsobel(jnp.asarray(img), cap)))
    sig = np.asarray(jcv.sobel_x_clipped(jnp.asarray(img), 63))
    for got, want in zip(tcv._half_sample_envelope(_t(sig)),
                         jcv._half_sample_envelope(jnp.asarray(sig))):
        np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("size", [5, 9, 21])
def test_bm_box_sum_by_the_float64_rule(size):
    left, right = _images(48, 100, seed=9)
    lp = np.asarray(jbm.bm_prefilter_xsobel(jnp.asarray(left), 31))
    rp = np.asarray(jbm.bm_prefilter_xsobel(jnp.asarray(right), 31))
    x = np.abs(lp - np.roll(rp, 3, axis=1))
    want = np.asarray(jbm._box_sum(jnp.asarray(x), size))
    got = _np(tbm._box_sum(torch.from_numpy(x), size))
    _hold_to_float64(got, want, _box64(x, size, size // 2, mean=False),
                     f"BM box sum {size}")


# --------------------------------------------- SGM + WTA on one volume --

@pytest.mark.parametrize("cost,paths", [("bt", 8), ("sad", 2)])
def test_sgm_and_wta_on_one_jax_volume(cost, paths):
    """JAX's own volume into both packages' SGM and WTA."""
    H, W, D = 40, 96, 24
    left, right = _images(H, W, seed=10)
    jcfg = JaxDisparityConfig(num_disparities=D, cost=cost, num_paths=paths,
                              wls=False, speckle_window_size=0)
    vol = np.array(jcosts.ClassicCost(jcfg)(jnp.asarray(left),
                                            jnp.asarray(right)))
    want_tot = np.asarray(sgm_aggregate(jnp.asarray(vol), jcfg.P1, jcfg.P2,
                                        paths))
    got_tot = _np(K.aggregate_paths(torch.from_numpy(vol), jcfg.P1, jcfg.P2,
                                    paths))
    np.testing.assert_allclose(got_tot, want_tot, rtol=1e-5)
    want = np.asarray(extract_disparity(jnp.asarray(want_tot)))
    got = _np(K.wta_lr(torch.from_numpy(got_tot))[0])
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    close = np.abs(np.nan_to_num(got) - np.nan_to_num(want)) <= 1e-4
    assert close.mean() >= 0.999, close.mean()


# ------------------------------------------------------------- filters --

def test_median_filter_bit_equal():
    img = _images(30, 50, seed=12)[0]
    img[3:6, 4:9] = np.nan                  # a NaN block: +inf in the sort
    img[20:, 40:] = np.nan                  # an all-NaN corner stays NaN
    for size in (3, 5):
        got = _np(tfilters.median_filter(torch.from_numpy(img), size))
        want = np.asarray(jfilters.median_filter(jnp.asarray(img), size))
        np.testing.assert_array_equal(got, want)
    assert np.isnan(got[-1, -1])


@pytest.mark.parametrize("name,kw,atol", [
    ("gaussian_blur", dict(sigma=1.5), 1e-4),
    ("unsharp_mask", dict(sigma=1.0, alpha=30.0), 1e-2),
    ("image_measure", dict(), 1e-2),
    ("bilateral_filter", dict(radius=2), 1e-3),
    ("nl_means_denoise", dict(h=10.0, search_radius=3), 1e-3)])
def test_image_filters_match_jax(name, kw, atol):
    """Float32 elementwise chains in the JAX package's order: within
    rounding (alpha 30 scales the blur's last bits; NL means divides
    float32 cumsum boxes)."""
    img = _images(24, 40, seed=13)[0]
    got = _np(getattr(tfilters, name)(torch.from_numpy(img), **kw))
    want = np.asarray(getattr(jfilters, name)(jnp.asarray(img), **kw))
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
