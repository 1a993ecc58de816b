"""The port's other matchers against the JAX package's, on the CPU.

``StereoMatcher`` with the bt, sad and ssd costs and with a 7x9 census
window (two words), ``BlockMatcher``, ``compute_disparity(method="BM")`` and
the 4-stage volume stream at 7x9 (bit-equal to its paths added in its own
order; P1 = 62 / 3 makes the total depend on that order). The same numpy scene, made from a seed,
goes through both packages. The bt, sad, ssd and BM volumes subtract
float32 cumulative sums, which XLA and torch add in other orders, so a WTA
decision can flip near a tie: there at least 99.5 % of the pixels must be in
the same NaN state and within 0.01 (``chip_smoke.py``'s ``MC_AGREE``). The
census matcher is bit-equal. K4 on a BM volume equals the JAX package's
XLA WTA, uniqueness, subpixel and disp12 steps bit for bit, and a negative
``min_disparity`` raises ``ValueError`` in both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_match_tpu.config import DisparityConfig as JaxDisparityConfig
from stereo_match_tpu.data.synthetic import random_dot_pair, slanted_scene
from stereo_match_tpu.ops import cost_volume as jcv
from stereo_match_tpu.ops import wta as jwta
from stereo_match_tpu.ops.pallas_kernels import lr_mask_pallas
from stereo_match_tpu.pipeline import block_matching as jbm
from stereo_match_tpu.pipeline import elas as jelas
from stereo_match_tpu.pipeline import stereo as jstereo
from stereo_match_tpu_torch.config import DisparityConfig
from stereo_match_tpu_torch.costs import census_cost
from stereo_match_tpu_torch.ops import cost_volume as tcv
from stereo_match_tpu_torch.ops import cuda_kernels as K
from stereo_match_tpu_torch.ops.sgm import PATH_DIRECTIONS_8
from stereo_match_tpu_torch.parallel import StreamingPipeline, make_stage_mesh
from stereo_match_tpu_torch.parallel.pipeline_stage import DOWN, UP
from stereo_match_tpu_torch.pipeline import block_matching as tbm
from stereo_match_tpu_torch.pipeline import elas as telas
from stereo_match_tpu_torch.pipeline import stereo as tstereo

H, W, D = 60, 160, 32
AGREE = 0.995
HEADLINE = dict(num_disparities=D, uniqueness_ratio=15, disp12_max_diff=1,
                wls=False, speckle_window_size=0)


@pytest.fixture(scope="module")
def scene():
    gt = slanted_scene(H, W, 3.0, 20.0)
    left, right = random_dot_pair(H, W, gt, blur=1.0, seed=1)
    return left, right, gt


def _cfgs(**kw):
    """(the port's config, the JAX package's), from the same kwargs."""
    kw = {**HEADLINE, **kw}
    return DisparityConfig(**kw), JaxDisparityConfig(**kw)


def _agreement(got, want):
    """Share of pixels with the same NaN state and |diff| <= 0.01."""
    got, want = np.asarray(got), np.asarray(want)
    nan_g, nan_w = np.isnan(got), np.isnan(want)
    close = np.abs(np.nan_to_num(got) - np.nan_to_num(want)) <= 0.01
    return float(((nan_g == nan_w) & (close | nan_g | nan_w)).mean())


# ------------------------------------------------------- StereoMatcher --

@pytest.mark.parametrize("kw,exact", [
    (dict(cost="bt"), False),
    (dict(cost="sad", num_paths=2), False),
    (dict(cost="ssd", num_paths=4), False),
    (dict(cost="bt", dtype="int16", speckle_window_size=100,
          speckle_range=2), False),
    (dict(census_window=(7, 9)), True),
    (dict(census_window=(7, 9), dtype="int16", min_disparity=2), True)],
    ids=["bt", "sad-2paths", "ssd-4paths", "bt-int16-speckle", "census7x9",
         "census7x9-int16"])
def test_stereo_matcher_matches_jax(scene, kw, exact):
    """On a non-census cost ``dtype="int16"`` builds float32, as JAX's
    ``_match_core`` does; the 7x9 census (62 bits, two words) is
    bit-equal."""
    left, right, gt = scene
    cfg, jcfg = _cfgs(**kw)
    raw, filtered = tstereo.StereoMatcher(cfg, device="cpu")(left, right)
    jraw, jfiltered = jstereo.StereoMatcher(jcfg)(left, right)
    for got, want in ((raw, jraw), (filtered, jfiltered)):
        got, want = got.numpy(), np.asarray(want)
        if exact:
            np.testing.assert_array_equal(got, want)
        else:
            assert _agreement(got, want) >= AGREE, _agreement(got, want)
    # two SAD paths with the uniqueness and disp12 checks keep the fewest
    valid = np.isfinite(raw.numpy())
    assert valid.mean() > 0.25
    assert np.median(np.abs(raw.numpy() - gt)[valid]) < 1.0


def test_wide_census_volume_feeds_k2_words(scene):
    """The census volume at 9x11 (98 bits, four words) through K1 then K2
    equals JAX's XLA volume."""
    left, right = (np.ascontiguousarray(a[:20, :64], np.float32)
                   for a in scene[:2])
    words = K.census_words(torch.from_numpy(np.stack([left, right])), (9, 11))
    assert words.shape == (2, 4, 20, 64)
    want = np.asarray(jcv.build_cost_volume(
        jnp.asarray(left), jnp.asarray(right), num_disparities=16,
        window=(9, 11)))
    got = tcv.build_cost_volume(torch.from_numpy(left),
                                torch.from_numpy(right), 16, window=(9, 11))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        K.census_volume(words[0], words[1], 16).numpy(), want)


# -------------------------------------------------------------- StereoBM --

@pytest.mark.parametrize("kw", [dict(block_size=21), dict(block_size=9),
                                dict(block_size=9, disp12_max_diff=1,
                                     min_disparity=3,
                                     speckle_window_size=100,
                                     speckle_range=2)],
                         ids=["block21", "block9", "block9-disp12-speckle"])
def test_block_matcher_matches_jax(scene, kw):
    left, right, _ = scene
    base = dict(num_disparities=D, wls=False, speckle_window_size=0,
                disp12_max_diff=-1)
    base.update(kw)
    cfg, jcfg = DisparityConfig(**base), JaxDisparityConfig(**base)
    raw, filtered = tbm.BlockMatcher(cfg, device="cpu")(left, right)
    jraw, jfiltered = jbm.BlockMatcher(jcfg)(left, right)
    for got, want in ((raw, jraw), (filtered, jfiltered)):
        share = _agreement(got.numpy(), want)
        assert share >= AGREE, share
    assert np.isfinite(raw.numpy()).mean() > 0.3


def test_block_match_wta_on_k4_equals_xla_steps(scene):
    """K4 ``wta_lr`` on a BM volume computes block_match's WTA, subpixel,
    uniqueness and disp12 steps bit for bit."""
    left, right, _ = scene
    lp = tbm.bm_prefilter_xsobel(torch.from_numpy(left), 31)
    rp = tbm.bm_prefilter_xsobel(torch.from_numpy(right), 31)
    min_d, ratio = 3, 15
    vol = tbm.sad_volume(lp, rp, D, min_d, 9)
    jvol = jnp.asarray(vol.numpy())
    idx = jwta.wta_disparity(jvol)
    disp = jwta.subpixel_refine(jvol, idx) + min_d
    for disp12 in (-1, 1):
        ok = jwta.uniqueness_mask(jvol, idx, ratio)
        if disp12 >= 0:
            ok &= jwta.lr_consistency_mask(
                disp, jwta.right_disparity_from_volume(jvol, min_d), disp12,
                min_d)
        want = np.asarray(jnp.where(ok, disp, jnp.nan))
        got, _ = K.wta_lr(vol, min_d, ratio, disp12, subpixel=True)
        np.testing.assert_array_equal(got.numpy(), want)


def test_compute_disparity_bm_matches_jax(scene):
    """The int16 disparity*16 surface of ``method="BM"``, speckle on."""
    left, right, _ = scene
    kw = dict(num_disparities=D, block_size=15, wls=False,
              speckle_window_size=50, speckle_range=2)
    cfg, jcfg = DisparityConfig(**kw), JaxDisparityConfig(**kw)
    got = tstereo.compute_disparity(left, right, cfg, method="BM",
                                    device="cpu")
    want = jstereo.compute_disparity(left, right, jcfg, method="BM")
    for g, w in zip(got, want):
        assert g.dtype == np.int16 and g.shape == (H, W)
        same = np.abs(g.astype(np.int32) - np.asarray(w, np.int32)) <= 0
        assert same.mean() >= AGREE, same.mean()


# ---------------------------------------------------- disp12 tolerance --

@pytest.mark.parametrize("tol", [0.5, 1.5, 2.0])
def test_lr_mask_takes_a_float_tolerance(tol):
    """K4 ``lr_mask``'s plain version at a fractional tolerance, against
    ``lr_mask_pallas`` (interpret mode) and the XLA mask."""
    rng = np.random.default_rng(3)
    dl = rng.uniform(0, 31, (24, 90)).astype(np.float32)
    dl[::7, ::5] = np.nan
    dr = np.round(dl) + rng.choice([-2.0, -1.5, -1.0, 0.0, 1.0, 1.5],
                                   dl.shape).astype(np.float32)
    dr = np.nan_to_num(dr).astype(np.float32)
    want = np.asarray(lr_mask_pallas(jnp.asarray(dl), jnp.asarray(dr), 32,
                                     tol, 0, interpret=True))
    np.testing.assert_array_equal(
        want, np.asarray(jwta.lr_consistency_mask(jnp.asarray(dl),
                                                  jnp.asarray(dr), tol)))
    got = K.lr_mask(torch.from_numpy(dl), torch.from_numpy(dr), tol)
    np.testing.assert_array_equal(got.numpy(), want)
    if tol == 1.5:
        assert (got.numpy() != K.lr_mask(torch.from_numpy(dl),
                                         torch.from_numpy(dr), 1).numpy()
                ).any()


# ----------------------------------------------------------- the stream --

def test_volume_stream_with_a_7x9_window(scene):
    """The 4-stage volume stream takes multiword census (K1, K2 transposed).

    At 7x9, P1 = 62 / 3 is fractional, so the total depends on the order
    in which the paths are added: the stream adds them by stage (the
    horizontal pair, the downward, then the upward scans), ``_match_core``
    in ``PATH_DIRECTIONS_8``'s order. The stream is bit-equal to the scans
    added in its own order, and equal to ``_match_core`` of both packages
    in its NaN mask and within 1e-5 (ulps of the subpixel values). The
    census payload keeps its 24-bit limit, as in JAX.
    """
    left, right, _ = scene
    cfg, jcfg = _cfgs(census_window=(7, 9))
    frames = [(left, right), (right[:, ::-1].copy(), left[:, ::-1].copy())]
    pipe = StreamingPipeline(cfg, make_stage_mesh(4, ["cpu"] * 4),
                             image_shape=(H, W))
    order = PATH_DIRECTIONS_8[:2] + DOWN + UP
    for (lf, rf), (raw, filt) in zip(frames, pipe.run(frames)):
        lf, rf = torch.from_numpy(lf), torch.from_numpy(rf)
        vol = census_cost(lf, rf, cfg)
        total = torch.empty_like(vol)
        for i, (dy, dx) in enumerate(order):
            K.sgm_path_scan(vol, total, dy, dx, cfg.P1, cfg.P2, i > 0)
        want, _ = K.wta_lr(total, cfg.min_disparity, cfg.uniqueness_ratio,
                           cfg.disp12_max_diff, cfg.subpixel)
        np.testing.assert_array_equal(raw.numpy(), want.numpy())
        np.testing.assert_array_equal(filt.numpy(), want.numpy())
        for ref in (tstereo._match_core(lf, rf, cfg)[0].numpy(),
                    np.asarray(jstereo._match_core(jnp.asarray(lf.numpy()),
                                                   jnp.asarray(rf.numpy()),
                                                   jcfg)[0])):
            np.testing.assert_array_equal(np.isnan(raw.numpy()),
                                          np.isnan(ref))
            np.testing.assert_allclose(raw.numpy(), ref, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="24-bit"):
        StreamingPipeline(cfg, make_stage_mesh(2, ["cpu"] * 2), (H, W),
                          payload_mode="census")


# ------------------------------------------------- negative min_disparity --

@pytest.mark.parametrize("path", ["census", "bt", "BM", "ELAS"])
def test_negative_min_disparity_raises_in_both(path):
    """The reference does not support a negative min_disparity (its plane
    shift pads by d); the port refuses it with a ValueError too."""
    img = np.random.default_rng(0).uniform(0, 255, (24, 64)).astype(
        np.float32)
    cfg, jcfg = _cfgs(min_disparity=-4, num_disparities=16,
                      cost="bt" if path == "bt" else "census")
    port, jax_ = {
        "census": (lambda: tstereo.StereoMatcher(cfg, device="cpu")(img, img),
                   lambda: jstereo.StereoMatcher(jcfg)(img, img)),
        "bt": (lambda: tstereo.StereoMatcher(cfg, device="cpu")(img, img),
               lambda: jstereo.StereoMatcher(jcfg)(img, img)),
        "BM": (lambda: tbm.BlockMatcher(cfg, device="cpu")(img, img),
               lambda: jbm.BlockMatcher(jcfg)(img, img)),
        "ELAS": (lambda: telas.elas_match(img, img, 16, min_disparity=-4,
                                          device="cpu"),
                 lambda: jelas.elas_match(img, img, 16, min_disparity=-4)),
    }[path]
    with pytest.raises(ValueError):
        jax_()
    with pytest.raises(ValueError, match="does not support a negative"):
        port()
