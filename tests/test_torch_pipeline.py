"""The PyTorch port's pipeline against the JAX package's, on the CPU.

The same seeded scene goes through the JAX ``StereoMatcher`` (its XLA path
on the CPU) and the port's (the kernels' plain versions on the CPU). The
NaN masks must be equal and the values within 1e-6.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import stereo_match_tpu.pipeline.stereo as jstereo
from stereo_match_tpu.config import DisparityConfig as JaxDisparityConfig
from stereo_match_tpu.config import load_settings as jax_load_settings
from stereo_match_tpu.data import synthetic as jsynthetic
from stereo_match_tpu_torch.config import DisparityConfig, load_settings
from stereo_match_tpu_torch.data import synthetic as tsynthetic
from stereo_match_tpu_torch.eval.metrics import bad_pixel_rate, density
from stereo_match_tpu_torch.pipeline import stereo as tstereo

REPO = Path(__file__).resolve().parents[1]
HEADLINE = dict(cost="census", uniqueness_ratio=15, disp12_max_diff=1,
                wls=False, speckle_window_size=0)


def _scene(H, W, d_max, seed=1):
    gt = tsynthetic.slanted_scene(H, W, 2.0, d_max)
    left, right = tsynthetic.random_dot_pair(H, W, gt, blur=1.0, seed=seed)
    return left.astype(np.float32), right.astype(np.float32), gt


def _assert_same_disparity(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got[~np.isnan(got)], want[~np.isnan(want)],
                               rtol=0, atol=1e-6)


def test_synthetic_scenes_match_jax():
    gt = tsynthetic.slanted_scene(30, 70, 5.0, 40.0)
    np.testing.assert_array_equal(gt, jsynthetic.slanted_scene(30, 70, 5.0,
                                                               40.0))
    for got, want in zip(tsynthetic.random_dot_pair(30, 70, gt, seed=3,
                                                    noise=2.0, shading=0.3),
                         jsynthetic.random_dot_pair(30, 70, gt, seed=3,
                                                    noise=2.0, shading=0.3)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [dict(),
                                dict(min_disparity=4, num_paths=4,
                                     subpixel=False)])
def test_stereo_matcher_matches_jax(kw):
    left, right, gt = _scene(48, 160, 50.0)
    cfg = DisparityConfig(num_disparities=64, **HEADLINE, **kw)
    want_raw, want_filtered = jstereo.StereoMatcher(cfg)(left, right)
    raw, filtered = tstereo.StereoMatcher(cfg)(left, right)
    assert raw.dtype == torch.float32 and raw.shape == (48, 160)
    _assert_same_disparity(raw, want_raw)
    _assert_same_disparity(filtered, want_filtered)
    if not kw:
        assert float(bad_pixel_rate(raw, gt, 3.0, 0.0)) < 0.03
        assert float(density(raw)) > 0.8


def test_batched_matches_jax():
    gt = tsynthetic.slanted_scene(32, 64, 2.0, 12.0)
    pairs = [tsynthetic.random_dot_pair(32, 64, gt, blur=0.8, seed=s)
             for s in (1, 2)]
    lefts = np.stack([p[0] for p in pairs]).astype(np.float32)
    rights = np.stack([p[1] for p in pairs]).astype(np.float32)
    cfg = DisparityConfig(num_disparities=16, **HEADLINE)
    want, _ = jstereo.StereoMatcher(cfg).batched(lefts, rights)
    matcher = tstereo.StereoMatcher(cfg)
    raw, filtered = matcher.batched(lefts, rights)
    assert raw.shape == (2, 32, 64) and filtered.shape == (2, 32, 64)
    _assert_same_disparity(raw, want)
    _assert_same_disparity(raw[1], matcher(lefts[1], rights[1])[0])


def test_compute_disparity_matches_jax():
    gt = tsynthetic.slanted_scene(32, 64, 2.0, 12.0)
    left, right = tsynthetic.random_dot_pair(32, 64, gt, blur=0.8)
    cfg = DisparityConfig(num_disparities=16, min_disparity=1, **HEADLINE)
    want = jstereo.compute_disparity(left, right, cfg)
    got = tstereo.compute_disparity(left, right, cfg)
    for g, w in zip(got, want):
        assert g.dtype == np.int16
        np.testing.assert_array_equal(g, w)
    assert (got[0] == 0).any()             # invalid -> (min_d - 1) * 16
    matcher = tstereo._MATCHER_CACHE[(repr(cfg), "SGBM", "cpu")]
    tstereo.compute_disparity(left, right, cfg)
    assert tstereo._MATCHER_CACHE[(repr(cfg), "SGBM", "cpu")] is matcher


def test_config_carries_across(tmp_path):
    """Both packages build the same config, from kwargs and from an INI."""
    assert DisparityConfig is JaxDisparityConfig
    kw = dict(num_disparities=100, census_window=(3, 3), wls=False)
    a, b = DisparityConfig(**kw), JaxDisparityConfig(**kw)
    assert a == b and a.num_disparities == 112           # multiple of 16
    assert (a.P1, a.P2) == (b.P1, b.P2) == (8 / 3, 32.0)
    ini = tmp_path / "settings.ini"
    ini.write_text("[disparity]\nnum_disparities = 150\nmin_disparity = 2\n"
                   "uniqueness_ratio = 10\nwls = false\np1 = 10\n")
    a = load_settings(str(ini), {"speckle_window_size": 0})
    b = jax_load_settings(str(ini), {"speckle_window_size": 0})
    assert a == b and a.num_disparities == 160
    assert (a.P1, a.P2) == (b.P1, b.P2) == (10.0, 96.0)


@pytest.mark.parametrize("kw", [
    dict(cost="sad"), dict(cost="bt"), dict(cost="mccnn"),
    dict(census_window=(7, 7)), dict(min_disparity=-2),
    dict(dtype="float16")])
def test_configs_outside_the_slice_raise(kw):
    cfg = DisparityConfig(num_disparities=16, **{**HEADLINE, **kw})
    img = torch.zeros(8, 32)
    # cost="mccnn" needs a cost_fn; without one it is an unknown family, as
    # in JAX's build_cost_volume
    exc, match = (ValueError, "unknown cost family: mccnn") \
        if cfg.cost == "mccnn" else (NotImplementedError, "ROADMAP")
    with pytest.raises(exc, match=match):
        tstereo.StereoMatcher(cfg)
    with pytest.raises(exc, match=match):
        tstereo._match_core(img, img, cfg)


def test_default_config_and_bm_raise():
    # DisparityConfig() (WLS on) is in the slice; BM and 3 paths are not
    assert tstereo.StereoMatcher().config == DisparityConfig()
    img = np.zeros((8, 32), np.float32)
    with pytest.raises(NotImplementedError):
        tstereo.compute_disparity(img, img, DisparityConfig(**HEADLINE),
                                  method="BM")
    with pytest.raises(ValueError):
        tstereo.StereoMatcher(DisparityConfig(num_paths=3, **HEADLINE))


def test_port_imports_no_jax():
    code = (
        "import sys, numpy as np\n"
        "import stereo_match_tpu_torch\n"
        "from stereo_match_tpu_torch.config import DisparityConfig\n"
        "from stereo_match_tpu_torch.pipeline.stereo import (StereoMatcher, "
        "run_pipeline)\n"
        "import stereo_match_tpu_torch.eval.metrics, "
        "stereo_match_tpu_torch.utils.backend\n"
        "import stereo_match_tpu_torch.core.camera, "
        "stereo_match_tpu_torch.core.rectify, "
        "stereo_match_tpu_torch.core.reproject, "
        "stereo_match_tpu_torch.data.ply, stereo_match_tpu_torch.data.image, "
        "stereo_match_tpu_torch.ops.speckle, stereo_match_tpu_torch.ops.wls\n"
        "rng = np.random.default_rng(0)\n"
        "l, r = (rng.uniform(0, 255, (12, 40)).astype(np.float32) "
        "for _ in range(2))\n"
        "cfg = DisparityConfig(num_disparities=16, wls=False)\n"
        "raw, _ = StereoMatcher(cfg)(l, r)\n"
        "assert raw.shape == (12, 40)\n"
        "l, r = (rng.uniform(0, 255, (12, 176)).astype(np.float32) "
        "for _ in range(2))\n"
        "raw, filtered = StereoMatcher()(l, r)\n"
        "assert filtered.isfinite().all()\n"
        "pose_r = np.eye(4); pose_r[0, 3] = 0.1\n"
        "K = np.array([[50.0, 0, 88], [0, 50.0, 6], [0, 0, 1]])\n"
        "res = run_pipeline(np.eye(4), pose_r, K, K, l, r)\n"
        "assert res.points.shape == (12, 176, 3)\n"
        "assert 'jax' not in sys.modules, 'the port imported jax'\n"
        "print('ok')\n")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_require_hopper_raises_without_a_card():
    from stereo_match_tpu_torch.utils.backend import require_hopper
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        require_hopper(0)
