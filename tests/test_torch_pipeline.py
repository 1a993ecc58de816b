"""The PyTorch port's pipeline against the JAX package's, on the CPU.

The same seeded scene goes through the JAX ``StereoMatcher`` (its XLA path
on the CPU) and the port's (the kernels' plain versions on the CPU). The
NaN masks must be equal and the values within 1e-6.
"""

import dataclasses
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
    raw, filtered = tstereo.StereoMatcher(cfg, device="cpu")(left, right)
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
    matcher = tstereo.StereoMatcher(cfg, device="cpu")
    raw, filtered = matcher.batched(lefts, rights)
    assert raw.shape == (2, 32, 64) and filtered.shape == (2, 32, 64)
    _assert_same_disparity(raw, want)
    _assert_same_disparity(raw[1], matcher(lefts[1], rights[1])[0])


def test_compute_disparity_matches_jax():
    gt = tsynthetic.slanted_scene(32, 64, 2.0, 12.0)
    left, right = tsynthetic.random_dot_pair(32, 64, gt, blur=0.8)
    cfg = DisparityConfig(num_disparities=16, min_disparity=1, **HEADLINE)
    want = jstereo.compute_disparity(left, right, cfg)
    got = tstereo.compute_disparity(left, right, cfg, device="cpu")
    for g, w in zip(got, want):
        assert g.dtype == np.int16
        np.testing.assert_array_equal(g, w)
    assert (got[0] == 0).any()             # invalid -> (min_d - 1) * 16
    matcher = tstereo._MATCHER_CACHE[(repr(cfg), "SGBM", "cpu")]
    tstereo.compute_disparity(left, right, cfg, device="cpu")
    assert tstereo._MATCHER_CACHE[(repr(cfg), "SGBM", "cpu")] is matcher


def _assert_same_config(a, b):
    """Field by field, and the derived P1, P2 and num_disparities."""
    assert type(a) is not type(b)          # the port keeps its own class
    names = [f.name for f in dataclasses.fields(a)]
    assert names == [f.name for f in dataclasses.fields(b)]
    for name in names:
        assert getattr(a, name) == getattr(b, name), name
    assert (a.P1, a.P2, a.num_disparities) == (b.P1, b.P2, b.num_disparities)


@pytest.mark.parametrize("kw,want", [
    (dict(num_disparities=100, census_window=(3, 3), wls=False),
     (8 / 3, 32.0, 112)),
    (dict(census_window=(7, 7)), (16.0, 192.0, 160)),
    (dict(num_disparities=64, dtype="int16"), (8.0, 96.0, 64)),
    (dict(num_disparities=33, cost="mccnn"), (8.0, 96.0, 48)),
    (dict(cost="sad", window_size=3), (72.0, 288.0, 160)),
])
def test_config_carries_across(tmp_path, kw, want):
    """The port's own config equals the JAX package's, from kwargs and from
    the same INI."""
    a, b = DisparityConfig(**kw), JaxDisparityConfig(**kw)
    _assert_same_config(a, b)
    assert (a.P1, a.P2, a.num_disparities) == want
    ini = tmp_path / "settings.ini"
    ini.write_text("[disparity]\nnum_disparities = 150\nmin_disparity = 2\n"
                   "uniqueness_ratio = 10\nwls = false\np1 = 10\n"
                   "cost = census\nunknown_key = 3\n")
    a = load_settings(str(ini), {"speckle_window_size": 0, **kw})
    b = jax_load_settings(str(ini), {"speckle_window_size": 0, **kw})
    _assert_same_config(a, b)
    assert a.min_disparity == 2 and a.uniqueness_ratio == 10


def test_config_rejects_what_jax_rejects():
    for kw in (dict(num_disparities=0),
               dict(dtype="int16", num_paths=8, p2=4000.0)):
        with pytest.raises(ValueError):
            DisparityConfig(**kw)
        with pytest.raises(ValueError):
            JaxDisparityConfig(**kw)
    with pytest.raises(FileNotFoundError):
        load_settings("/nonexistent/settings.ini")


@pytest.mark.parametrize("kw,exc,match", [
    (dict(cost="mccnn"), ValueError, "unknown cost family: mccnn"),
    (dict(cost="orb"), ValueError, "unknown cost family: orb"),
    (dict(census_window=(4, 5)), ValueError, "odd"),
    (dict(min_disparity=-2), ValueError, "does not support"),
    (dict(cost="bt", min_disparity=-2), ValueError, "does not support"),
    (dict(dtype="float16"), NotImplementedError, "ROADMAP")],
    ids=[f"kw{i}" for i in range(6)])
def test_configs_outside_the_slice_raise(kw, exc, match):
    """cost="mccnn" needs a cost_fn; without one it is an unknown family,
    as in JAX's build_cost_volume. A negative min_disparity raises as in
    the reference."""
    cfg = DisparityConfig(num_disparities=16, **{**HEADLINE, **kw})
    img = torch.zeros(8, 32)
    with pytest.raises(exc, match=match):
        tstereo.StereoMatcher(cfg, device="cpu")
    with pytest.raises(exc, match=match):
        tstereo._match_core(img, img, cfg)


def test_default_config_and_bm_raise():
    # DisparityConfig() (WLS on) and BM are in the slice; BM with a
    # negative min_disparity and 3 paths are not
    assert tstereo.StereoMatcher(device="cpu").config == DisparityConfig()
    img = np.zeros((8, 32), np.float32)
    with pytest.raises(ValueError, match="does not support"):
        tstereo.compute_disparity(
            img, img, DisparityConfig(min_disparity=-1, **HEADLINE),
            method="BM", device="cpu")
    with pytest.raises(ValueError):
        tstereo.StereoMatcher(DisparityConfig(num_paths=3, **HEADLINE),
                              device="cpu")


def test_port_imports_no_jax():
    """Every submodule of the port, then the census, MC-CNN (random
    weights), BT, BM, ELAS, flagship and monodepth (shipped weights) paths
    and one train step of each model on the CPU: neither JAX nor any
    module of the JAX package gets loaded."""
    code = (
        "import importlib, pkgutil, sys, numpy as np\n"
        "import stereo_match_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "need = {'stereo_match_tpu_torch.costs', "
        "'stereo_match_tpu_torch.models.mccnn', "
        "'stereo_match_tpu_torch.data.costbin', "
        "'stereo_match_tpu_torch.parallel.tiling', "
        "'stereo_match_tpu_torch.parallel.pipeline_stage', "
        "'stereo_match_tpu_torch.pipeline.block_matching', "
        "'stereo_match_tpu_torch.pipeline.elas', "
        "'stereo_match_tpu_torch.ops.filters', "
        "'stereo_match_tpu_torch.native', "
        "'stereo_match_tpu_torch.models.monodepth', "
        "'stereo_match_tpu_torch.cli.main', "
        "'stereo_match_tpu_torch.data.raytrace', "
        "'stereo_match_tpu_torch.data.kitti', "
        "'stereo_match_tpu_torch.data.middlebury', "
        "'stereo_match_tpu_torch.data.arkit', "
        "'stereo_match_tpu_torch.pipeline.artifacts', "
        "'stereo_match_tpu_torch.eval.parity', "
        "'stereo_match_tpu_torch.utils.handy', "
        "'stereo_match_tpu_torch.utils.profiling', "
        "'stereo_match_tpu_torch.viz.plots', "
        "'stereo_match_tpu_torch.models.optim', "
        "'stereo_match_tpu_torch.core.calibration', "
        "'stereo_match_tpu_torch.tools.train_mccnn', "
        "'stereo_match_tpu_torch.tools.train_monodepth'}\n"
        "assert need <= set(names), need - set(names)\n"
        "from stereo_match_tpu_torch.config import DisparityConfig\n"
        "from stereo_match_tpu_torch.costs import MCCNNCost\n"
        "from stereo_match_tpu_torch.models.mccnn import make_model\n"
        "from stereo_match_tpu_torch.pipeline.stereo import (StereoMatcher, "
        "run_pipeline)\n"
        "rng = np.random.default_rng(0)\n"
        "l, r = (rng.uniform(0, 255, (12, 40)).astype(np.float32) "
        "for _ in range(2))\n"
        "cfg = DisparityConfig(num_disparities=16, wls=False)\n"
        "raw, _ = StereoMatcher(cfg, device='cpu')(l, r)\n"
        "assert raw.shape == (12, 40)\n"
        "mc = cfg.replace(cost='mccnn')\n"
        "mc_cost = MCCNNCost(make_model('fast'), mc)\n"
        "raw, _ = StereoMatcher(mc, cost_fn=mc_cost, device='cpu')(l, r)\n"
        "assert raw.shape == (12, 40)\n"
        "raw, _ = StereoMatcher(cfg.replace(cost='bt'), device='cpu')(l, r)\n"
        "assert raw.shape == (12, 40)\n"
        "from stereo_match_tpu_torch.pipeline.block_matching import "
        "BlockMatcher\n"
        "from stereo_match_tpu_torch.pipeline.elas import elas_match\n"
        "raw, _ = BlockMatcher(cfg.replace(block_size=5), device='cpu')(l, r)\n"
        "assert raw.shape == (12, 40)\n"
        "e = rng.uniform(0, 255, (40, 64)).astype(np.float32)\n"
        "assert elas_match(e, e, 16, device='cpu').shape == (40, 64)\n"
        "l, r = (rng.uniform(0, 255, (12, 176)).astype(np.float32) "
        "for _ in range(2))\n"
        "raw, filtered = StereoMatcher(device='cpu')(l, r)\n"
        "assert filtered.isfinite().all()\n"
        "pose_r = np.eye(4); pose_r[0, 3] = 0.1\n"
        "K = np.array([[50.0, 0, 88], [0, 50.0, 6], [0, 0, 1]])\n"
        "res = run_pipeline(np.eye(4), pose_r, K, K, l, r, device='cpu')\n"
        "assert res.points.shape == (12, 176, 3)\n"
        "from stereo_match_tpu_torch.data.raytrace import render_stereo\n"
        "from stereo_match_tpu_torch.models import monodepth\n"
        "img, _, _ = render_stereo(24, 40, seed=1)\n"
        "model = monodepth.load_default(device='cpu')\n"
        "d = monodepth.predict_disparity(model, np.stack([img] * 3, -1))\n"
        "assert d.shape == (24, 40) and d.isfinite().all()\n"
        "from stereo_match_tpu_torch.models import mccnn\n"
        "p = rng.normal(size=(4, 12, 12)).astype(np.float32)\n"
        "tower, ls = mccnn.train(mccnn.make_model((8, 2), seed=0), "
        "[(p, p[::-1].copy(), p[:, ::-1].copy())], 1e-3, device='cpu')\n"
        "assert len(ls) == 1 and np.isfinite(ls[0])\n"
        "x = rng.uniform(0, 1, (1, 32, 48, 3)).astype(np.float32)\n"
        "net, ls = monodepth.train(monodepth.make_model('small'), "
        "[(x, x[:, :, ::-1].copy())], 1e-4, device='cpu')\n"
        "assert len(ls) == 1 and np.isfinite(ls[0])\n"
        "assert 'jax' not in sys.modules, 'the port imported jax'\n"
        "ref = [m for m in sys.modules if m == 'stereo_match_tpu' or "
        "m.startswith('stereo_match_tpu.')]\n"
        "assert not ref, f'the port imported the JAX package: {ref}'\n"
        "print('ok')\n")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("entry", ["StereoMatcher", "compute_disparity",
                                   "run_pipeline", "rectify_pair",
                                   "rectification_maps",
                                   "external_volume_to_disparity",
                                   "BlockMatcher", "block_match",
                                   "compute_disparity_bm", "elas_match",
                                   "monodepth_load_default"])
def test_entry_points_default_to_the_card(entry):
    """Called without a device, each entry point asks for the card and,
    without one, raises instead of running on the CPU."""
    from stereo_match_tpu_torch.core import rectify as trectify
    from stereo_match_tpu_torch.data import costbin as tcostbin
    from stereo_match_tpu_torch.models import monodepth as tmonodepth
    from stereo_match_tpu_torch.pipeline import block_matching as tbm
    from stereo_match_tpu_torch.pipeline import elas as telas
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    img = np.zeros((8, 32), np.float32)
    pose_r = np.eye(4)
    pose_r[0, 3] = 0.1
    K = np.array([[50.0, 0, 16], [0, 50.0, 4], [0, 0, 1]])
    calls = {
        "StereoMatcher": lambda: tstereo.StereoMatcher(),
        "compute_disparity": lambda: tstereo.compute_disparity(img, img),
        "run_pipeline": lambda: tstereo.run_pipeline(np.eye(4), pose_r, K, K,
                                                     img, img),
        "rectify_pair": lambda: trectify.rectify_pair(np.eye(4), pose_r, K, K,
                                                      img, img),
        "rectification_maps": lambda: trectify.rectification_maps(
            K, np.eye(3), np.hstack([K, np.zeros((3, 1))]), (32, 8)),
        "external_volume_to_disparity":
            lambda: tcostbin.external_volume_to_disparity(
                np.zeros((16, 8, 32), np.float32)),
        "BlockMatcher": lambda: tbm.BlockMatcher(),
        "block_match": lambda: tbm.block_match(img, img, 16),
        "compute_disparity_bm": lambda: tstereo.compute_disparity(
            img, img, method="BM"),
        "elas_match": lambda: telas.elas_match(img, img, 16),
        "monodepth_load_default": lambda: tmonodepth.load_default(),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


def test_require_hopper_raises_without_a_card():
    from stereo_match_tpu_torch.utils.backend import require_hopper
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        require_hopper(0)
