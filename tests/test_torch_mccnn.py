"""The port's MC-CNN inference path against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through the JAX function (its
XLA path, flax ``model.apply``, or a Pallas kernel in interpret mode) and
the port's, which runs the plain versions of K8 (tower layer) and K9
(feature-dot volume) on the CPU. Tolerances: features 1e-5 (XLA and ATen
sum the convolutions in different orders; JAX's own Pallas-vs-flax test
uses 2e-6), volumes 1e-4 (JAX's bound in
``test_fused_cost_volume_matches_xla_path``), and the port's SGM/WTA on
JAX's own volume 1e-6 with the same NaN mask. The port's own volume
differs from JAX's by float rounding, which can flip a WTA decision at a
few pixels, so there the disparities must agree on at least 99.5 % of the
pixels.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stereo_match_tpu.costs as jcosts
import stereo_match_tpu.pipeline.stereo as jstereo
from stereo_match_tpu import config as jconfig
from stereo_match_tpu.costs import MCCNNCost as JaxMCCNNCost
from stereo_match_tpu.data import costbin as jcostbin
from stereo_match_tpu.data import synthetic as jsynthetic
from stereo_match_tpu.models import mccnn as jmccnn
from stereo_match_tpu.ops.pallas_kernels import mccnn_volume_pallas
from stereo_match_tpu_torch import costs as tcosts
from stereo_match_tpu_torch.config import DisparityConfig
from stereo_match_tpu_torch.data import costbin as tcostbin
from stereo_match_tpu_torch.data import synthetic as tsynthetic
from stereo_match_tpu_torch.eval.metrics import bad_pixel_rate
from stereo_match_tpu_torch.models import mccnn as tmccnn
from stereo_match_tpu_torch.ops import cuda_kernels as K
from stereo_match_tpu_torch.pipeline import stereo as tstereo

REPO = Path(__file__).resolve().parents[1]
ARCHS = ("fast", "accurate")
HEADLINE = dict(uniqueness_ratio=15, disp12_max_diff=1, wls=False,
                speckle_window_size=0)
FEATURE_ATOL = 1e-5
VOLUME_ATOL = 1e-4
FGS_TOL = dict(rtol=1e-3, atol=2e-4)       # tests/test_refine.py:214


@pytest.fixture(scope="module")
def shipped():
    """arch -> (JAX model, JAX params, the port's model)."""
    out = {}
    for arch in ARCHS:
        params = jmccnn.load_default_params(arch)
        out[arch] = (jmccnn.make_model(arch), params,
                     tmccnn.from_flax_params(tmccnn.load_default_params(arch),
                                             arch))
    return out


def _images(H, W, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 255, (2, H, W)).astype(np.float32)


def _jax_features(model, params, img):
    """flax tower on one normalized (H, W) image -> (F, H, W) numpy."""
    f = model.apply(params, jnp.asarray(img)[None, ..., None])[0]
    return np.ascontiguousarray(np.moveaxis(np.asarray(f), -1, 0))


def _assert_same_disparity(got, want, atol=1e-6):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got[~np.isnan(got)], want[~np.isnan(want)],
                               rtol=0, atol=atol)


def _agreement(got, want, atol=0.01):
    """Share of pixels with the same NaN state and |diff| <= atol."""
    got, want = np.asarray(got), np.asarray(want)
    same_nan = np.isnan(got) == np.isnan(want)
    close = np.where(np.isnan(got) | np.isnan(want), True,
                     np.abs(np.nan_to_num(got) - np.nan_to_num(want)) <= atol)
    return float(np.mean(same_nan & close))


# ------------------------------------------------------ weight carrier ----

@pytest.mark.parametrize("arch", ARCHS)
def test_converter_loads_shipped_checkpoint(shipped, arch):
    _, params, model = shipped[arch]
    F, L = tmccnn.ARCHS[arch]
    assert (model.features, model.num_layers, model.kernel) == (F, L, 3)
    assert tmccnn.default_checkpoint_path(arch) == \
        Path(jmccnn.default_checkpoint_path(arch)).resolve()
    for i in range(L):
        kernel = np.asarray(params["params"][f"conv{i}"]["kernel"])
        np.testing.assert_array_equal(
            model.weights[i].numpy(), np.transpose(kernel, (3, 2, 0, 1)))
        if i == 0:       # K8's C_in = 1 body reads the flax layout as is
            np.testing.assert_array_equal(model.layout0.numpy(), kernel)
        np.testing.assert_array_equal(
            model.biases[i].numpy(),
            np.asarray(params["params"][f"conv{i}"]["bias"]))
        assert not model.weights[i].requires_grad


@pytest.mark.parametrize("arch,key", [("fast", 0), ("fast", 7),
                                      ("accurate", 1)])
def test_converter_takes_random_flax_init(arch, key):
    jmodel = jmccnn.make_model(arch)
    params = jmccnn.init_params(jmodel, jax.random.PRNGKey(key))
    model = tmccnn.from_flax_params(params, arch)
    img = np.random.default_rng(key).normal(size=(12, 21)).astype(np.float32)
    got = model(torch.from_numpy(img)[None])[0]
    np.testing.assert_allclose(got.numpy(), _jax_features(jmodel, params, img),
                               rtol=0, atol=FEATURE_ATOL)


def test_converter_and_models_reject_bad_input(shipped):
    _, fast_params, _ = shipped["fast"]
    with pytest.raises(ValueError):
        tmccnn.from_flax_params(fast_params, "accurate")
    with pytest.raises(ValueError):
        tmccnn.make_model("medium")
    with pytest.raises(ValueError):
        tmccnn.MCCNNFeatures(kernel=5)


def test_load_state_dict_refreshes_taps(shipped):
    model = tmccnn.make_model("fast")
    model.load_state_dict(shipped["fast"][2].state_dict())
    for i in range(model.num_layers):
        assert torch.equal(getattr(model, f"layout{i}"),
                           K.mccnn_weight_layout(model.weights[i]))


def test_port_mccnn_imports_no_jax():
    code = (
        "import sys, numpy as np, torch\n"
        "from stereo_match_tpu_torch.config import DisparityConfig\n"
        "from stereo_match_tpu_torch.costs import MCCNNCost\n"
        "from stereo_match_tpu_torch.data.costbin import "
        "external_volume_to_disparity\n"
        "from stereo_match_tpu_torch.models.mccnn import (from_flax_params, "
        "load_default_params)\n"
        "from stereo_match_tpu_torch.pipeline.stereo import StereoMatcher\n"
        "model = from_flax_params(load_default_params('fast'), 'fast')\n"
        "cfg = DisparityConfig(num_disparities=16, cost='mccnn', wls=False)\n"
        "rng = np.random.default_rng(0)\n"
        "l, r = rng.uniform(0, 255, (2, 10, 40)).astype(np.float32)\n"
        "raw, _ = StereoMatcher(cfg, cost_fn=MCCNNCost(model, cfg), "
        "device='cpu')(l, r)\n"
        "assert raw.shape == (10, 40)\n"
        "got = external_volume_to_disparity(rng.uniform(0, 24, (16, 10, 40)), "
        "device='cpu')\n"
        "assert got.shape == (10, 40)\n"
        "for name in ('jax', 'flax', 'optax'):\n"
        "    assert name not in sys.modules, name\n"
        "ref = [m for m in sys.modules if m == 'stereo_match_tpu' or "
        "m.startswith('stereo_match_tpu.')]\n"
        "assert not ref, ref\n"
        "print('ok')\n")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# ------------------------------------------------------ image, features ----

def test_normalize_image_matches_jax():
    img = _images(37, 91, seed=2)[0]
    np.testing.assert_allclose(tmccnn.normalize_image(torch.from_numpy(img)),
                               np.asarray(jmccnn.normalize_image(img)),
                               rtol=1e-6, atol=1e-6)
    # the population std (ddof=0), not torch.std's default correction=1
    two = tmccnn.normalize_image(torch.tensor([[0.0, 2.0]]))
    np.testing.assert_allclose(two.numpy(), [[-1.0, 1.0]], rtol=1e-5)


@pytest.mark.parametrize("shape", [(33, 70), (40, 150)])
@pytest.mark.parametrize("arch", ARCHS)
def test_features_match_flax(shipped, arch, shape):
    jmodel, params, model = shipped[arch]
    left, right = _images(*shape, seed=3)
    norm = [np.asarray(jmccnn.normalize_image(im)) for im in (left, right)]
    got = model(torch.from_numpy(np.stack(norm)))
    assert got.shape == (2, model.features, *shape)
    for v in range(2):
        np.testing.assert_allclose(got[v].numpy(),
                                   _jax_features(jmodel, params, norm[v]),
                                   rtol=0, atol=FEATURE_ATOL)


# ---------------------------------------------------------------- volume ----

@pytest.mark.parametrize("D", [32, 48])
@pytest.mark.parametrize("min_d", [0, 4])
def test_cost_volume_matches_jax(shipped, min_d, D):
    jmodel, params, model = shipped["fast"]
    left, right = _images(20, 90, seed=4)
    want = np.asarray(jmccnn.mccnn_cost_volume(
        jmodel, params, jnp.asarray(left), jnp.asarray(right), D, min_d,
        use_bf16=False))
    got = tmccnn.mccnn_cost_volume(model, torch.from_numpy(left),
                                   torch.from_numpy(right), D, min_d)
    assert got.shape == (D, 20, 90) and got.dtype == torch.float32
    invalid = want == 1e4
    np.testing.assert_array_equal(got.numpy() == 1e4, invalid)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=VOLUME_ATOL)


def test_cost_volume_matches_pallas_interpret(shipped):
    """The fused TPU tower + Gram-band volume (interpret mode, float32) and
    the VPU volume kernel at min_d 4, both against the port."""
    jmodel, params, model = shipped["fast"]
    H, W, D = 34, 150, 128
    left, right = _images(H, W, seed=5)
    fused = np.asarray(jmccnn.mccnn_cost_volume_fused(
        jmodel, params, jnp.asarray(left), jnp.asarray(right), D,
        compute_dtype=jnp.float32, interpret=True))
    got = tmccnn.mccnn_cost_volume(model, torch.from_numpy(left),
                                   torch.from_numpy(right), D)
    np.testing.assert_allclose(got.numpy(), fused, rtol=0, atol=VOLUME_ATOL)

    fl, fr = (_jax_features(jmodel, params,
                            np.asarray(jmccnn.normalize_image(im)))
              for im in (left, right))
    want = np.asarray(mccnn_volume_pallas(jnp.asarray(fl), jnp.asarray(fr),
                                          D, 4, interpret=True))
    got = K.mccnn_volume(torch.from_numpy(fl), torch.from_numpy(fr), D, 4)
    np.testing.assert_array_equal(got.numpy() == 1e4, want == 1e4)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=VOLUME_ATOL)


def test_volume_plain_masks_whole_rows_when_narrower_than_d():
    rng = np.random.default_rng(6)
    fl, fr = (torch.from_numpy(rng.normal(size=(8, 5, 20)).astype(np.float32))
              for _ in range(2))
    vol = K.mccnn_volume(fl, fr, 32, 3)
    for i in range(32):
        d = 3 + i
        assert bool((vol[i, :, :min(d, 20)] == 1e4).all())
        assert not bool((vol[i, :, d:] == 1e4).any())
    direct = 24.0 * (1.0 - (fl[:, :, 10] * fr[:, :, 10 - 7]).sum(0)) * 0.5
    np.testing.assert_allclose(vol[4, :, 10], direct, rtol=1e-6)


def test_kernel_wrappers_reject_bad_input():
    x = torch.zeros(2, 1, 6, 9)
    w, b = torch.zeros(16, 1, 3, 3), torch.zeros(16)
    with pytest.raises(ValueError):
        K.mccnn_conv3x3(x.double(), w, b, True, False)
    with pytest.raises(ValueError):
        K.mccnn_conv3x3(x.transpose(2, 3), w, b, True, False)
    with pytest.raises(ValueError):
        K.mccnn_conv3x3(x, torch.zeros(16, 2, 3, 3), b, True, False)
    # wider than K8 takes: the plain layer runs on the CPU; K8's copy of
    # the weights cannot be made (the card raises, test_torch_cuda.py)
    wide = K.mccnn_conv3x3(x, torch.zeros(130, 1, 3, 3), torch.zeros(130),
                           True, False)
    assert wide.shape == (2, 130, 6, 9) and not wide.any()
    with pytest.raises(ValueError, match="128"):
        K.mccnn_weight_layout(torch.zeros(130, 1, 3, 3))
    with pytest.raises(ValueError):
        K.mccnn_conv3x3(x, w, b, True, False,
                        layout=torch.zeros(3, 3, 16, 1))
    f = torch.zeros(4, 6, 9)
    with pytest.raises(ValueError):
        K.mccnn_volume(f, f, 8, -1)
    with pytest.raises(ValueError):
        K.mccnn_volume(f, torch.zeros(4, 6, 10), 8)
    with pytest.raises(ValueError):
        K.mccnn_volume(f, f.transpose(1, 2).contiguous().transpose(1, 2), 8)


# ------------------------------------------------------------ the slice ----

def test_slice_matches_jax(shipped):
    """The port's SGM + WTA on JAX's own MC-CNN volume equal JAX's MC-CNN
    matcher; the port's own volume agrees on >= 99.5 % of the pixels."""
    jmodel, params, model = shipped["fast"]
    gt = tsynthetic.slanted_scene(48, 160, 2.0, 24.0)
    left, right = tsynthetic.random_dot_pair(48, 160, gt, blur=1.0, seed=1)
    cfg = DisparityConfig(num_disparities=32, cost="mccnn", **HEADLINE)
    provider = JaxMCCNNCost(jmodel, params, cfg)
    want, _ = jstereo.StereoMatcher(cfg, cost_fn=provider)(left, right)
    want = np.asarray(want)
    # jitted, as inside JAX's matcher: the eager volume differs by ulps
    jit_volume = jax.jit(lambda l, r: provider(l, r))
    jvol = np.array(jit_volume(jnp.asarray(left), jnp.asarray(right)))
    on_jax_volume, _ = tstereo.StereoMatcher(
        cfg, cost_fn=lambda l, r: torch.from_numpy(jvol),
        device="cpu")(left, right)
    _assert_same_disparity(on_jax_volume, want)

    own, _ = tstereo.StereoMatcher(
        cfg, cost_fn=tcosts.MCCNNCost(model, cfg), device="cpu")(left, right)
    share = _agreement(own.numpy(), want)
    print(f"port's own MC-CNN volume: {share} of the pixels agree with JAX "
          "(same NaN state, |diff| <= 0.01)")
    assert share >= 0.995, share


@pytest.mark.parametrize("arch", ARCHS)
def test_shipped_checkpoint_beats_census(shipped, arch):
    """The port of the JAX package's test: the shipped checkpoint ties
    census on a clean held-out scene and beats it under noise."""
    model = shipped[arch][2]
    cfg_c = DisparityConfig(num_disparities=32, cost="census", **HEADLINE)
    cfg_m = cfg_c.replace(cost="mccnn")
    m_census = tstereo.StereoMatcher(cfg_c, device="cpu")
    m_mccnn = tstereo.StereoMatcher(cfg_m,
                                    cost_fn=tcosts.MCCNNCost(model, cfg_m),
                                    device="cpu")
    gt = tsynthetic.rough_scene(96, 160, 999, 2, 24)
    results = {}
    for noise in (0.0, 25.0):
        left, right = tsynthetic.random_dot_pair(96, 160, gt, blur=1.0,
                                                 seed=555, noise=noise)
        dc, _ = m_census(left, right)
        dm, _ = m_mccnn(left, right)
        results[noise] = (float(bad_pixel_rate(dc, gt, 3.0, 0.0)),
                          float(bad_pixel_rate(dm, gt, 3.0, 0.0)))
    clean_c, clean_m = results[0.0]
    noisy_c, noisy_m = results[25.0]
    assert clean_m <= clean_c + 0.03, results
    assert noisy_m < noisy_c, results
    assert noisy_m < 0.25, results


def test_make_cost_provider(shipped):
    model = shipped["fast"][2]
    cfg = DisparityConfig(num_disparities=16, cost="census", **HEADLINE)
    assert isinstance(tcosts.make_cost_provider(cfg), tcosts.ClassicCost)
    mc = tcosts.make_cost_provider(cfg.replace(cost="mccnn"), model)
    assert isinstance(mc, tcosts.MCCNNCost) and mc.scale == 24.0
    left, right = (torch.from_numpy(im) for im in _images(10, 40, seed=8))
    census, _ = tstereo.StereoMatcher(
        cfg, cost_fn=tcosts.ClassicCost(cfg), device="cpu")(left, right)
    plain, _ = tstereo.StereoMatcher(cfg, device="cpu")(left, right)
    _assert_same_disparity(census, plain, atol=0)
    sad = tcosts.ClassicCost(cfg.replace(cost="sad"))(left, right)
    assert sad.shape == (16, 10, 40) and sad.dtype == torch.float32


def test_classic_cost_is_float32_on_an_int16_config():
    """ClassicCost and make_cost_provider give JAX's float32 volume on an
    int16 config; the matcher takes it as a cost_fn."""
    kw = dict(num_disparities=16, dtype="int16", wls=False,
              speckle_window_size=0)
    cfg, jcfg = DisparityConfig(**kw), jconfig.DisparityConfig(**kw)
    left, right = _images(12, 48, seed=11)
    want = np.asarray(jcosts.make_cost_provider(jcfg)(jnp.asarray(left),
                                                      jnp.asarray(right)))
    for provider in (tcosts.ClassicCost(cfg), tcosts.make_cost_provider(cfg)):
        got = provider(torch.from_numpy(left), torch.from_numpy(right))
        assert got.dtype == torch.float32 and want.dtype == np.float32
        np.testing.assert_array_equal(got.numpy(), want)
    raw, _ = tstereo.StereoMatcher(cfg, cost_fn=tcosts.ClassicCost(cfg),
                                   device="cpu")(left, right)
    assert raw.shape == (12, 48)


def test_mccnn_path_raises_outside_the_slice(shipped):
    model = shipped["fast"][2]
    cfg = DisparityConfig(num_disparities=16, cost="mccnn", **HEADLINE)
    left, right = (torch.from_numpy(im) for im in _images(10, 40, seed=9))
    # bfloat16 is computed (tests/test_torch_mccnn_bf16.py holds it to JAX)
    bf16 = tmccnn.mccnn_cost_volume(model, left, right, 16, use_bf16=True)
    assert bf16.shape == (16, 10, 40) and bf16.dtype == torch.float32
    assert bool(torch.isfinite(bf16).all())
    assert not torch.equal(bf16, tmccnn.mccnn_cost_volume(model, left, right,
                                                          16))
    with pytest.raises(ValueError, match="does not support"):
        tmccnn.mccnn_cost_volume(model, left, right, 16, min_disparity=-2)
    with pytest.raises(ValueError, match="unknown cost family: mccnn"):
        tstereo.StereoMatcher(cfg, device="cpu")
    with pytest.raises(ValueError, match="unknown cost family: mccnn"):
        tstereo._match_core(left, right, cfg)
    with pytest.raises(ValueError):
        tcosts.make_cost_provider(cfg)
    vol = tcosts.MCCNNCost(model, cfg)(left, right)
    for bad, exc in ((vol.double(), ValueError),
                     (vol.to("meta"), ValueError),
                     (vol[:8], ValueError),
                     (vol.transpose(1, 2).contiguous().transpose(1, 2),
                      ValueError),
                     (vol.numpy(), TypeError)):
        with pytest.raises(exc):
            tstereo.StereoMatcher(cfg, cost_fn=lambda l, r: bad,
                                  device="cpu")(left, right)


# --------------------------------------------------- external volumes ----

def test_costbin_round_trip_matches_jax(tmp_path):
    vol = np.random.default_rng(10).normal(size=(12, 7, 19)).astype(
        np.float32)
    ours, theirs = tmp_path / "ours.bin", tmp_path / "theirs.bin"
    tcostbin.write_cost_bin(str(ours), vol)
    jcostbin.write_cost_bin(str(theirs), vol)
    assert ours.read_bytes() == theirs.read_bytes()
    for mmap in (True, False):
        got = tcostbin.read_cost_bin(str(theirs), 12, 19, 7, mmap=mmap)
        np.testing.assert_array_equal(got, vol)
        np.testing.assert_array_equal(
            got, jcostbin.read_cost_bin(str(ours), 12, 19, 7, mmap=mmap))


@pytest.mark.parametrize("with_guide", [False, True])
def test_external_volume_to_disparity_matches_jax(shipped, with_guide):
    jmodel, params, _ = shipped["fast"]
    gt = tsynthetic.slanted_scene(24, 96, 2.0, 20.0)
    left, right = tsynthetic.random_dot_pair(24, 96, gt, blur=1.0, seed=12)
    vol = np.asarray(jmccnn.mccnn_cost_volume(
        jmodel, params, jnp.asarray(left), jnp.asarray(right), 32,
        use_bf16=False))
    guide = left if with_guide else None
    got = tcostbin.external_volume_to_disparity(vol, guide=guide,
                                                device="cpu")
    want = jcostbin.external_volume_to_disparity(vol, guide=guide)
    assert isinstance(got, np.ndarray) and got.shape == (24, 96)
    if with_guide:
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, **FGS_TOL)
    else:
        _assert_same_disparity(got, want)


def test_rough_scene_matches_jax():
    for args in ((96, 160, 999, 2, 24), (50, 70, 3, 1.0, 9.0, 8)):
        np.testing.assert_array_equal(tsynthetic.rough_scene(*args),
                                      jsynthetic.rough_scene(*args))
