"""The port's monodepth inference against the JAX package, on the CPU.

The same numpy inputs go through flax and the port, with the weights
carried across by ``from_flax_params``. Outputs are width fractions in
[0, 0.3]: every scale must agree within 1e-6 of a width fraction, and
``predict_disparity`` within 1e-6 * W px (the two sum the convolutions in
other orders; flax on XLA's CPU is float32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_match_tpu.data.raytrace import render_stereo
from stereo_match_tpu.models import monodepth as jmd
from stereo_match_tpu_torch.data import raytrace as traytrace
from stereo_match_tpu_torch.models import monodepth as tmd

FRAC_TOL = 1e-6


@pytest.fixture(scope="module")
def shipped():
    """(flax model, flax params, port model) of the shipped checkpoint."""
    model, params = jmd.load_default()
    return model, params, tmd.load_default(device="cpu")


@pytest.fixture(scope="module")
def full():
    """The full arch with flax-initialised weights, in both packages."""
    model = jmd.make_model("full")
    params = jmd.init_params(model, jax.random.PRNGKey(3), (1, 32, 48, 3))
    return model, params, tmd.from_flax_params(params)


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize("arch", ["small", "full"])
def test_every_scale_matches_flax(arch, shipped, full):
    model, params, tmodel = shipped if arch == "small" else full
    x = np.random.default_rng(0).uniform(0, 1, (2, 32, 48, 3)).astype(
        np.float32)
    want = model.apply(params, jnp.asarray(x))
    got = tmodel(_nchw(x))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.permute(0, 2, 3, 1).shape == w.shape
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), w,
                                   rtol=0, atol=FRAC_TOL)
        assert float(g.max()) <= 0.3 and float(g.min()) >= 0.0


@pytest.mark.parametrize("shape, internal", [
    ((40, 64), (96, 160)),       # upsized to the network's size
    ((375, 1242), (96, 160)),    # downsized (antialiased), KITTI width
    ((45, 70), None),            # native, padded at odd sizes
    ((375, 1242), None),         # native, padded to 384 x 1248
])
def test_predict_disparity_matches_flax(shape, internal, shipped):
    model, params, tmodel = shipped
    img = np.random.default_rng(1).integers(0, 255, (*shape, 3), np.uint8)
    want = jmd.predict_disparity(model, params, img, internal)
    got = tmd.predict_disparity(tmodel, img, internal)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert got.shape == shape and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=FRAC_TOL * shape[1])


def test_full_arch_predicts_like_flax(full):
    model, params, tmodel = full
    img = np.random.default_rng(2).uniform(0, 1, (45, 70, 3))
    for internal in ((32, 48), None):
        want = jmd.predict_disparity(model, params, img, internal)
        got = tmd.predict_disparity(tmodel, img, internal).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=FRAC_TOL * 70)


def test_shipped_checkpoint_on_raytraced_scenes(shipped):
    """The scenes and bar of the JAX package's
    ``test_shipped_checkpoint_predicts_depth``, on the port's own output:
    the port's renders equal the JAX package's, its prediction agrees with
    flax's within 1e-6 * W px, correlates with GT, and after an affine fit
    beats the best constant predictor."""
    model, params, tmodel = shipped
    corrs, cal_epe, const_epe = [], [], []
    for s in (900, 904, 905, 909):
        l, _, gt = traytrace.render_stereo(96, 160, seed=s)
        jl, _, jgt = render_stereo(96, 160, seed=s)
        np.testing.assert_array_equal(l, jl)
        np.testing.assert_array_equal(gt, jgt)
        img = np.repeat(l[..., None], 3, -1)
        pred = tmd.predict_disparity(tmodel, img).numpy()
        np.testing.assert_allclose(
            pred, jmd.predict_disparity(model, params, img), rtol=0,
            atol=FRAC_TOL * 160)
        m = np.isfinite(gt)
        corrs.append(float(np.corrcoef(pred[m], gt[m])[0, 1]))
        a, b = np.polyfit(pred[m], gt[m], 1)
        cal_epe.append(float(np.mean(np.abs(a * pred[m] + b - gt[m]))))
        const_epe.append(float(np.mean(np.abs(np.median(gt[m]) - gt[m]))))
    assert np.mean(corrs) > 0.6, corrs
    assert np.mean(cal_epe) < 0.6 * np.mean(const_epe), (cal_epe, const_epe)


@pytest.mark.parametrize("arch", ["small", "full"])
def test_infer_arch_roundtrip(arch):
    params = jmd.init_params(jmd.make_model(arch), jax.random.PRNGKey(0))
    assert tmd.infer_arch(params) == jmd.infer_arch(params) == arch
    model = tmd.from_flax_params(params)
    assert model.encoder_features == tmd.ARCHS[arch]
    np_params = jax.tree_util.tree_map(np.asarray, params)
    assert tmd.infer_arch(np_params) == arch


def test_converter_rejects_a_wrong_arch(shipped):
    _, params, _ = shipped
    with pytest.raises(ValueError, match="arch 'full'"):
        tmd.from_flax_params(params, "full")
    tree = dict(params["params"])
    del tree["ConvBlock_11"]
    with pytest.raises(ValueError, match="ConvBlock_0..11"):
        tmd.from_flax_params({"params": tree}, "small")
    with pytest.raises(ValueError, match="cannot infer"):
        tmd.infer_arch({"params": {"disp0": {}}})
    with pytest.raises(ValueError, match="unknown arch"):
        tmd.make_model("tiny")


def test_block_order_follows_the_integer_suffix():
    assert tmd._block_names({f"ConvBlock_{i}": None for i in (10, 2, 1, 0)}
                            ) == ["ConvBlock_0", "ConvBlock_1", "ConvBlock_2",
                                  "ConvBlock_10"]


@pytest.mark.parametrize("n, stride, pads", [
    (48, 2, (0, 1)), (47, 2, (1, 1)), (48, 1, (1, 1)), (1, 2, (1, 1)),
])
def test_same_pads_are_flax_pads(n, stride, pads):
    assert tmd.same_pads(n, 3, stride) == pads
    x = np.random.default_rng(n).normal(size=(1, n, 5, 2)).astype(np.float32)
    k = np.random.default_rng(1).normal(size=(3, 3, 2, 4)).astype(np.float32)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k), (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    conv = torch.nn.Conv2d(2, 4, 3, stride=stride, padding=0, bias=False)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(k).permute(3, 2, 0, 1))
        got = tmd.conv_same(conv, _nchw(x)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_random_init_is_seeded():
    a, b, c = tmd.make_model("small", 0), tmd.make_model("small", 0), \
        tmd.make_model("small", 1)
    for pa, pb, pc in zip(a.parameters(), b.parameters(), c.parameters()):
        assert torch.equal(pa, pb)
    assert not torch.equal(a.blocks[0].conv.weight, c.blocks[0].conv.weight)
    assert float(a.blocks[0].conv.bias.abs().max()) == 0.0


def test_scales_float_and_uint8_alike(shipped):
    """Input above 1.5 is divided by 255, as in the JAX package."""
    _, _, tmodel = shipped
    img = np.random.default_rng(3).integers(0, 255, (32, 48, 3), np.uint8)
    a = tmd.predict_disparity(tmodel, img, None)
    b = tmd.predict_disparity(tmodel, img.astype(np.float32) / 255.0, None)
    torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
