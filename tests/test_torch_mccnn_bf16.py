"""The port's bfloat16 MC-CNN tower against the JAX package, on the CPU.

flax's ``MCCNNFeatures(compute_dtype=jnp.bfloat16)`` rounds each layer's
input and weights to bfloat16; XLA on a CPU sums their products in float32
and rounds the sum, adds the bfloat16 bias and rounds again. The port's
plain layer (``mccnn_conv3x3_plain(..., bf16=True)``, the CPU side of K8's
bfloat16 mode) does the same, but sums in another order, and a sum on a
rounding boundary then rounds to the other neighbour; that flip carries
through the later layers. A narrow, shallow tower (16 features, 2 layers)
has few such flips: the last layer's values before the norm, where the
flips live, must be bit-equal to flax's on 95 % of them, and the unit
features within 2.4e-7 (2 float32 ulps; the norm's float32 sum of squares
runs in an order of the CPU's choosing, in the port as in XLA), limits
that the float32 tower (5e-3 off, none bit-equal) fails. The fast tower's
flips carry through 4 layers of 576 products, so its features are held to
JAX's own bfloat16 contract (``models/mccnn.py``: "good to ~1e-2"), 1e-2,
with half of the values before the norm bit-equal (float32: none); the
cost, 24 / 2 times a dot product of two such features,
within 24 x 1e-2; the invalid (1e4) cells exactly. One layer on inputs
whose float32 sums are exact in any order must equal the step-by-step
rounding bit for bit.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stereo_match_tpu.pipeline.stereo as jstereo
from stereo_match_tpu.costs import MCCNNCost as JaxMCCNNCost
from stereo_match_tpu.models import mccnn as jmccnn
from stereo_match_tpu_torch import costs as tcosts
from stereo_match_tpu_torch.config import DisparityConfig
from stereo_match_tpu_torch.data import synthetic as tsynthetic
from stereo_match_tpu_torch.models import mccnn as tmccnn
from stereo_match_tpu_torch.ops import cuda_kernels as K
from stereo_match_tpu_torch.pipeline import stereo as tstereo

BF16_FEATURE_ATOL = 1e-2    # JAX's bfloat16 contract on the unit features
# (F, L, key) -> the unit features' limit against flax's, the least share
# of the last layer's values before the norm bit-equal to flax's
BF16_TOWERS = {(16, 2, 3): (2.4e-7, 0.95),
               (64, 4, 5): (BF16_FEATURE_ATOL, 0.5)}
BF16_COST_ATOL = 0.25       # scale 24 times the features' 1e-2
FLOAT32_COST_ATOL = 1e-4    # as tests/test_torch_mccnn.py
HEADLINE = dict(uniqueness_ratio=15, disp12_max_diff=1, wls=False,
                speckle_window_size=0)


def _bf16(a):
    """numpy float32 -> nearest bfloat16 as float32 (ml_dtypes, the type
    JAX rounds with): a rounding independent of torch's."""
    return np.asarray(a, np.float32).astype(jnp.bfloat16).astype(np.float32)


def _flax(F, L, key):
    """A flax tower's parameters as numpy, and the port's bfloat16 model
    on the same weights."""
    params = jmccnn.init_params(jmccnn.MCCNNFeatures(features=F,
                                                    num_layers=L),
                                jax.random.PRNGKey(key))
    params = jax.tree_util.tree_map(np.asarray, params)
    return params, tmccnn.from_flax_params(params, (F, L),
                                           compute_dtype=torch.bfloat16)


def _images(H, W, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 255, (2, H, W)).astype(np.float32)


@pytest.fixture(scope="module")
def fast():
    """The shipped fast checkpoint: numpy params, the port's float32 and
    bfloat16 models."""
    params = tmccnn.load_default_params("fast")
    return (params, tmccnn.from_flax_params(params, "fast"),
            tmccnn.from_flax_params(params, "fast", torch.bfloat16))


def _flax_pre_norm(params, F, L, img, dtype):
    """flax's tower on one normalized (H, W) image up to the last layer's
    output before the norm, as ``MCCNNFeatures.__call__`` applies its
    ``conv{i}`` layers: (F, H, W) float32 numpy."""
    x = jnp.asarray(img)[None, ..., None].astype(dtype)
    for i in range(L):
        x = nn.Conv(F, (3, 3), padding="SAME", dtype=dtype).apply(
            {"params": params["params"][f"conv{i}"]}, x)
        if i < L - 1:
            x = nn.relu(x)
    return np.moveaxis(np.asarray(x.astype(jnp.float32))[0], -1, 0)


def _pre_norm(model, x):
    """The port's tower (K8's layers, their plain versions on the CPU) on
    (V, H, W) images up to the last layer's output before the norm:
    (V, F, H, W) float32."""
    bf16 = model.compute_dtype == torch.bfloat16
    h = x[:, None].contiguous()
    for i in range(model.num_layers):
        last = i == model.num_layers - 1
        h = K.mccnn_conv3x3(h, model.weights[i], model.biases[i],
                            relu=not last, normalize=False,
                            layout=getattr(model, f"layout{i}"), bf16=bf16,
                            bf16_out=bf16 and not last)
    return h


@pytest.mark.parametrize("F,L,key", list(BF16_TOWERS))
def test_bf16_features_match_flax(F, L, key):
    """The last layer's values before the norm hold the bfloat16 rounding
    flips, so the bit-equal share is taken there; the unit features, whose
    float32 sum of squares runs in an order of the CPU's choosing, are held
    within ``BF16_TOWERS``' limit of flax's."""
    atol, share = BF16_TOWERS[F, L, key]
    params, model = _flax(F, L, key)
    assert model.compute_dtype == torch.bfloat16
    assert all(w.dtype == torch.float32 for w in model.weights)
    jmodel = jmccnn.MCCNNFeatures(features=F, num_layers=L,
                                  compute_dtype=jnp.bfloat16)
    norm = np.stack([np.asarray(jmccnn.normalize_image(im))
                     for im in _images(24, 64, seed=key)])
    got = model(torch.from_numpy(norm))
    assert got.dtype == torch.float32 and got.shape == (2, F, 24, 64)
    pre = _pre_norm(model, torch.from_numpy(norm))
    f32 = tmccnn.from_flax_params(params, (F, L))
    got32 = f32(torch.from_numpy(norm))
    pre32 = _pre_norm(f32, torch.from_numpy(norm))
    for v in range(2):
        want = np.asarray(jmodel.apply(params, jnp.asarray(norm[v])[None, ...,
                                                                    None]))
        want = np.moveaxis(want[0], -1, 0)
        want_pre = _flax_pre_norm(params, F, L, norm[v], jnp.bfloat16)
        err = float(np.abs(got[v].numpy() - want).max())
        equal = float(np.mean(pre[v].numpy() == want_pre))
        err32 = float(np.abs(got32[v].numpy() - want).max())
        equal32 = float(np.mean(pre32[v].numpy() == want_pre))
        print(f"F={F} L={L} view {v}: max |port - flax| = {err}; before "
              f"the norm {equal} bit-equal; float32 tower {err32}, "
              f"{equal32} bit-equal before the norm")
        assert err <= atol and equal >= share
        # the limits tell bfloat16 from float32: the share at every size,
        # the features' limit too where it is tighter than JAX's contract
        assert equal32 < share
        if atol < BF16_FEATURE_ATOL:
            assert err32 > atol
    # the float32 model's bfloat16 twin computes the same
    assert torch.equal(f32.bf16_twin()(torch.from_numpy(norm)), got)


@pytest.mark.parametrize("model_dtype,use_bf16", [("float32", True),
                                                  ("bfloat16", None),
                                                  ("bfloat16", True)])
def test_bf16_cost_volume_matches_jax(fast, model_dtype, use_bf16):
    """``use_bf16=True`` forces bfloat16; a bfloat16 model keeps it under
    None (the JAX package off the TPU)."""
    params, model32, model16 = fast
    model = model16 if model_dtype == "bfloat16" else model32
    jmodel = jmccnn.MCCNNFeatures(compute_dtype=getattr(jnp, model_dtype))
    left, right = _images(20, 64, seed=7)
    D = 16
    want = np.asarray(jmccnn.mccnn_cost_volume(
        jmodel, params, jnp.asarray(left), jnp.asarray(right), D,
        use_bf16=use_bf16))
    got = tmccnn.mccnn_cost_volume(model, torch.from_numpy(left),
                                   torch.from_numpy(right), D,
                                   use_bf16=use_bf16).numpy()
    assert got.shape == (D, 20, 64) and got.dtype == np.float32
    np.testing.assert_array_equal(got == 1e4, want == 1e4)
    err = float(np.abs(got - want).max())
    f32 = tmccnn.mccnn_cost_volume(model32, torch.from_numpy(left),
                                   torch.from_numpy(right), D).numpy()
    print(f"{model_dtype} model, use_bf16={use_bf16}: max |port - JAX| = "
          f"{err}; bfloat16 against float32: {np.abs(got - f32).max()}")
    assert err <= BF16_COST_ATOL
    assert np.abs(got - f32).max() > 0     # it did compute in bfloat16


@pytest.mark.parametrize("model_dtype,use_bf16", [("float32", False),
                                                  ("float32", None),
                                                  ("bfloat16", False)])
def test_use_bf16_false_keeps_the_model_dtype(fast, model_dtype, use_bf16):
    params, model32, model16 = fast
    model = model16 if model_dtype == "bfloat16" else model32
    jmodel = jmccnn.MCCNNFeatures(compute_dtype=getattr(jnp, model_dtype))
    left, right = _images(20, 64, seed=8)
    want = np.asarray(jmccnn.mccnn_cost_volume(
        jmodel, params, jnp.asarray(left), jnp.asarray(right), 16,
        use_bf16=use_bf16))
    got = tmccnn.mccnn_cost_volume(model, torch.from_numpy(left),
                                   torch.from_numpy(right), 16,
                                   use_bf16=use_bf16).numpy()
    np.testing.assert_array_equal(got == 1e4, want == 1e4)
    atol = BF16_COST_ATOL if model_dtype == "bfloat16" else FLOAT32_COST_ATOL
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_bf16_matcher_matches_jax(fast):
    """``StereoMatcher`` with ``MCCNNCost`` on a bfloat16 model against
    JAX's: a cost off by up to 0.25 moves the subpixel fit a little and can
    flip a near-tie, so the disparities valid in both must agree within 0.25
    px on at least 99 % of those pixels."""
    params, _, model16 = fast
    gt = tsynthetic.slanted_scene(48, 160, 2.0, 24.0)
    left, right = tsynthetic.random_dot_pair(48, 160, gt, blur=1.0, seed=1)
    cfg = DisparityConfig(num_disparities=32, cost="mccnn", **HEADLINE)
    jmodel = jmccnn.MCCNNFeatures(compute_dtype=jnp.bfloat16)
    want, _ = jstereo.StereoMatcher(
        cfg, cost_fn=JaxMCCNNCost(jmodel, params, cfg))(left, right)
    want = np.asarray(want)
    got, _ = tstereo.StereoMatcher(
        cfg, cost_fn=tcosts.MCCNNCost(model16, cfg), device="cpu")(left,
                                                                   right)
    got = got.numpy()
    both = ~np.isnan(got) & ~np.isnan(want)
    share = float(np.mean(np.abs(got[both] - want[both]) <= 0.25))
    print(f"bfloat16 MC-CNN matcher: {both.mean()} of the pixels valid in "
          f"both, {share} of them within 0.25 px of JAX's; valid only in "
          f"one: {float(np.mean(np.isnan(got) != np.isnan(want)))}")
    assert both.mean() >= 0.9
    assert share >= 0.99


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("C_in", [1, 16])
def test_bf16_plain_layer_is_the_stepwise_rounding(C_in, relu):
    """Inputs whose float32 sums are exact in any order (bfloat16 values of
    bounded exponent), perturbed by less than half a bfloat16 ulp in both
    directions, so rounding x and the weights to nearest (not towards
    zero) restores them; against numpy: x, w rounded, the exact sum, rounded,
    plus the rounded bias in float32, rounded, then ReLU."""
    rng = np.random.default_rng(C_in + relu)
    F, H, W = 8, 9, 13
    xm = rng.integers(-255, 256, (2, C_in, H, W))
    wm = rng.integers(-255, 256, (F, C_in, 3, 3))
    x_exact = (xm * 2.0 ** -4).astype(np.float32)
    w_exact = (wm * 2.0 ** -8).astype(np.float32)

    def nudge(a):      # < half an ulp either side, zeros kept
        ulp = 2.0 ** (np.ceil(np.log2(np.maximum(np.abs(a), 1e-30))) - 8)
        step = rng.uniform(-0.45, 0.45, a.shape) * ulp
        return np.where(a == 0, a, a + step).astype(np.float32)

    x, w = nudge(x_exact), nudge(w_exact)
    assert np.all(_bf16(x) == x_exact) and np.all(_bf16(w) == w_exact)
    assert np.any(x != x_exact) and np.any(w != w_exact)
    b = rng.normal(0, 3.0, F).astype(np.float32)
    xp = np.pad(x_exact.astype(np.float64), ((0, 0), (0, 0), (1, 1), (1, 1)))
    total = np.zeros((2, F, H, W))
    for ky in range(3):
        for kx in range(3):
            total += np.einsum("vchw,fc->vfhw", xp[:, :, ky:ky + H, kx:kx + W],
                               w_exact[:, :, ky, kx].astype(np.float64))
    assert np.all(total.astype(np.float32) == total)     # exact in float32
    want = _bf16(_bf16(total) + _bf16(b)[:, None, None])
    if relu:
        want = np.maximum(want, 0)
    got = K.mccnn_conv3x3_plain(torch.from_numpy(x), torch.from_numpy(w),
                                torch.from_numpy(b), relu, False, bf16=True)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(_bf16(total), total)    # the rounding bites


def test_bf16_layouts_and_wrapper(fast):
    """A bfloat16 model keeps bfloat16 copies of its weights for K8: the
    first layer's (3, 3, 1, F) taps rounded, the others the bfloat16
    (9, F8, C16) taps; the wrapper refuses a float32 layout in the bfloat16
    mode; the module refuses a third dtype."""
    _, model32, model16 = fast
    w0, w1 = model16.weights[0], model16.weights[1]
    assert torch.equal(model16.layout0, K.conv_taps(K.bf16_round(w0)))
    assert model16.layout1.shape == (9, 64, 64)
    assert model16.layout1.dtype == torch.bfloat16
    assert torch.equal(model16.layout1.float(),
                       K.bf16_round(K.conv_taps(w1)).reshape(9, 64, 64)
                       .transpose(1, 2))
    assert model32.layout1.shape == (2, 3, 3, 64, 64)
    x = torch.zeros(2, 64, 5, 7)
    with pytest.raises(ValueError, match="layout"):
        K.mccnn_conv3x3(x, w1, model16.biases[1], True, False,
                        layout=model32.layout1, bf16=True)
    y = K.mccnn_conv3x3(x, w1, model16.biases[1], True, False,
                        layout=model16.layout1, bf16=True)
    assert torch.equal(y, K.mccnn_conv3x3_plain(x, w1, model16.biases[1],
                                                True, False, bf16=True))
    with pytest.raises(ValueError, match="compute_dtype"):
        tmccnn.MCCNNFeatures(compute_dtype=torch.float16)
    with pytest.raises(ValueError, match="compute_dtype"):
        tmccnn.make_model("fast", torch.float16)


def test_bf16_twin_shares_the_weights(fast):
    """``bf16_twin``: a bfloat16 model is its own; a float32 model's twin
    shares its parameters, keeps bfloat16 copies for K8, is made once, stays
    out of the state dict, and is made anew when the weights are set."""
    params, _, model16 = fast
    model = tmccnn.from_flax_params(params, "fast")
    assert model16.bf16_twin() is model16
    twin = model.bf16_twin()
    assert twin is model.bf16_twin()
    assert twin.compute_dtype == torch.bfloat16
    assert twin.weights is model.weights and twin.biases is model.biases
    assert torch.equal(twin.layout1, model16.layout1)
    assert model.state_dict().keys() == model16.state_dict().keys()
    state = {k: v.clone() for k, v in model.state_dict().items()}
    state["biases.0"] += 1.0
    model.load_state_dict(state)
    again = model.bf16_twin()
    assert again is not twin and torch.equal(again.biases[0],
                                             state["biases.0"])
