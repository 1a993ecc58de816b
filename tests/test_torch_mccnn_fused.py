"""The port's one-kernel MC-CNN path against the JAX package, on the CPU.

``models/mccnn.py::mccnn_cost_volume_fused`` runs the tower's layers but
the last on K8 and then K11 (``mccnn_fused_volume``: the last layer, its
norm and the Gram band in one launch); on the CPU both run their plain
versions, so ``single_kernel=True`` must equal ``single_kernel=False``
(K8 for every layer, then K9) bit for bit, in float32 and bfloat16. The
same numpy images go through JAX's ``mccnn_cost_volume_fused`` (its Pallas
kernel in interpret mode, float32) and the port's: within 1e-4 (the
volume tolerance of ``tests/test_torch_mccnn.py``) with the 1e4 mask
equal, on the shipped fast and accurate checkpoints. In bfloat16 the
Pallas tower is not flax's, so the port is held to JAX's XLA path with
``use_bf16=True`` within 0.25 (``tests/test_torch_mccnn_bf16.py``). K11's
walk of the frame is modelled in numpy (``mccnn_fused_volume_tiled_plain``:
its staging, fragment, shared-memory and store maps) and must give the
plain version's volume bit for bit at an odd width, a height of a few rows
(a block's row band is one row) and one and two chunks of 128 planes, on
inputs whose layer sums are exact in any order. ``mccnn_cost_volume``
takes the one-kernel path only on the card and only under JAX's conditions,
which the launch counters show with the card's predicate forced on the CPU.
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_match_tpu.models import mccnn as jmccnn
from stereo_match_tpu_torch.models import mccnn as tmccnn
from stereo_match_tpu_torch.ops import cuda_kernels as K

ARCHS = ("fast", "accurate")
H, W, D = 34, 150, 128
VOLUME_ATOL = 1e-4          # as tests/test_torch_mccnn.py
BF16_COST_ATOL = 0.25       # as tests/test_torch_mccnn_bf16.py


@pytest.fixture(scope="module")
def shipped():
    """arch -> (JAX model, params, the port's float32 and bfloat16
    models), and the images."""
    out = {}
    for arch in ARCHS:
        params = jmccnn.load_default_params(arch)
        out[arch] = (jmccnn.make_model(arch), params,
                     tmccnn.from_flax_params(params, arch),
                     tmccnn.from_flax_params(params, arch, torch.bfloat16))
    rng = np.random.default_rng(5)
    left, right = rng.uniform(0, 255, (2, H, W)).astype(np.float32)
    return out, left, right


def _fused(model, left, right, dtype, single_kernel=True, D=D):
    return tmccnn.mccnn_cost_volume_fused(
        model, torch.from_numpy(left), torch.from_numpy(right), D,
        compute_dtype=dtype, single_kernel=single_kernel)


@pytest.mark.parametrize("arch", ARCHS)
def test_fused_matches_pallas_interpret(shipped, arch):
    models, left, right = shipped
    jmodel, params, model, _ = models[arch]
    want = np.asarray(jmccnn.mccnn_cost_volume_fused(
        jmodel, params, jnp.asarray(left), jnp.asarray(right), D,
        compute_dtype=jnp.float32, interpret=True))
    got = _fused(model, left, right, torch.float32)
    assert got.shape == (D, H, W) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy() == 1e4, want == 1e4)
    err = float(np.abs(got.numpy() - want).max())
    print(f"{arch}: max |port fused - JAX fused (interpret)| = {err}")
    assert err <= VOLUME_ATOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", ARCHS)
def test_single_kernel_bit_equal_to_two_kernels(shipped, arch, dtype):
    """Either model dtype, either compute dtype: the model itself or its
    twin computes, and the two paths agree bit for bit."""
    models, left, right = shipped
    for model in models[arch][2:]:
        one = _fused(model, left, right, dtype)
        two = _fused(model, left, right, dtype, single_kernel=False)
        assert torch.equal(one, two)
    twin = models[arch][2].twin(dtype)
    assert twin.compute_dtype == dtype and twin.weights is \
        models[arch][2].weights
    assert torch.equal(one, _fused(twin, left, right, dtype))


def test_bf16_fused_matches_xla(shipped):
    models, left, right = shipped
    jmodel, params, _, model16 = models["fast"]
    want = np.asarray(jmccnn.mccnn_cost_volume(
        jmodel, params, jnp.asarray(left), jnp.asarray(right), D,
        use_bf16=True))
    got = _fused(model16, left, right, torch.bfloat16).numpy()
    np.testing.assert_array_equal(got == 1e4, want == 1e4)
    err = float(np.abs(got - want).max())
    f32 = _fused(model16, left, right, torch.float32).numpy()
    print(f"bfloat16: max |port fused - JAX XLA| = {err}; against the "
          f"float32 fused volume {np.abs(got - f32).max()}")
    assert err <= BF16_COST_ATOL
    assert np.abs(got - f32).max() > 0       # it did compute in bfloat16


def test_fused_raises_as_jax(shipped):
    models, left, right = shipped
    jmodel, params, model, _ = models["fast"]
    for bad_d in (64, 130):
        with pytest.raises(ValueError):
            jmccnn.mccnn_cost_volume_fused(
                jmodel, params, jnp.asarray(left), jnp.asarray(right), bad_d,
                compute_dtype=jnp.float32, interpret=True)
        with pytest.raises(ValueError, match="num_disparities"):
            _fused(model, left, right, torch.float32, D=bad_d)
    with pytest.raises(ValueError, match="multiple of 16"):
        _fused(tmccnn.make_model((24, 2), seed=0), left, right,
               torch.float32)
    with pytest.raises(ValueError, match="two layers"):
        _fused(tmccnn.make_model((16, 1), seed=0), left, right,
               torch.float32)
    x = torch.zeros(2, 64, 5, 7)
    w, b = model.weights[1], model.biases[1]
    with pytest.raises(ValueError, match="both views"):
        K.mccnn_fused_volume(x[:1], w, b, D)
    with pytest.raises(ValueError, match="multiple of 128"):
        K.mccnn_fused_volume(x, w, b, 96)
    with pytest.raises(ValueError, match="layout"):
        K.mccnn_fused_volume(x, w, b, D, layout=model.layout0)


def _exact_inputs(F, C, H, W, seed):
    """Inputs whose layer sums and sums of squares are exact in float32 in
    any order: x in {-1, 0, 1}, weights and bias in eighths, |outputs| <
    40."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-1, 2, (2, C, H, W)).astype(np.float32)
    w = (rng.integers(-2, 3, (F, C, 3, 3)) * 0.125).astype(np.float32)
    b = (rng.integers(-4, 5, F) * 0.125).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("F,C,Hs,Ws,Ds,bf16", [
    (32, 16, 5, 151, 128, True), (32, 16, 5, 151, 128, False),
    (112, 16, 3, 151, 128, True), (112, 24, 3, 151, 128, False),
    (32, 16, 3, 300, 256, True), (64, 16, 2, 129, 256, False)])
def test_tiled_model_is_the_plain_version(F, C, Hs, Ws, Ds, bf16):
    """K11's walk (``mccnn_fused_volume_tiled_plain``) against
    ``mccnn_fused_volume_plain`` bit for bit: one or two warps a pixel's
    channels (F 32, 64 against 112), odd widths whose last step is
    partial, D 128 and 256 (two blocks a row, the second's right tiles
    128 columns behind), C_in past one stage."""
    x, w, b = _exact_inputs(F, C, Hs, Ws, F + Ws)
    got = K.mccnn_fused_volume_tiled_plain(x, w, b, Ds, bf16=bf16)
    xt = torch.from_numpy(x)
    if bf16:
        xt = xt.to(torch.bfloat16, memory_format=torch.channels_last)
    want = K.mccnn_fused_volume_plain(xt, torch.from_numpy(w),
                                      torch.from_numpy(b), Ds, bf16=bf16)
    assert got.shape == want.shape == (Ds, Hs, Ws)
    assert torch.equal(got, want)


@pytest.fixture
def counted(monkeypatch):
    """The card's predicate forced on and every wrapper's launch counted
    where it takes its plain version for a CPU tensor."""
    monkeypatch.setattr(tmccnn, "_on_card", lambda t: True)
    on_cpu = K._on_cpu

    def counting(*tensors):
        name = sys._getframe(1).f_code.co_name
        if name in K.launches:
            K.launches[name] += 1
        return on_cpu(*tensors)

    monkeypatch.setattr(K, "_on_cpu", counting)
    return K.launches


@pytest.mark.parametrize("arch,use_bf16", [("fast", None), ("fast", True),
                                           ("accurate", None)])
def test_dispatch_takes_the_fused_path_under_jax_conditions(
        shipped, counted, arch, use_bf16):
    models, left, right = shipped
    model = models[arch][2]
    L = model.num_layers
    lt, rt = torch.from_numpy(left), torch.from_numpy(right)
    cases = {(0, 128): {"mccnn_conv3x3": L - 1, "mccnn_fused_volume": 1},
             (4, 128): {"mccnn_conv3x3": L, "mccnn_volume": 1},
             (0, 64): {"mccnn_conv3x3": L, "mccnn_volume": 1}}
    for (min_d, Dc), want in cases.items():
        K.reset_launches()
        got = tmccnn.mccnn_cost_volume(model, lt, rt, Dc, min_d,
                                       use_bf16=use_bf16)
        counts = {k: v for k, v in counted.items() if v}
        assert counts == want, (min_d, Dc, counts)
        tower = model.bf16_twin() if use_bf16 else model
        feats = tower(torch.stack([tmccnn.normalize_image(lt),
                                   tmccnn.normalize_image(rt)]))
        assert torch.equal(got, K.mccnn_volume_plain(feats[0], feats[1], Dc,
                                                     min_d))
    # towers K11 does not take stay on K8 then K9: F not a multiple of
    # 16, one layer
    for shape in ((24, 3), (16, 1)):
        K.reset_launches()
        tmccnn.mccnn_cost_volume(tmccnn.make_model(shape, seed=1), lt, rt,
                                 128)
        assert counted["mccnn_volume"] == 1
        assert counted["mccnn_fused_volume"] == 0


def test_dispatch_stays_off_the_fused_path_on_the_cpu(shipped):
    models, left, right = shipped
    K.reset_launches()
    tmccnn.mccnn_cost_volume(models["fast"][2], torch.from_numpy(left),
                             torch.from_numpy(right), 128)
    assert not any(K.launches.values())
    assert not tmccnn.fused_path_applies(models["fast"][2], 128, 3)
    assert tmccnn.fused_path_applies(models["accurate"][2], 256, 0)


@pytest.mark.parametrize("arch", ARCHS)
def test_fused_input_is_channels_last_and_jax_towers(shipped, arch):
    """The one-kernel path hands K11 the last layer's input channels-last
    (K8's launch before the last writes it so in float32): the same values
    as the NCHW ``hidden`` and as JAX's tower up to the last layer (flax's
    ``conv{L-2}`` output, captured, after ReLU) within 1e-4 of its
    largest activation (float32 sums in another order); the volume K11's
    path builds from it is held to JAX's fused kernel in interpret mode
    by ``test_fused_matches_pallas_interpret``."""
    models, left, right = shipped
    jmodel, params, model, _ = models[arch]
    imgs = torch.stack([tmccnn.normalize_image(torch.from_numpy(im))
                        for im in (left, right)])
    x = model.hidden(imgs)
    x_cl = model.hidden(imgs, channels_last=True)
    assert x.is_contiguous() and x_cl.is_contiguous(
        memory_format=torch.channels_last)
    assert torch.equal(x_cl, x)
    jimgs = jnp.stack([jmccnn.normalize_image(jnp.asarray(im))
                       for im in (left, right)])[..., None]
    _, state = jmodel.apply(params, jimgs, capture_intermediates=True,
                            mutable=["intermediates"])
    L = model.num_layers
    want = np.maximum(np.asarray(
        state["intermediates"][f"conv{L - 2}"]["__call__"][0]), 0)
    nhwc = x_cl.permute(0, 2, 3, 1)          # channels-last: NHWC in memory
    assert nhwc.is_contiguous()
    err = float(np.abs(nhwc.numpy() - want).max())
    print(f"{arch}: max |port hidden - flax conv{L - 2} + ReLU| = {err} "
          f"(largest activation {float(want.max())})")
    assert err <= 1e-4 * float(want.max())


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("F,C", [(64, 64), (112, 112), (32, 24), (128, 8)])
def test_fused_weight_layout_maps(F, C, bf16):
    """K11's copy of the weights (``mccnn_fused_weight_layout``) holds each
    of K8's entries where the kernel reads it: float32 word (chunk, tap,
    part, q, n, t) is part (hi, lo) of channel 8 chunk + 2t + q of output
    n (the wgmma B operand's core matrices); bfloat16 element 8 (h ^ bit 2
    of n) + i of (chunk, tap, n) is channel 16 chunk + 8h + i. A model
    keeps it (``layout_fused``), K8's copy of the last layer re-laid."""
    w = torch.from_numpy(_exact_inputs(F, C, 1, 1, F + C)[1])
    k8 = K.mccnn_weight_layout(w, bf16)
    got = K.mccnn_fused_weight_layout(w, bf16)
    want, dtype = K._fused_layout_spec(C, F, bf16)
    assert tuple(got.shape) == want and got.dtype == dtype
    if bf16:
        chunk, tap, n = np.meshgrid(*(np.arange(s) for s in got.shape[:3]),
                                    indexing="ij")
        for word in range(16):
            h, i = divmod(word, 8)
            src = k8[tap, n, 16 * chunk + 8 * (h ^ ((n >> 2) & 1)) + i]
            assert torch.equal(got[..., word], src)
    else:
        chunk, tap, part, q, n, t = np.meshgrid(
            *(np.arange(s) for s in got.shape), indexing="ij")
        assert torch.equal(got, k8[part, tap // 3, tap % 3,
                                   8 * chunk + 2 * t + q, n])
    model = tmccnn.make_model((F, 2), torch.bfloat16 if bf16 else
                              torch.float32, seed=F)
    assert torch.equal(model.layout_fused, K.mccnn_fused_weight_layout(
        model.weights[1], bf16))
    assert tmccnn.make_model((F, 1), seed=F).layout_fused is None


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("F", [32, 64, 112, 128])
def test_fused_layout_fits_the_sm(F, bf16):
    """K11's shared memory (``mccnn_fused_layout``) fits a block on the
    H100: the ring (two planes, TF32 hi and lo, up to F8 = 64), the
    partial sums, ST buffers of 1024-B aligned stages
    (each view's box 256-B aligned, the weight rows after them) and the
    tail (the left tile, then the 128-plane volume tile) from buffer 1 on
    where the next step's first stage is prefetched into buffer 0, from
    buffer 0 otherwise (float32 at F8 = 128 only)."""
    lay = K.mccnn_fused_layout(F, bf16)
    assert lay.smem <= K.MCCNN_FUSED_SMEM and lay.ST >= 2
    assert lay.region % 1024 == 0 and lay.stage % 1024 == 0
    assert lay.weights == 2 * 136 * 32 and (136 * 32) % 256 == 0
    assert lay.stage >= lay.weights + 3 * lay.F8 * (32 if bf16 else 64)
    planes = 2 if lay.split else 1
    assert lay.split == (lay.F8 <= 64)
    assert lay.ring == 0 and lay.red == planes * lay.F8 * 256 * 4
    assert lay.region >= lay.red + 2 * 256 * 4
    tail = max(planes * lay.F8 * 128, 128 * 132) * 4
    assert lay.tail == lay.region + (lay.stage if lay.prefetch else 0)
    assert lay.bars >= max(lay.region + lay.ST * lay.stage, lay.tail + tail)
    assert lay.prefetch == (bf16 or lay.F8 < 128)
