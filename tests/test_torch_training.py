"""The port's trainers against the JAX package's, on the CPU.

The same numpy inputs go through JAX (flax, ``jax.value_and_grad``,
optax's Adam) and the port (plain torch under autograd, ``models/optim``),
with flax's initial weights carried across by ``from_flax_params`` (the
two packages draw other random weights). Tolerances:

* the patch miner is numpy in both: bit-equal; the pool's patches come from
  each package's ``normalize_image``, whose float32 reductions run in
  another order: within POOL_TOL of the pool's largest value;
* losses within LOSS_RTOL relative; gradients within GRAD_RTOL of their
  norm (the sums run in another order, float32 in both). The monodepth
  gradients are taken with ATen's convolutions (oneDNN's put this net's
  gradients 2.6e-5 of their norm off JAX's, a float32 order that the
  trainers do not need);
* Adam against optax on the same gradients: within ADAM_RTOL relative
  (a few float32 ulps: the two order the update's operations otherwise)
  and ADAM_TOL absolute;
* the MC-CNN trainer's parameters after five Adam steps within PARAM_TOL,
  its losses along the way within STEP_RTOL;
* the monodepth trainers: the first loss (before any update) within
  LOSS_RTOL, the step count (whole chunks) equal, and for each trainer
  (MONO_BARS) the later losses within its relative bar and its
  displacement of the weights (after - before) within its bar of JAX's,
  in norm. Adam's step is about lr * m / sqrt(v) element by element, so a
  weight whose gradient lies at the float32 rounding level of its sum
  moves by O(lr) in a direction that the rounding picks: after two steps
  at lr 1e-4, about 1000 of the 294912 weights of one decoder layer
  differed by up to 1.4e-4 (of the 2e-4 they moved) with gradients within
  1e-6 of their norm. The readings on torch 2.13's CPU, with 1, 4 or 8
  threads and oneDNN on or off (losses, move): ``train`` 1.8e-6, 1.3e-4;
  ``train_on_device`` 7.6e-5, 9.6e-3; ``train_distilled_on_device``
  1.8e-6, 1.4e-5. Each bar has a control that must miss it: the port's
  trainer with the learning rate 10 % high read 5.7e-3 to 2.2e-2 and 0.096
  to 0.136; the cosine schedule read one count late 5.7e-2 and 0.28. The
  MC-CNN tower's gradients have no such elements at these sizes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stereo_match_tpu.data.synthetic import box_scene, random_dot_pair
from stereo_match_tpu.models import mccnn as jm
from stereo_match_tpu.models import monodepth as jmd
from stereo_match_tpu_torch.models import mccnn as tm
from stereo_match_tpu_torch.models import monodepth as tmd
from stereo_match_tpu_torch.models.optim import (Adam,
                                                 cosine_decay_schedule)

POOL_TOL = 1e-6
LOSS_RTOL = 1e-6
GRAD_RTOL = 1e-5
STEP_RTOL = 1e-5
PARAM_TOL = 1e-5
ADAM_RTOL = 1e-6
ADAM_TOL = 1e-7
# trainer: (the later losses, relative; the weights' move, in norm)
MONO_BARS = {"train": (1e-5, 1e-3), "on_device": (3e-4, 0.03),
             "distilled": (1e-5, 1e-4)}
LR_FAULT = 1.1


@pytest.fixture(scope="module", autouse=True)
def _first_sqrt():
    """torch 2.13's CPU ``sqrt`` can be off by about 1e-3 relative in its
    first multithreaded call of a process (seen after a reduction, 2 runs
    in 30); every later call is exact. Make that call here, before the
    comparisons."""
    a = torch.ones(96, 16, 12, 12)
    torch.sqrt(torch.sum(a * a, 1, keepdim=True) + 1e-12)


def _close_rel(got: float, want: float, rtol: float) -> None:
    assert abs(got - want) <= rtol * abs(want), (got, want)


def _grad_close(got: np.ndarray, want: np.ndarray) -> None:
    scale = max(float(np.linalg.norm(want)), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= GRAD_RTOL * scale, (err, scale)


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _hwio(w: torch.Tensor) -> np.ndarray:
    return w.detach().permute(2, 3, 1, 0).numpy()


# ------------------------------------------------------------- MC-CNN ----

def _scene(h: int, w: int, seed: int):
    gt = box_scene(h, w, 4.0, 10.0)
    left, right = random_dot_pair(h, w, gt, blur=1.0, seed=seed)
    gt[::7, ::5] = np.nan              # holes: GT missing
    return left, right, gt


@pytest.mark.parametrize("patch, n, seed", [(8, 100, 0), (16, 300, 3),
                                            (12, 5000, 1)])
def test_sample_training_patches_is_bit_equal(patch, n, seed):
    left, right, gt = _scene(40, 72, seed)
    want = jm.sample_training_patches(left, right, gt, n, patch=patch,
                                      seed=seed)
    got = tm.sample_training_patches(left, right, gt, n, patch=patch,
                                     seed=seed)
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == w.shape
        assert g.shape[1:] == (patch, patch) and 0 < len(g) <= n
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("families", [("dots", "shaded", "adversarial"),
                                      ("raytrace", "dots", "shaded")],
                         ids=["default", "raytrace"])
def test_training_pool_matches_jax(families):
    kw = dict(n_scenes=3, seed=2, height=48, width=80, patches_per_scene=40,
              patch=12, num_disparities=24, families=families)
    want = jm.make_training_pool(**kw)
    got = tm.make_training_pool(**kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (120, 12, 12)
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=POOL_TOL * float(np.abs(w).max()))


@pytest.mark.parametrize("arch", [(16, 2), "fast"], ids=["16x2", "fast"])
def test_hinge_loss_and_gradients_match_jax(arch):
    model = jm.MCCNNFeatures(16, 2) if arch == (16, 2) \
        else jm.make_model(arch)
    params = jm.init_params(model, jax.random.PRNGKey(1), (12, 12))
    rng = np.random.default_rng(0)
    batch = [rng.normal(size=(24, 12, 12)).astype(np.float32)
             for _ in range(3)]
    loss, grads = jax.value_and_grad(
        lambda p: jm.hinge_loss(model, p, *map(jnp.asarray, batch)))(params)
    tmodel = tm.from_flax_params(params, arch).requires_grad_(True)
    got = tm.hinge_loss(tmodel, *map(torch.from_numpy, batch))
    got.backward()
    _close_rel(float(got.detach()), float(loss), LOSS_RTOL)
    for i in range(tmodel.num_layers):
        g = grads["params"][f"conv{i}"]
        _grad_close(_hwio(tmodel.weights[i].grad), np.asarray(g["kernel"]))
        _grad_close(tmodel.biases[i].grad.numpy(), np.asarray(g["bias"]))


def _patch_batches(n_batches: int, size: int, seed: int):
    left, right, gt = _scene(48, 72, seed)
    a, p, n = jm.sample_training_patches(left, right, gt, size * n_batches,
                                         patch=12, seed=seed)
    a, p, n = ((x - 128.0) / 64.0 for x in (a, p, n))
    return [(a[i:i + size], p[i:i + size], n[i:i + size])
            for i in range(0, size * n_batches, size)]


@pytest.mark.parametrize("lr", ["float", "schedule"])
def test_mccnn_adam_steps_track_optax(lr):
    """Five steps of ``train`` against the JAX trainer: a float learning
    rate and a callable one (optax's cosine schedule against the port's)."""
    model = jm.MCCNNFeatures(16, 2)
    params = jm.init_params(model, jax.random.PRNGKey(4), (12, 12))
    batches = _patch_batches(5, 32, 5)
    j_lr, t_lr = (1e-4, 1e-4) if lr == "float" else (
        optax.cosine_decay_schedule(1e-4, 4, 0.05),
        cosine_decay_schedule(1e-4, 4, 0.05))
    want_params, want = jm.train(model, params, batches, learning_rate=j_lr)
    tmodel = tm.from_flax_params(params, (16, 2))
    tmodel, got = tm.train(tmodel, batches, learning_rate=t_lr,
                           device="cpu")
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        _close_rel(g, w, STEP_RTOL)
    for i in range(2):
        p = want_params["params"][f"conv{i}"]
        np.testing.assert_allclose(_hwio(tmodel.weights[i]),
                                   np.asarray(p["kernel"]), atol=PARAM_TOL)
        np.testing.assert_allclose(tmodel.biases[i].detach().numpy(),
                                   np.asarray(p["bias"]), atol=PARAM_TOL)


def test_train_leaves_the_inference_state():
    """After ``train`` the parameters take no gradients and K8's copies are
    those of the trained weights."""
    model = tm.make_model((16, 2), seed=0)
    before = [w.detach().clone() for w in model.weights]
    model, losses = tm.train(model, _patch_batches(2, 16, 6), 1e-3,
                             device="cpu")
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert not any(p.requires_grad for p in model.parameters())
    for i, w in enumerate(model.weights):
        assert not torch.equal(w, before[i])
        assert torch.equal(getattr(model, f"layout{i}"),
                           tm.mccnn_weight_layout(w.detach(), False))


@pytest.mark.parametrize("lr", ["float", "schedule"])
def test_adam_matches_optax_on_the_same_gradients(lr):
    rng = np.random.default_rng(9)
    shapes = [(4, 3, 3, 3), (7,)]
    init = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[(rng.normal(size=s) * 10.0 ** rng.uniform(-6, 0, s)).astype(
        np.float32) for s in shapes] for _ in range(6)]
    j_lr, t_lr = (3e-3, 3e-3) if lr == "float" else (
        optax.cosine_decay_schedule(3e-3, 5, 0.1),
        cosine_decay_schedule(3e-3, 5, 0.1))
    opt = optax.adam(j_lr)
    jp = [jnp.asarray(x) for x in init]
    state = opt.init(jp)
    tp = [torch.from_numpy(x.copy()).requires_grad_(True) for x in init]
    topt = Adam(tp, t_lr)
    for g in grads:
        updates, state = opt.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x)
        topt.step()
    assert topt.count == 6
    for p, w in zip(tp, jp):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(w),
                                   rtol=ADAM_RTOL, atol=ADAM_TOL)


def test_cosine_decay_schedule_matches_optax():
    want = optax.cosine_decay_schedule(3e-4, 100, 0.05)
    got = cosine_decay_schedule(3e-4, 100, 0.05)
    for count in (0, 1, 37, 99, 100, 150):
        _close_rel(got(count), float(want(count)), 1e-6)
    opt = Adam([torch.zeros(1, requires_grad=True)], got)
    assert opt.lr(opt.count) == got(0)


# ---------------------------------------------------------- monodepth ----

@pytest.fixture(scope="module")
def small():
    """The small arch with flax's initial weights, in both packages."""
    model = jmd.make_model("small")
    params = jmd.init_params(model, jax.random.PRNGKey(2), (1, 32, 48, 3))
    return model, params


def _pairs(n: int, seed: int, h: int = 32, w: int = 48):
    """n rectified (left, right) RGB pairs in [0, 1], (n, h, w, 3)."""
    ls, rs = [], []
    for i in range(n):
        gt = box_scene(h, w, 2.0, 6.0 + i)
        l, r = random_dot_pair(h, w, gt, blur=1.0, seed=seed + i)
        ls.append(np.repeat(l[..., None], 3, -1) / 255.0)
        rs.append(np.repeat(r[..., None], 3, -1) / 255.0)
    return (np.stack(ls).astype(np.float32),
            np.stack(rs).astype(np.float32))


def _labels(n: int, seed: int, h: int = 32, w: int = 48):
    rng = np.random.default_rng(seed)
    target = rng.uniform(0.0, 0.15, (n, h, w)).astype(np.float32)
    valid = rng.uniform(size=(n, h, w)) < 0.8
    return target, valid


def _vjp_pair(jfn, tfn, inputs, diff_args, seed=0):
    """The function's value and its input gradients, JAX and port, on a
    random cotangent: the NHWC inputs go to JAX, NCHW to the port."""
    out, vjp = jax.vjp(jfn, *map(jnp.asarray, inputs))
    cot = np.random.default_rng(seed).normal(size=out.shape).astype(
        np.float32)
    jgrads = vjp(jnp.asarray(cot))
    targs = [_nchw(x).requires_grad_(True) for x in inputs]
    tout = tfn(*targs)
    tout_nhwc = tout.permute(0, 2, 3, 1) if tout.dim() == 4 else tout
    tout_nhwc.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(tout_nhwc.detach().numpy(), np.asarray(out),
                               rtol=0, atol=1e-6)
    for k in diff_args:
        _grad_close(targs[k].grad.permute(0, 2, 3, 1).numpy(),
                    np.asarray(jgrads[k]))


def test_warp_ssim_smoothness_and_gradients_match_jax():
    left, right = _pairs(2, 10)
    rng = np.random.default_rng(1)
    disp = rng.uniform(0.0, 0.2, (2, 32, 48, 1)).astype(np.float32)
    for direction in (-1.0, 1.0):
        _vjp_pair(lambda i, d: jmd._warp_horizontal(i, d, direction),
                  lambda i, d: tmd._warp_horizontal(i, d, direction),
                  (right, disp), (0, 1))
    _vjp_pair(jmd._ssim, tmd._ssim, (left, right), (0, 1))
    _vjp_pair(lambda d, i: jmd._smoothness(d, i)[None],
              lambda d, i: tmd._smoothness(d, i)[None], (disp, left),
              (0, 1))


def _param_grads_close(tmodel, jgrads) -> None:
    convs = tmd._convs(tmodel)
    names = [f"ConvBlock_{i}" for i in range(tmd.N_BLOCKS)] + ["disp0",
                                                                "disp1"]
    for conv, name in zip(convs, names):
        g = jgrads["params"][name]
        g = g["Conv_0"] if name.startswith("Conv") else g
        _grad_close(_hwio(conv.weight.grad), np.asarray(g["kernel"]))
        _grad_close(conv.bias.grad.numpy(), np.asarray(g["bias"]))


def test_monodepth_loss_and_gradients_match_jax(small):
    model, params = small
    left, right = _pairs(2, 20)
    loss, grads = jax.value_and_grad(lambda p: jmd.monodepth_loss(
        model, p, jnp.asarray(left), jnp.asarray(right)))(params)
    tmodel = tmd.from_flax_params(params).requires_grad_(True)
    with torch.backends.mkldnn.flags(enabled=False):
        got = tmd.monodepth_loss(tmodel, _nchw(left), _nchw(right))
        got.backward()
    _close_rel(float(got.detach()), float(loss), LOSS_RTOL)
    _param_grads_close(tmodel, grads)


def test_distillation_loss_and_gradients_match_jax(small):
    model, params = small
    left, _ = _pairs(2, 30)
    target, valid = _labels(2, 3)
    loss, grads = jax.value_and_grad(lambda p: jmd.distillation_loss(
        model, p, jnp.asarray(left), jnp.asarray(target),
        jnp.asarray(valid)))(params)
    tmodel = tmd.from_flax_params(params).requires_grad_(True)
    with torch.backends.mkldnn.flags(enabled=False):
        got = tmd.distillation_loss(tmodel, _nchw(left),
                                    torch.from_numpy(target),
                                    torch.from_numpy(valid))
        got.backward()
    _close_rel(float(got.detach()), float(loss), LOSS_RTOL)
    _param_grads_close(tmodel, grads)


def _flat(tree: dict) -> np.ndarray:
    leaves = jax.tree_util.tree_leaves(tree)
    return np.concatenate([np.ravel(np.asarray(x)) for x in leaves])


@pytest.fixture(scope="module")
def trainers(small):
    """trainer -> (run(learning_rate) -> (port model, losses), its
    learning rate, JAX's parameters, JAX's losses): the three monodepth
    trainers from flax's weights, as the JAX package runs them."""
    model, params = small
    out = {}
    left, right = _pairs(3, 40)
    pairs = [(left[i:i + 1], right[i:i + 1]) for i in range(3)]
    out["train"] = (lambda lr: tmd.train(
        tmd.from_flax_params(params), pairs, learning_rate=lr,
        device="cpu"), 1e-4, *jmd.train(model, params, pairs,
                                        learning_rate=1e-4))
    # 5 picks at chunk 2: both packages run 4 steps (whole chunks)
    l_od, r_od = _pairs(3, 50)
    p_od = np.random.default_rng(5).integers(0, 3, (5, 2))
    out["on_device"] = (lambda lr: tmd.train_on_device(
        tmd.from_flax_params(params), l_od, r_od, p_od, learning_rate=lr,
        chunk=2, device="cpu"), 1e-4,
        *jmd.train_on_device(model, params, l_od, r_od, p_od,
                             learning_rate=1e-4, chunk=2))
    # flips and the cosine schedule, as tools/train_monodepth.py runs them
    l_di, _ = _pairs(3, 60)
    target, valid = _labels(3, 7)
    rng = np.random.default_rng(8)
    p_di = rng.integers(0, 3, (5, 2))
    flips = rng.uniform(size=p_di.shape) < 0.5
    assert flips.any() and not flips.all()
    out["distilled"] = (lambda lr: tmd.train_distilled_on_device(
        tmd.from_flax_params(params), l_di, target, valid, p_di, lr,
        chunk=2, flips=flips, device="cpu"),
        cosine_decay_schedule(1e-4, 5, 0.05),
        *jmd.train_distilled_on_device(
            model, params, l_di, target, valid, p_di,
            optax.cosine_decay_schedule(1e-4, 5, 0.05), chunk=2,
            flips=flips))
    return out


def _trainer_errors(trainers, small, name, learning_rate=None):
    """The port's trainer ``name`` (at ``learning_rate``, else JAX's) against
    JAX's: (its step count, the first loss's relative error, the largest
    of the later losses', the weights' move's in norm)."""
    run, lr, jparams, want = trainers[name]
    tmodel, got = run(lr if learning_rate is None else learning_rate)
    assert not any(p.requires_grad for p in tmodel.parameters())
    assert len(got) == len(want)
    p0 = _flat(small[1])
    move_t = _flat(tmd.to_flax_params(tmodel)) - p0
    move_j = _flat(jparams) - p0
    return (len(got), abs(got[0] - want[0]) / abs(want[0]),
            max(abs(g - w) / abs(w) for g, w in zip(got[1:], want[1:])),
            float(np.linalg.norm(move_t - move_j) / np.linalg.norm(move_j)))


def _trainer_close(trainers, small, name) -> int:
    """The monodepth trainers' criteria (see the module's docstring)."""
    n, first, later, move = _trainer_errors(trainers, small, name)
    assert first <= LOSS_RTOL, first
    assert later <= MONO_BARS[name][0], later
    assert move <= MONO_BARS[name][1], move
    return n


def test_monodepth_train_tracks_optax(trainers, small):
    assert _trainer_close(trainers, small, "train") == 3


def test_train_on_device_drops_the_trailing_steps(trainers, small):
    """5 picks at chunk 2: both packages run 4 steps (whole chunks)."""
    assert _trainer_close(trainers, small, "on_device") == 4


def test_train_distilled_on_device_tracks_optax(trainers, small):
    """Flips and the cosine schedule, as ``tools/train_monodepth.py``
    runs them; 5 picks at chunk 2 run 4 steps."""
    assert _trainer_close(trainers, small, "distilled") == 4


@pytest.mark.parametrize("name, fault", [
    ("train", "lr"), ("on_device", "lr"), ("distilled", "lr"),
    ("distilled", "late schedule")])
def test_monodepth_trainer_bars_catch_a_wrong_learning_rate(trainers, small,
                                                            name, fault):
    """Controls: the port's trainer with the learning rate LR_FAULT times
    JAX's, or the schedule read one count late, misses both of its bars."""
    lr = trainers[name][1]
    if fault == "late schedule":
        wrong = lambda count: lr(count + 1)  # noqa: E731
    elif callable(lr):
        wrong = lambda count: LR_FAULT * lr(count)  # noqa: E731
    else:
        wrong = LR_FAULT * lr
    _, first, later, move = _trainer_errors(trainers, small, name, wrong)
    assert first <= LOSS_RTOL
    assert later > MONO_BARS[name][0] and move > MONO_BARS[name][1], (
        later, move)
