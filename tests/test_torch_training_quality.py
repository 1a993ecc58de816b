"""The port's trainers against the JAX tests' own quality bars, on the CPU,
and the round trip of a port-trained checkpoint through the JAX package.

The bars are those of ``tests/test_mccnn.py:70-100`` (the hinge loss
falls below 0.8 of its start in 30 steps; a tower trained 40 steps drives
the SGM matcher to bad-3px < 0.15) and ``tests/test_monodepth.py:39-49``
(the monodepth loss falls in 25 steps), on the same scenes, batches and
learning rates. The port's weights start from flax's distribution drawn
from a seeded ``torch.Generator`` (the JAX tests' ``PRNGKey`` seeds), not
from flax's stream.

Round trip: a checkpoint the port wrote (``save_params_npz``), read by the
JAX package's ``load_params_npz``, gives flax features within FEAT_TOL of
the port's own tower, and a monodepth map within MONO_TOL * W px of the
port's ``predict_disparity`` (the tolerances of ``test_torch_mccnn.py``
and ``test_torch_monodepth.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_match_tpu.data.synthetic import box_scene, random_dot_pair
from stereo_match_tpu.models import mccnn as jm
from stereo_match_tpu.models import monodepth as jmd
from stereo_match_tpu_torch.config import DisparityConfig
from stereo_match_tpu_torch.costs import MCCNNCost
from stereo_match_tpu_torch.eval.metrics import bad_pixel_rate
from stereo_match_tpu_torch.models import mccnn as tm
from stereo_match_tpu_torch.models import monodepth as tmd
from stereo_match_tpu_torch.pipeline.stereo import StereoMatcher

FEAT_TOL = 1e-5
MONO_TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _first_sqrt():
    """torch 2.13's CPU ``sqrt`` can be off by about 1e-3 relative in its
    first multithreaded call of a process; make that call first."""
    a = torch.ones(96, 16, 12, 12)
    torch.sqrt(torch.sum(a * a, 1, keepdim=True) + 1e-12)


def _hinge(model, batch) -> float:
    with torch.no_grad():
        return float(tm.hinge_loss(model, *map(torch.from_numpy, batch)))


def test_mccnn_training_reduces_loss():
    """``tests/test_mccnn.py::test_training_reduces_loss``'s bar."""
    model = tm.make_model("fast", seed=1)
    gt = box_scene(48, 72, 4, 10)
    left, right = random_dot_pair(48, 72, gt, blur=1.0)
    batch = tm.sample_training_patches(left, right, gt, 256, patch=12)
    l0 = _hinge(model, batch)
    model, losses = tm.train(model, [batch] * 30, learning_rate=1e-3,
                             device="cpu")
    l1 = _hinge(model, batch)
    assert len(losses) == 30 and losses[0] == pytest.approx(l0, rel=1e-5)
    assert l1 < l0 * 0.8, (l0, l1)


@pytest.fixture(scope="module")
def trained_tower():
    """``tests/test_mccnn.py::test_mccnn_cost_in_pipeline``'s training: 40
    steps on 512 patches of the 48x72 box scene."""
    model = tm.make_model("fast", seed=2)
    gt = box_scene(48, 72, 4, 10)
    left, right = random_dot_pair(48, 72, gt, blur=1.0)
    batch = tm.sample_training_patches(left, right, gt, 512, patch=12,
                                       seed=1)
    model, _ = tm.train(model, [batch] * 40, learning_rate=1e-3,
                        device="cpu")
    return model, (left, right, gt)


def test_mccnn_cost_in_pipeline(trained_tower):
    model, (left, right, gt) = trained_tower
    cfg = DisparityConfig(num_disparities=16, cost="mccnn",
                          uniqueness_ratio=0, wls=False)
    raw, _ = StereoMatcher(cfg, cost_fn=MCCNNCost(model, cfg),
                           device="cpu")(left, right)
    bad3 = float(bad_pixel_rate(raw, gt, 3.0, 0.0))
    assert bad3 < 0.15, bad3


def test_mccnn_checkpoint_round_trips_through_jax(trained_tower, tmp_path):
    model, (left, _, _) = trained_tower
    path = tm.save_params_npz(tmp_path / "tower", model)
    assert path == tmp_path / "tower.npz"
    params = jm.load_params_npz(str(path))
    x = tm.normalize_image(left)
    want = np.asarray(jm.make_model("fast").apply(
        params, jnp.asarray(x.numpy())[None, ..., None]))[0]
    got = tm.tower_plain(model, x[None])[0].permute(1, 2, 0)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=FEAT_TOL)
    again = tm.from_flax_params(tm.load_params_npz(path), "fast")
    for a, b in zip(again.state_dict().values(),
                    model.state_dict().values()):
        assert torch.equal(a, b)


def _monodepth_pair():
    gt = box_scene(32, 48, 2.0, 6.0)
    l, r = random_dot_pair(32, 48, gt, blur=1.0)
    return (np.stack([np.stack([l] * 3, -1)]) / 255.0).astype(np.float32), \
        (np.stack([np.stack([r] * 3, -1)]) / 255.0).astype(np.float32)


def test_monodepth_training_reduces_loss():
    """``tests/test_monodepth.py::test_loss_finite_and_training_reduces``'s
    bar, on its (8, 12, 16, 24) net."""
    model = tmd.MonodepthNet(encoder_features=(8, 12, 16, 24))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for conv in tmd._convs(model):
            conv.weight.copy_(tmd._lecun_normal(tuple(conv.weight.shape),
                                                gen))
            conv.bias.zero_()
    model.requires_grad_(False)
    lb, rb = _monodepth_pair()
    with torch.no_grad():
        l0 = float(tmd.monodepth_loss(model, torch.from_numpy(lb).permute(
            0, 3, 1, 2), torch.from_numpy(rb).permute(0, 3, 1, 2)))
    assert np.isfinite(l0)
    model, losses = tmd.train(model, [(lb, rb)] * 25, learning_rate=1e-3,
                              device="cpu")
    assert losses[-1] < l0, (l0, losses[-1])


def test_monodepth_checkpoint_round_trips_through_jax(tmp_path):
    """A distilled small net, written by the port, read by JAX's
    ``load_params_npz`` and ``infer_arch``: JAX's ``predict_disparity``
    equals the port's."""
    lb, _ = _monodepth_pair()
    rng = np.random.default_rng(3)
    target = rng.uniform(0.0, 0.15, (1, 32, 48)).astype(np.float32)
    model, losses = tmd.train_distilled_on_device(
        tmd.make_model("small", seed=4), lb, target, target > 0.01,
        np.zeros((4, 1), np.int64), 1e-3, chunk=2, device="cpu")
    assert len(losses) == 4
    path = tmd.save_params_npz(tmp_path / "mono.npz", model)
    params = jm.load_params_npz(str(path))
    assert jmd.infer_arch(params) == "small"
    img = rng.integers(0, 255, (40, 70, 3), np.uint8)
    for internal in ((96, 160), None):
        want = jmd.predict_disparity(jmd.make_model("small"), params, img,
                                     internal)
        got = tmd.predict_disparity(model, img, internal)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=MONO_TOL * 70)


def test_trainers_never_write_the_shipped_checkpoints():
    """The saver refuses the JAX package's weights directory."""
    model = tm.make_model((8, 2), seed=0)
    with pytest.raises(ValueError, match="shipped checkpoints"):
        tm.save_params_npz(tm.default_checkpoint_path("fast"), model)
    with pytest.raises(ValueError, match="shipped checkpoints"):
        tmd.save_params_npz(tmd.default_checkpoint_path("small"),
                            tmd.make_model("small"))
