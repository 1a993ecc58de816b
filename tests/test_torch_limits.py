"""The port beyond its card limits, on the CPU, against the JAX package.

K3 and K10 hold a line's disparities in one warp (D <= 1024) and K8 a
pixel's features in one block (F <= 128) on the card; the plain versions
on the CPU take any D and F, as the JAX package does. So on the CPU:
``StereoMatcher`` at D = 1040 must equal the JAX matcher (same NaN mask,
values within 1e-6, as ``test_torch_pipeline.py`` compares them), the
scans at D = 1040 must equal their plain versions bit for bit, and a
160-feature tower loaded from a flax init must match flax within 1e-5 and
its volume JAX's within 1e-4 (``test_torch_mccnn.py``'s tolerances). On
the card both limits raise ValueError (``tests/test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stereo_match_tpu.pipeline.stereo as jstereo
from stereo_match_tpu.models import mccnn as jmccnn
from stereo_match_tpu_torch.config import DisparityConfig
from stereo_match_tpu_torch.models import mccnn as tmccnn
from stereo_match_tpu_torch.ops import cuda_kernels as K
from stereo_match_tpu_torch.pipeline import stereo as tstereo

FEATURE_ATOL = 1e-5
VOLUME_ATOL = 1e-4
WIDE = (160, 2)          # (features, layers): wider than K8 takes


def _pair(H, W, d, seed):
    """A seeded random pair shifted by d pixels."""
    base = np.random.default_rng(seed).uniform(0, 255, (H, W + d))
    return (base[:, d:].astype(np.float32),
            base[:, :W].astype(np.float32))


def test_matcher_at_1040_disparities_matches_jax():
    left, right = _pair(3, 1100, 1030, seed=0)
    cfg = DisparityConfig(num_disparities=1040, cost="census",
                          uniqueness_ratio=15, disp12_max_diff=1, wls=False,
                          speckle_window_size=0)
    want, _ = jstereo.StereoMatcher(cfg)(left, right)
    got, _ = tstereo.StereoMatcher(cfg, device="cpu")(left, right)
    want = np.asarray(want)
    assert got.shape == want.shape == (3, 1100)
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
    assert np.isfinite(want).any()
    np.testing.assert_allclose(got.numpy()[~np.isnan(want)],
                               want[~np.isnan(want)], rtol=0, atol=1e-6)


@pytest.mark.parametrize("direction", [(0, 1), (0, -1), (1, 0), (-1, 1)])
def test_sgm_path_scan_at_1040_disparities_is_plain(direction):
    rng = np.random.default_rng(1)
    cost = torch.from_numpy(rng.uniform(0, 24, (1040, 3, 20)).astype(
        np.float32))
    got = K.sgm_path_scan(cost, torch.empty_like(cost), *direction, 8.0,
                          96.0, False)
    want = K.sgm_path_scan_plain(cost, torch.empty_like(cost), *direction,
                                 8.0, 96.0, False)
    assert torch.equal(got, want)


@pytest.mark.parametrize("reverse", [False, True])
def test_census_scan_at_1040_disparities_is_plain(reverse):
    rng = np.random.default_rng(2)
    cl, cr = (torch.from_numpy(rng.integers(0, 2 ** 24, (3, 1100)).astype(
        np.int32)) for _ in range(2))
    total = torch.from_numpy(rng.uniform(0, 9, (1040, 3, 1100)).astype(
        np.float32))
    got = K.census_scan(cl, cr, total.clone(), 5, 8.0, 96.0, reverse,
                        accumulate=True)
    want = K.census_scan_plain(cl, cr, total.clone(), 5, 8.0, 96.0, reverse,
                               1e4, True)
    assert torch.equal(got, want)


@pytest.fixture(scope="module")
def wide():
    """(JAX model, flax params, the port's model) of a 160-feature tower."""
    jmodel = jmccnn.MCCNNFeatures(features=WIDE[0], num_layers=WIDE[1])
    params = jmccnn.init_params(jmodel, jax.random.PRNGKey(5))
    return jmodel, params, tmccnn.from_flax_params(params, WIDE)


def test_wide_tower_builds_loads_and_matches_flax(wide):
    jmodel, params, model = wide
    assert (model.features, model.num_layers) == WIDE
    assert model.layout0 is None and model.layout1 is None   # K8: <= 128
    built = tmccnn.MCCNNFeatures(features=WIDE[0], num_layers=WIDE[1])
    built.load_state_dict(model.state_dict())
    img = np.random.default_rng(5).normal(size=(12, 21)).astype(np.float32)
    want = np.moveaxis(np.asarray(jmodel.apply(
        params, jnp.asarray(img)[None, ..., None])[0]), -1, 0)
    for m in (model, built):
        got = m(torch.from_numpy(img)[None])[0]
        assert got.shape == (WIDE[0], 12, 21)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=FEATURE_ATOL)
    with pytest.raises(ValueError, match="128"):
        K.mccnn_weight_layout(model.weights[1])


def test_wide_tower_cost_volume_matches_jax(wide):
    jmodel, params, model = wide
    left, right = np.random.default_rng(6).uniform(
        0, 255, (2, 14, 60)).astype(np.float32)
    want = np.asarray(jmccnn.mccnn_cost_volume(
        jmodel, params, jnp.asarray(left), jnp.asarray(right), 24, 3,
        use_bf16=False))
    got = tmccnn.mccnn_cost_volume(model, torch.from_numpy(left),
                                   torch.from_numpy(right), 24, 3)
    assert got.shape == (24, 14, 60)
    np.testing.assert_array_equal(got.numpy() == 1e4, want == 1e4)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=VOLUME_ATOL)
