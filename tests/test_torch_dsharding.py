"""The port's D-sharded matching against the JAX package's, on the CPU.

The port runs its shards in one process over a device list that repeats
``cpu``; the JAX package runs shard_map over the 8 virtual CPU devices of
``tests/conftest.py`` with the Pallas kernels in interpret mode. With the
5x5 census P1 = 8 and P2 = 96, so every cost and total is an integer and
the totals are exact in any order of the paths: the cost slices, the
pmin-combined WTA and the D-sharded matcher (exact and halo, float32 and
int16, 2, 4 and 8 paths, at a height that needs no padding and at one that
does) must be bit-equal to JAX's. With the 7x9 window P1 = 62/3, and the
port adds the paths in ``PATH_DIRECTIONS_8`` order where JAX adds the
horizontal pair, then the downward three, then the upward three: the
totals differ in ulps, and the maps are held to the same NaN mask and
values within 1e-4 px (measured: 243 of 6144 pixels differ, by at most
3.3e-6 px).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_match_tpu.config import DisparityConfig as JaxDisparityConfig
from stereo_match_tpu.data.synthetic import box_scene, random_dot_pair
from stereo_match_tpu.ops.cost_volume import build_cost_volume
from stereo_match_tpu.parallel import dsharding as jax_ds
from stereo_match_tpu_torch.config import DisparityConfig
from stereo_match_tpu_torch.ops import cuda_kernels as K
from stereo_match_tpu_torch.parallel.dsharding import (_local_census_volume,
                                                       make_disp_mesh,
                                                       match_dsharded,
                                                       wta_dsharded)
from stereo_match_tpu_torch.pipeline.stereo import StereoMatcher

D = 32
TOL_7X9 = 1e-4   # px: the 7x9 totals differ in ulps (path order)


def _cpus(n):
    return ["cpu"] * n


def _scene(H=64, W=96, seed=2):
    gt = box_scene(H, W, background=4.0, foreground=14.0)
    left, right = random_dot_pair(H, W, gt, blur=0.8, seed=seed)
    return left, right, gt


def _cfg_kw(**kw):
    return {**dict(num_disparities=D, cost="census", uniqueness_ratio=15,
                   disp12_max_diff=1, wls=False, speckle_window_size=0),
            **kw}


def _cfgs(**kw):
    """(the port's config, the JAX package's), from the same kwargs."""
    return DisparityConfig(**_cfg_kw(**kw)), \
        JaxDisparityConfig(**_cfg_kw(**kw))


def _assert_maps_equal(got: torch.Tensor, want):
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------- cost slices ----

@pytest.mark.parametrize("window,min_disparity", [((5, 5), 3), ((7, 9), 0)])
@pytest.mark.parametrize("dtype", ["float32", "int16"])
def test_local_census_volume_bit_equal_to_jax(dtype, window, min_disparity):
    """Each shard's slice (K1 then K2 at min_disparity + d0) equals JAX's
    rolled and masked slice; the slices assemble to the whole volume. (The
    matcher tests below take min_disparity 0 at 5x5.)"""
    left, right, _ = _scene(40, 80)
    lt, rt = torch.from_numpy(left), torch.from_numpy(right)
    jdt = jnp.int16 if dtype == "int16" else jnp.float32
    parts = []
    for d0 in (0, 8, 16, 24):
        got = _local_census_volume(lt, rt, 8, d0, window, min_disparity,
                                   dtype)
        want = np.asarray(jax_ds._local_census_volume(
            jnp.asarray(left), jnp.asarray(right), 8, d0, window,
            min_disparity, jdt))
        assert got.dtype == (torch.int16 if dtype == "int16"
                             else torch.float32)
        np.testing.assert_array_equal(got.numpy(), want)
        parts.append(got)
    whole = np.asarray(build_cost_volume(
        jnp.asarray(left), jnp.asarray(right), 32, min_disparity,
        window=window, dtype=dtype))
    np.testing.assert_array_equal(torch.cat(parts).numpy(), whole)


# ------------------------------------------------------- the sharded WTA ----

def _volume(kind, dtype):
    if kind == "tie_heavy":
        vol = K.tie_heavy_total(D, 24, 70, seed=5)
    else:
        left, right, _ = _scene()
        vol = np.asarray(build_cost_volume(jnp.asarray(left),
                                           jnp.asarray(right), D))
    return vol.astype(np.int16 if dtype == "int16" else np.float32)


@pytest.mark.parametrize("settings", [
    dict(), dict(min_disparity=2, uniqueness_ratio=0, disp12_max_diff=-1,
                 subpixel=False)], ids=["headline", "plain_settings"])
@pytest.mark.parametrize("dtype", ["float32", "int16"])
@pytest.mark.parametrize("kind", ["scene", "tie_heavy"])
@pytest.mark.parametrize("n", [4, 8])
def test_wta_dsharded_bit_equal_to_jax(n, kind, dtype, settings):
    """The pmin rounds over 4 and 8 shards equal JAX's bit for bit, and the
    single-device WTA (``wta_lr_plain``), also on a tie-heavy volume
    (minima at d = 0 and D - 1, equal minima across shard borders, equal
    right-view diagonals)."""
    vol = _volume(kind, dtype)
    cfg, jcfg = _cfgs(**settings)
    got = wta_dsharded(torch.from_numpy(vol), make_disp_mesh(
        devices=_cpus(n)), cfg)
    want = jax.jit(functools.partial(
        jax_ds.wta_dsharded, mesh=jax_ds.make_disp_mesh(n),
        config=jcfg))(jnp.asarray(vol))
    _assert_maps_equal(got, want)
    single = K.wta_lr_plain(torch.from_numpy(vol), cfg.min_disparity,
                            cfg.uniqueness_ratio, cfg.disp12_max_diff,
                            cfg.subpixel)[0]
    assert torch.equal(got.nan_to_num(-1.0), single.nan_to_num(-1.0))


# ---------------------------------------------------- the D-sharded matcher ----

def _jax_match(left, right, jcfg, n, mode, halo):
    """JAX's ``match_dsharded`` under jit: eager shard_map runs the
    interpreted Pallas kernels op by op, ten times slower."""
    fn = jax.jit(functools.partial(jax_ds.match_dsharded, config=jcfg,
                                   mesh=jax_ds.make_disp_mesh(n), mode=mode,
                                   halo=halo))
    return fn(left, right)


# JAX compiles each case anew (4-14 s), so the cases cover each axis once
# around exact float32 at 8 paths: padded and not, int16, 2 and 4 paths,
# halo in both dtypes
@pytest.mark.parametrize("mode,H,dtype,num_paths", [
    ("exact", 64, "float32", 8), ("exact", 53, "float32", 8),
    ("exact", 53, "float32", 4), ("exact", 53, "float32", 2),
    ("exact", 53, "int16", 8), ("halo", 53, "float32", 8),
    ("halo", 64, "int16", 8)])
def test_match_dsharded_bit_equal_to_jax(mode, H, dtype, num_paths):
    """4 shards: per-shard slices, the re-shard to rows, K3's row blocks and
    K4 a block equal JAX's matcher at 64 rows (a multiple of every unit)
    and at 53, padded like JAX's to 64 rows exact and 56 halo."""
    left, right, _ = _scene(H)
    cfg, jcfg = _cfgs(num_paths=num_paths, dtype=dtype)
    got = match_dsharded(left, right, cfg, make_disp_mesh(devices=_cpus(4)),
                         mode=mode, halo=8)
    _assert_maps_equal(got, _jax_match(left, right, jcfg, 4, mode, 8))


@pytest.mark.parametrize("dtype", ["float32", "int16"])
def test_match_dsharded_exact_equals_the_single_device_matcher(dtype):
    """Unpadded (64 rows over 4 shards), exact mode is the single-device
    matcher bit for bit. Padded (53 rows to 64), the last 2 rows' census
    sees zero rows where the single-device census replicates the edge, and
    the upward paths start in the padding, so the maps differ in the last
    rows (here 94.5 % of the pixels agree, every row above row 36), as
    JAX's do."""
    cfg = DisparityConfig(**_cfg_kw(dtype=dtype))
    mesh = make_disp_mesh(devices=_cpus(4))
    left, right, gt = _scene(64)
    got = match_dsharded(left, right, cfg, mesh, mode="exact")
    single, _ = StereoMatcher(cfg, device="cpu")(left, right)
    assert torch.equal(got.nan_to_num(-1.0), single.nan_to_num(-1.0))
    valid = torch.isfinite(got).numpy()
    assert valid.mean() > 0.5
    err = np.abs(got.numpy()[valid] - gt[valid])
    assert (err > 3).mean() < 0.05
    left, right, _ = _scene(53)
    got = match_dsharded(left, right, cfg, mesh, mode="exact")
    single, _ = StereoMatcher(cfg, device="cpu")(left, right)
    same = got.nan_to_num(-1.0) == single.nan_to_num(-1.0)
    assert bool(same[:33].all())
    assert float(same[51:].float().mean()) < 0.5


def test_match_dsharded_7x9_within_ulps_of_jax():
    """At 7x9 (P1 = 62/3) the two packages add the paths in other orders."""
    left, right, _ = _scene(64)
    cfg, jcfg = _cfgs(census_window=(7, 9))
    assert cfg.P1 != int(cfg.P1)
    got = match_dsharded(left, right, cfg, make_disp_mesh(devices=_cpus(4)),
                         mode="exact").numpy()
    want = np.asarray(_jax_match(left, right, jcfg, 4, "exact", 48))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_7X9)


def test_dsharded_validates():
    left, right, _ = _scene(16, 48)
    cfg = DisparityConfig(**_cfg_kw())
    mesh = make_disp_mesh(devices=_cpus(3))
    with pytest.raises(ValueError, match="divisible"):
        match_dsharded(left, right, cfg, mesh)
    with pytest.raises(ValueError, match="divisible"):
        wta_dsharded(torch.zeros(32, 4, 8), mesh)
    mesh = make_disp_mesh(devices=_cpus(4))
    with pytest.raises(ValueError):
        match_dsharded(left, right, DisparityConfig(**_cfg_kw()), mesh,
                       mode="ring")
    with pytest.raises(ValueError):
        make_disp_mesh(5, devices=_cpus(4))
    assert make_disp_mesh(2, devices=_cpus(4)).shape == {"disp": 2}
    if not torch.cuda.is_available():       # the default is the cards
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_disp_mesh()
