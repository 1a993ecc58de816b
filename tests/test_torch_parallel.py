"""The port's parallel package against the JAX package's, on the CPU.

The port runs its shards and stages in one process over a device list that
repeats ``cpu``; the JAX package runs shard_map over the 8 virtual CPU
devices of ``tests/conftest.py`` with the Pallas kernels in interpret mode.
The row-tiled SGM is held to JAX's ``sgm_aggregate_sharded`` with the JAX
test's tolerance on float volumes (rtol 1e-6, atol 1e-4: the two add the
directions in another order) and bit for bit on int16 census volumes; the
stream bit for bit to JAX's ``_match_core`` on every frame, and with the
post stack within JAX's own bounds (raw 1e-5, WLS-filtered 5e-3).
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

from stereo_match_tpu.config import DisparityConfig as JaxDisparityConfig
from stereo_match_tpu.data.synthetic import box_scene, random_dot_pair
from stereo_match_tpu.ops.cost_volume import build_cost_volume
from stereo_match_tpu.parallel.mesh import make_mesh as jax_make_mesh
from stereo_match_tpu.parallel.tiling import \
    sgm_aggregate_sharded as jax_sgm_aggregate_sharded
from stereo_match_tpu.pipeline.stereo import StereoMatcher as JaxMatcher
from stereo_match_tpu.pipeline.stereo import _match_core as jax_match_core
from stereo_match_tpu_torch.config import DisparityConfig
from stereo_match_tpu_torch.ops import cuda_kernels as K
from stereo_match_tpu_torch.ops.cost_volume import \
    build_cost_volume as torch_build_cost_volume
from stereo_match_tpu_torch.parallel import (StreamingPipeline,
                                             batch_sharding, batched_matcher,
                                             image_sharding, make_mesh,
                                             make_stage_mesh,
                                             sgm_aggregate_sharded,
                                             volume_sharding)
from stereo_match_tpu_torch.parallel.pipeline_stage import (
    make_stage_fns, make_stage_fns_census)
from stereo_match_tpu_torch.pipeline.stereo import StereoMatcher

H, W, D = 32, 64, 16
REPO = Path(__file__).resolve().parents[1]


def _cpus(n):
    return ["cpu"] * n


def _frames(k, seed0=7):
    out = []
    for i in range(k):
        gt = box_scene(H, W, 2.0 + i % 3, 8.0 + i % 4)
        out.append(random_dot_pair(H, W, gt, blur=0.8, seed=seed0 + i))
    return out


def _cfg_kw(**kw):
    return {**dict(num_disparities=D, cost="census", uniqueness_ratio=15,
                   disp12_max_diff=1, wls=False, speckle_window_size=0),
            **kw}


def _cfg(**kw):
    """The port's config."""
    return DisparityConfig(**_cfg_kw(**kw))


def _cfgs(**kw):
    """(the port's config, the JAX package's), from the same kwargs."""
    return _cfg(**kw), JaxDisparityConfig(**_cfg_kw(**kw))


def _jax_core(frame, cfg):
    l, r = frame
    raw, filt = jax_match_core(jnp.asarray(l, jnp.float32),
                               jnp.asarray(r, jnp.float32), cfg)
    return np.asarray(raw), np.asarray(filt)


@pytest.fixture(scope="module")
def jax_mesh4():
    return jax_make_mesh(batch=1, rows=4, devices=jax.devices()[:4])


# --------------------------------------------------------------- mesh ----

def test_mesh_shapes_and_splits():
    m = make_mesh(batch=2, rows=4, devices=_cpus(8))
    assert m.shape == {"batch": 2, "rows": 4}
    assert m.devices.shape == (2, 4)
    assert make_mesh(2, devices=_cpus(8)).shape == {"batch": 2, "rows": 4}
    assert volume_sharding(m).bounds(53) == [(0, 14), (14, 28), (28, 42),
                                             (42, 53)]
    assert volume_sharding(m).bounds(53, 8) == [(0, 16), (16, 32), (32, 48),
                                                (48, 53)]
    img = torch.arange(10 * 3).view(10, 3)
    parts = image_sharding(m).shards(img)
    assert [p.shape[0] for p in parts] == [3, 3, 3, 1]
    assert torch.equal(image_sharding(m).gather(parts, "cpu"), img)
    assert len(batch_sharding(m).devices()) == 2


def test_mesh_raises_instead_of_falling_back():
    with pytest.raises(ValueError):
        make_mesh(batch=3, devices=_cpus(8))
    with pytest.raises(ValueError):
        make_mesh(1, 4, devices=_cpus(2))       # more than listed
    with pytest.raises(ValueError):
        make_stage_mesh(4, devices=_cpus(2))
    if not torch.cuda.is_available():           # the default is CUDA only
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(1, 1)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_stage_mesh(2)


# ------------------------------------------------------ row-tiled SGM ----

@pytest.mark.parametrize("mode", ["exact", "halo"])
@pytest.mark.parametrize("num_paths", [2, 4, 8])
def test_sharded_matches_jax(jax_mesh4, num_paths, mode):
    vol = np.random.default_rng(0).uniform(0, 24, (16, 64, 48)).astype(
        np.float32)
    want = np.asarray(jax_sgm_aggregate_sharded(
        jnp.asarray(vol), 8.0, 96.0, jax_mesh4, num_paths, mode=mode,
        halo=8))
    got = sgm_aggregate_sharded(torch.from_numpy(vol), 8.0, 96.0,
                                make_mesh(1, 4, devices=_cpus(4)), num_paths,
                                mode, halo=8)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-4)
    if mode == "exact":      # the single-card total, in its own sum order
        assert torch.equal(got, K.aggregate_paths(torch.from_numpy(vol), 8.0,
                                                  96.0, num_paths))


@pytest.mark.parametrize("mode", ["exact", "halo"])
def test_sharded_int16_ragged_height_bit_equal_to_jax(jax_mesh4, mode):
    """53 rows over 4 shards (16/16/16/5 exact, 14/14/14/11 halo): JAX
    pads the last shard with zero rows, the port does not."""
    gt = box_scene(53, 96)
    left, right = random_dot_pair(53, 96, gt, blur=0.8)
    jvol = build_cost_volume(jnp.asarray(left), jnp.asarray(right), 16,
                             dtype="int16")
    vol = torch_build_cost_volume(torch.from_numpy(left),
                                  torch.from_numpy(right), 16, dtype="int16")
    np.testing.assert_array_equal(vol.numpy(), np.asarray(jvol))
    want = np.asarray(jax_sgm_aggregate_sharded(jvol, 8.0, 96.0, jax_mesh4,
                                                8, mode=mode, halo=8))
    got = sgm_aggregate_sharded(vol, 8.0, 96.0,
                                make_mesh(1, 4, devices=_cpus(4)), 8, mode,
                                halo=8)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), want)


def test_sharded_validates():
    vol = torch.zeros(4, 8, 8)
    mesh = make_mesh(1, 2, devices=_cpus(2))
    with pytest.raises(ValueError):
        sgm_aggregate_sharded(vol, 8.0, 96.0, mesh, num_paths=3)
    with pytest.raises(ValueError):
        sgm_aggregate_sharded(vol, 8.0, 96.0, mesh, mode="ring")


# -------------------------------------------------------- batch (DP) ----

def test_batched_matcher_matches_single_pair():
    gt = box_scene(32, 64)
    pairs = [random_dot_pair(32, 64, gt, blur=0.8, seed=s) for s in range(4)]
    lefts = np.stack([p[0] for p in pairs])
    rights = np.stack([p[1] for p in pairs])
    cfg, jcfg = _cfgs(uniqueness_ratio=0)
    fn = batched_matcher(cfg, make_mesh(2, 2, devices=_cpus(4)))
    raw, filtered = fn(lefts, rights)
    assert raw.shape == filtered.shape == (4, 32, 64)
    for i in (0, 2):
        single, _ = StereoMatcher(cfg, device="cpu")(lefts[i], rights[i])
        np.testing.assert_array_equal(raw[i].numpy(), single.numpy())
        want, _ = JaxMatcher(jcfg)(lefts[i], rights[i])
        np.testing.assert_array_equal(raw[i].numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="divisible"):
        fn(lefts[:3], rights[:3])


# ------------------------------------------------ stage-pipelined stream --

@pytest.mark.parametrize("mode", ["volume", "census"])
@pytest.mark.parametrize("n_stages", [2, 4])
def test_stream_matches_jax_match_core(n_stages, mode):
    cfg, jcfg = _cfgs()
    pipe = StreamingPipeline(cfg, make_stage_mesh(n_stages, _cpus(n_stages)),
                             image_shape=(H, W), payload_mode=mode)
    frames = _frames(n_stages + 2)
    results = pipe.run(frames)
    assert len(results) == len(frames)
    for frame, (raw, filt) in zip(frames, results):
        ref_raw, ref_filt = _jax_core(frame, jcfg)
        np.testing.assert_array_equal(raw.numpy(), ref_raw)
        np.testing.assert_array_equal(filt.numpy(), ref_filt)


@pytest.mark.parametrize("mode", ["volume", "census"])
@pytest.mark.parametrize("n_stages", [2, 4])
def test_int16_wire_equals_clamped_float32_run(n_stages, mode):
    """The int16 wire is lossless for the clamped (1024) sentinel, and the
    clamp changes nothing right of x = D (4 stages: 5 paths in flight)."""
    cfg = _cfg()
    mesh = make_stage_mesh(n_stages, _cpus(n_stages))
    frames = _frames(n_stages + 1, seed0=77)
    kw = dict(image_shape=(H, W), payload_mode=mode)
    ref = StreamingPipeline(cfg, mesh, _invalid_clamp=1024.0, **kw).run(frames)
    got = StreamingPipeline(cfg, mesh, payload_dtype="int16", **kw).run(frames)
    f32 = StreamingPipeline(cfg, mesh, **kw).run(frames)
    for (r1, f1), (r2, f2), (r3, _) in zip(ref, got, f32):
        np.testing.assert_array_equal(r1.numpy(), r2.numpy())
        np.testing.assert_array_equal(f1.numpy(), f2.numpy())
        np.testing.assert_array_equal(r2[:, D:].numpy(), r3[:, D:].numpy())


def test_int16_wire_overflow_guard():
    cfg = _cfg(p1=100, p2=7000)       # 5 * (1024 + 7000) > 32768 at 4 stages
    with pytest.raises(ValueError, match="overflow"):
        StreamingPipeline(cfg, make_stage_mesh(4, _cpus(4)), (H, W),
                          payload_dtype="int16")
    # the 2-stage split has 2 paths in flight: the same config is legal
    StreamingPipeline(cfg, make_stage_mesh(2, _cpus(2)), (H, W),
                      payload_dtype="int16")
    with pytest.raises(ValueError, match="integral"):  # P1 = 8/3
        StreamingPipeline(_cfg(census_window=(3, 3)),
                          make_stage_mesh(2, _cpus(2)), (H, W),
                          payload_dtype="int16")


def test_step_latency_contract():
    pipe = StreamingPipeline(_cfg(), make_stage_mesh(4, _cpus(4)), (H, W))
    outs = [pipe.step(l, r) for l, r in _frames(6, seed0=40)]
    assert all(o is None for o in outs[:3])      # the pipeline is filling
    assert all(o is not None and o.shape == (2, H, W) for o in outs[3:])


def test_run_is_reusable():
    pipe = StreamingPipeline(_cfg(), make_stage_mesh(2, _cpus(2)), (H, W),
                             payload_mode="census")
    frames = _frames(3, seed0=41)
    first, second = pipe.run(frames), pipe.run(frames)
    assert len(first) == len(second) == len(frames)
    for (r1, f1), (r2, f2) in zip(first, second):
        assert torch.equal(r1.nan_to_num(-1), r2.nan_to_num(-1))
        assert torch.equal(f1.nan_to_num(-1), f2.nan_to_num(-1))
    assert len(pipe.run(frames[:1])) == 1


def test_census_wire_is_smaller():
    cfg = _cfg()
    mesh = make_stage_mesh(2, _cpus(2))
    vol = StreamingPipeline(cfg, mesh, (H, W))
    cen = StreamingPipeline(cfg, mesh, (H, W), payload_mode="census")
    assert vol.wire_bytes() == 2 * D * H * W * 4
    assert cen.wire_bytes() == D * H * W * 4 + 2 * H * W * 4
    assert cen.wire_bytes() < 0.62 * vol.wire_bytes()
    for pipe in (vol, cen):                # what a hop really holds
        pipe.reset()
        pipe.step(*_frames(1)[0])
        held = sum(t.numel() * t.element_size() for t in pipe._state[1])
        assert held == pipe.wire_bytes()
    assert K.n_census_words((5, 5)) == 1 and K.n_census_words((7, 7)) == 2


def test_stream_with_post_stack():
    """Speckle + WLS run in the last stage on that frame's left image."""
    cfg, jcfg = _cfgs(wls=True, wls_iters=2, speckle_window_size=12,
                      speckle_range=2)
    pipe = StreamingPipeline(cfg, make_stage_mesh(4, _cpus(4)), (H, W))
    frames = _frames(5, seed0=21)
    for frame, (raw, filt) in zip(frames, pipe.run(frames)):
        ref_raw, ref_filt = _jax_core(frame, jcfg)
        np.testing.assert_allclose(raw.numpy(), ref_raw, atol=1e-5)
        np.testing.assert_allclose(filt.numpy(), ref_filt, atol=5e-3)
        assert not np.array_equal(raw.numpy(), filt.numpy())


def test_stage_fns_validation():
    for fns in (make_stage_fns, make_stage_fns_census):
        with pytest.raises(ValueError):
            fns(_cfg(cost="sad"), (H, W), 4)
        with pytest.raises(ValueError):
            fns(_cfg(num_paths=4), (H, W), 4)
        with pytest.raises(ValueError):
            fns(_cfg(), (H, W), 3)
    with pytest.raises(ValueError, match="24-bit"):
        make_stage_fns_census(_cfg(census_window=(3, 11)), (H, W), 2)
    with pytest.raises(ValueError):
        StreamingPipeline(_cfg(), make_stage_mesh(2, _cpus(2)), (H, W),
                          payload_mode="words")


def test_parallel_imports_no_jax():
    code = (
        "import sys, numpy as np\n"
        "from stereo_match_tpu_torch.config import DisparityConfig\n"
        "from stereo_match_tpu_torch.parallel import (StreamingPipeline, "
        "batched_matcher, make_mesh, make_stage_mesh, sgm_aggregate_sharded)\n"
        "rng = np.random.default_rng(0)\n"
        "l, r = (rng.uniform(0, 255, (12, 40)).astype(np.float32) "
        "for _ in range(2))\n"
        "cfg = DisparityConfig(num_disparities=16, wls=False)\n"
        "pipe = StreamingPipeline(cfg, make_stage_mesh(2, ['cpu'] * 2), "
        "(12, 40), payload_mode='census', payload_dtype='int16')\n"
        "assert len(pipe.run([(l, r)])) == 1\n"
        "from stereo_match_tpu_torch.parallel import (HostBatch, "
        "batched_matcher_multihost, host_local_slice, initialize_multihost, "
        "load_host_sharded, make_host_mesh)\n"
        "from stereo_match_tpu_torch.parallel.dsharding import ("
        "make_disp_mesh, match_dsharded, wta_dsharded)\n"
        "from stereo_match_tpu_torch.models.mccnn import (PARTITION_RULES, "
        "make_model, match_partition_rules, shard_params, train)\n"
        "from stereo_match_tpu_torch.parallel.mesh import named_mesh\n"
        "initialize_multihost(None, 1, 0)\n"
        "disp = match_dsharded(l, r, cfg, make_disp_mesh(devices=['cpu'] * 4),"
        " mode='exact')\n"
        "assert disp.shape == (12, 40)\n"
        "mesh = make_host_mesh(n_hosts=2, devices=['cpu'] * 2)\n"
        "lb = load_host_sharded(lambda i: l, 2, mesh, (12, 40))\n"
        "raw, _ = batched_matcher_multihost(cfg, mesh)(lb, lb)\n"
        "assert raw.local().shape == (2, 12, 40)\n"
        "tri = [rng.uniform(0, 1, (4, 9, 9)).astype(np.float32) "
        "for _ in range(3)]\n"
        "_, losses = train(make_model((8, 2), seed=0), [tri], 1e-3, 'cpu', "
        "named_mesh(['cpu'] * 4, (2, 2), ('data', 'model')))\n"
        "assert len(losses) == 1\n"
        "assert 'jax' not in sys.modules, 'the port imported jax'\n"
        "ref = [m for m in sys.modules if m == 'stereo_match_tpu' or "
        "m.startswith('stereo_match_tpu.')]\n"
        "assert not ref, ref\n"
        "print('ok')\n")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
