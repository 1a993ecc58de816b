"""The port's multi-process data parallelism against the JAX package's.

In one process the port splits a device list that repeats ``cpu`` into
simulated hosts, as the JAX package splits the 8 virtual CPU devices of
``tests/conftest.py`` (a 2-host x 4-chip mesh): the layout, the per-host
loading and the matcher must give JAX's answers (the matcher bit for bit).
Then two real processes join a ``gloo`` group over ``tcp://127.0.0.1``
(the counterpart of ``tests/test_multihost.py::
test_two_process_distributed_smoke``): each loads only its rows, matches
them, and the rows gathered with ``torch.distributed.all_gather`` equal
the single-process result. The worker processes import only the port.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from stereo_match_tpu.config import DisparityConfig as JaxDisparityConfig
from stereo_match_tpu.data.synthetic import box_scene, random_dot_pair
from stereo_match_tpu.parallel import multihost as jax_mh
from stereo_match_tpu_torch.config import DisparityConfig
from stereo_match_tpu_torch.parallel import (HostBatch,
                                             batched_matcher_multihost,
                                             host_local_slice,
                                             initialize_multihost,
                                             load_host_sharded,
                                             make_host_mesh)
from stereo_match_tpu_torch.parallel.multihost import batch_sharding

H, W = 32, 48
REPO = Path(__file__).resolve().parents[1]


def _cpus(n):
    return ["cpu"] * n


def _dataset(n):
    frames = []
    for i in range(n):
        gt = box_scene(H, W, 2.0 + i % 3, 8.0 + i % 4)
        frames.append(random_dot_pair(H, W, gt, blur=0.8, seed=50 + i))
    return frames


def _cfg_kw():
    return dict(num_disparities=16, uniqueness_ratio=15, disp12_max_diff=1,
                wls=False)


def test_make_host_mesh_shapes():
    mesh = make_host_mesh(n_hosts=2, devices=_cpus(8))
    assert mesh.shape == {"host": 2, "chip": 4}
    assert make_host_mesh(devices=_cpus(3)).shape == {"host": 1, "chip": 3}
    with pytest.raises(ValueError):
        make_host_mesh(n_hosts=3, devices=_cpus(8))
    if not torch.cuda.is_available():       # the default is the cards
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_host_mesh(n_hosts=1)


def test_host_local_slice_matches_jax():
    for n, hosts in ((16, 2), (12, 3), (8, 8)):
        for k in range(hosts):
            assert host_local_slice(n, k, hosts) == \
                jax_mh.host_local_slice(n, k, hosts)
    with pytest.raises(ValueError):
        host_local_slice(15, 0, 2)


def test_load_host_sharded_matches_jax():
    """Each host group's rows land on its own devices, in JAX's layout."""
    n = 8
    data = np.arange(n * H * W, dtype=np.float32).reshape(n, H, W)
    mesh = make_host_mesh(n_hosts=2, devices=_cpus(8))
    loaded_by = []

    def load(i):
        loaded_by.append(i)
        return data[i]

    got = load_host_sharded(load, n, mesh, (H, W))
    assert sorted(loaded_by) == list(range(n))
    np.testing.assert_array_equal(got.local().numpy(), data)
    assert got.n_items == n and len(got.shards) == 8
    want = jax_mh.load_host_sharded(lambda i: data[i], n,
                                    jax_mh.make_host_mesh(n_hosts=2), (H, W))
    jax_flat = list(np.asarray(want.sharding.mesh.devices).ravel())
    bounds = {jax_flat.index(s.device): (s.index[0].start or 0,
                                         s.index[0].stop or n)
              for s in want.addressable_shards}
    assert [bounds[k] for k in range(8)] == list(got.bounds)
    assert batch_sharding(mesh).devices() == list(mesh.devices.ravel())
    with pytest.raises(ValueError):
        load_host_sharded(lambda i: data[i][:4], n, mesh, (H, W))
    with pytest.raises(ValueError):
        load_host_sharded(lambda i: data[i], 6, mesh, (H, W))


def test_multihost_matcher_matches_jax():
    """8 frames over 2 simulated hosts x 4 chips, each bit-equal to JAX's
    ``batched_matcher_multihost``."""
    frames = _dataset(8)
    lefts = np.stack([f[0] for f in frames])
    rights = np.stack([f[1] for f in frames])
    mesh = make_host_mesh(n_hosts=2, devices=_cpus(8))
    lb = load_host_sharded(lambda i: lefts[i], 8, mesh, (H, W))
    rb = load_host_sharded(lambda i: rights[i], 8, mesh, (H, W))
    raw, filt = batched_matcher_multihost(DisparityConfig(**_cfg_kw()),
                                          mesh)(lb, rb)
    assert isinstance(raw, HostBatch) and raw.bounds == lb.bounds
    jmesh = jax_mh.make_host_mesh(n_hosts=2)
    jl = jax_mh.load_host_sharded(lambda i: lefts[i], 8, jmesh, (H, W))
    jr = jax_mh.load_host_sharded(lambda i: rights[i], 8, jmesh, (H, W))
    want_raw, want_filt = jax_mh.batched_matcher_multihost(
        JaxDisparityConfig(**_cfg_kw()), jmesh)(jl, jr)
    np.testing.assert_array_equal(raw.local().numpy(), np.asarray(want_raw))
    np.testing.assert_array_equal(filt.local().numpy(),
                                  np.asarray(want_filt))
    with pytest.raises(TypeError):
        batched_matcher_multihost(DisparityConfig(**_cfg_kw()), mesh)(
            lefts, rights)


def test_initialize_multihost_single_process_is_a_noop():
    import torch.distributed as dist
    initialize_multihost()
    initialize_multihost("127.0.0.1:1", 1, 0)
    assert not (dist.is_available() and dist.is_initialized())
    with pytest.raises(ValueError, match="coordinator_address"):
        initialize_multihost(None, 2, 0, backend="gloo")


WORKER = """
import sys
import numpy as np
import torch
import torch.distributed as dist
from stereo_match_tpu_torch.config import DisparityConfig
from stereo_match_tpu_torch.data.synthetic import box_scene, random_dot_pair
from stereo_match_tpu_torch.parallel import (batched_matcher_multihost,
                                             initialize_multihost,
                                             load_host_sharded,
                                             make_host_mesh)

rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
H, W = {H}, {W}
initialize_multihost(f"127.0.0.1:{{port}}", 2, rank, backend="gloo")
try:
    assert dist.get_world_size() == 2 and dist.get_rank() == rank
    mesh = make_host_mesh(devices=["cpu", "cpu"])
    assert mesh.shape == {{"host": 2, "chip": 2}}, mesh.shape
    frames = {{}}

    def frame(i):
        if i not in frames:
            gt = box_scene(H, W, 2.0 + i % 3, 8.0 + i % 4)
            frames[i] = random_dot_pair(H, W, gt, blur=0.8, seed=50 + i)
        return frames[i]

    lb = load_host_sharded(lambda i: frame(i)[0], 8, mesh, (H, W))
    rb = load_host_sharded(lambda i: frame(i)[1], 8, mesh, (H, W))
    assert sorted(frames) == list(range(4 * rank, 4 * rank + 4)), frames
    assert lb.bounds == ((4 * rank, 4 * rank + 2),
                         (4 * rank + 2, 4 * rank + 4)), lb.bounds
    cfg = DisparityConfig(num_disparities=16, uniqueness_ratio=15,
                          disp12_max_diff=1, wls=False)
    raw, _ = batched_matcher_multihost(cfg, mesh)(lb, rb)
    local = raw.local()
    parts = [torch.empty_like(local) for _ in range(2)]
    dist.all_gather(parts, local)
    if rank == 0:
        np.save(out, torch.cat(parts).numpy())
    assert "jax" not in sys.modules, "the port imported jax"
    assert not [m for m in sys.modules if m == "stereo_match_tpu"
                or m.startswith("stereo_match_tpu.")]
finally:
    dist.destroy_process_group()
print(f"rank {{rank}} OK")
"""


def test_two_process_gloo_run(tmp_path):
    """Two OS processes in a gloo group over localhost: each loads and
    matches its own 4 frames; the gathered rows equal the single-process
    run on a simulated 2 x 2 mesh."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER.format(H=H, W=W))
    out = tmp_path / "gathered.npy"
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    procs = [subprocess.Popen([sys.executable, str(worker), str(rank),
                               str(port), str(out)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env, text=True)
             for rank in range(2)]
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for rank, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{text}"
        assert f"rank {rank} OK" in text
    frames = _dataset(8)
    lefts = np.stack([f[0] for f in frames])
    rights = np.stack([f[1] for f in frames])
    mesh = make_host_mesh(n_hosts=2, devices=_cpus(4))
    raw, _ = batched_matcher_multihost(DisparityConfig(**_cfg_kw()), mesh)(
        load_host_sharded(lambda i: lefts[i], 8, mesh, (H, W)),
        load_host_sharded(lambda i: rights[i], 8, mesh, (H, W)))
    np.testing.assert_array_equal(np.load(out), raw.local().numpy())

