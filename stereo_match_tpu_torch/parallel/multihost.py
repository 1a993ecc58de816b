"""Multi-process execution: ("host", "chip") meshes and per-host loading.

Counterpart of ``stereo_match_tpu/parallel/multihost.py``. JAX gives the
boundary between hosts its own mesh axis; so does the port, with one
process per host (or per card) in a ``torch.distributed`` group
(:func:`initialize_multihost`), each process driving its own devices over
a device list as the rest of ``parallel/`` does:

* ``"host"`` — one row per process (rank k's devices form row k),
* ``"chip"`` — that process's devices.

Data parallelism splits the frame batch over both axes host-major, so the
rows of the global batch that sit on host k's chips are exactly the rows
host k's process loads: no input crosses processes, and matching needs no
collective at all. A process that wants every row gathers them itself
(``torch.distributed.all_gather``).

Everything here also runs in one process, where ``n_hosts`` splits the
device list into simulated host groups, as JAX's tests do.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from stereo_match_tpu_torch.config import DisparityConfig
from stereo_match_tpu_torch.parallel.mesh import (  # noqa: F401
    DeviceMesh, Split, initialize_multihost, mesh_devices, named_mesh)
from stereo_match_tpu_torch.pipeline.stereo import _match_core, check_slice


def _world() -> tuple[int, int]:
    """(world size, rank) of the process group; (1, 0) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_host_mesh(n_hosts: int | None = None, devices=None) -> DeviceMesh:
    """A ("host", "chip") mesh.

    In a process group of several ranks (``n_hosts`` None or the world
    size), row k is rank k's devices as rank k lists them: ``devices``
    (default: its visible CUDA cards), gathered from every rank with
    ``all_gather_object``; the ranks must list as many devices each. In
    one process, ``n_hosts`` (default 1) splits ``devices`` (default: the
    cards) into that many simulated hosts, in order; it must divide their
    number.
    """
    world, _ = _world()
    local = mesh_devices(devices)
    if world > 1:
        if n_hosts not in (None, world):
            raise ValueError(f"n_hosts={n_hosts} in a group of {world} "
                             "processes")
        rows: list = [None] * world
        dist.all_gather_object(rows, [str(d) for d in local])
        if len({len(r) for r in rows}) != 1:
            raise ValueError(f"the hosts list unequal device counts: "
                             f"{[len(r) for r in rows]}")
        return named_mesh([d for r in rows for d in r],
                          (world, len(local)), ("host", "chip"))
    n_hosts = 1 if n_hosts is None else n_hosts
    if n_hosts < 1 or len(local) % n_hosts:
        raise ValueError(f"{len(local)} devices not divisible by "
                         f"{n_hosts} hosts")
    return named_mesh(local, (n_hosts, len(local) // n_hosts),
                      ("host", "chip"))


def batch_sharding(mesh: DeviceMesh) -> Split:
    """Leading-axis batch split over host x chip (host-major)."""
    return Split(mesh, ("host", "chip"), 0)


def host_local_slice(n_items: int, host_index: int, n_hosts: int) -> slice:
    """The contiguous rows of the global batch owned by ``host_index``:
    :func:`batch_sharding`'s host-major layout, so a process that loads
    exactly this slice feeds its own chips and nothing else."""
    if n_items % n_hosts:
        raise ValueError(f"batch {n_items} not divisible by {n_hosts} hosts")
    per = n_items // n_hosts
    return slice(host_index * per, (host_index + 1) * per)


@dataclass(frozen=True)
class HostBatch:
    """The rows of a global (n_items, ...) batch that this process holds:
    ``shards[k]`` is rows ``bounds[k]`` ([lo, hi)) on its device, one shard
    a device of this process's part of the mesh, in batch order."""
    shards: tuple[torch.Tensor, ...]
    bounds: tuple[tuple[int, int], ...]
    n_items: int

    def local(self, device: torch.device | str | None = None
              ) -> torch.Tensor:
        """This process's rows joined on ``device`` (default: the first
        shard's)."""
        device = self.shards[0].device if device is None else device
        return torch.cat([s.to(device) for s in self.shards])


def load_host_sharded(load_fn, n_items: int, mesh: DeviceMesh,
                      item_shape: tuple[int, ...],
                      dtype=np.float32) -> HostBatch:
    """This process's rows of a global (n_items, *item_shape) batch, each
    host loading only its own.

    ``load_fn(global_index) -> array`` is the per-item read. In a group of
    several processes, rank k calls it for its :func:`host_local_slice`
    only and places the rows on its chips in equal parts. In one process
    (simulated hosts included), every host group's rows are loaded and
    placed device by device over the flattened mesh, as JAX's
    single-process branch does.
    """
    world, rank = _world()
    n_hosts = mesh.shape["host"]
    if world > 1:
        sl = host_local_slice(n_items, rank, n_hosts)
        devices = list(mesh.devices[rank])
        lo, n = sl.start, sl.stop - sl.start
    else:
        devices = batch_sharding(mesh).devices()
        lo, n = 0, n_items
    if n < 1 or n % len(devices):
        raise ValueError(f"{n} rows not divisible by {len(devices)} "
                         "devices")
    per = n // len(devices)
    bounds = tuple((lo + k * per, lo + (k + 1) * per)
                   for k in range(len(devices)))
    shards = []
    for dev, (a, b) in zip(devices, bounds):
        rows = [np.asarray(load_fn(i), dtype) for i in range(a, b)]
        for row in rows:
            if row.shape != tuple(item_shape):
                raise ValueError(f"load_fn gave {row.shape}, expected "
                                 f"{tuple(item_shape)}")
        shards.append(torch.from_numpy(np.stack(rows)).to(dev))
    return HostBatch(tuple(shards), bounds, n_items)


def batched_matcher_multihost(config: DisparityConfig, mesh: DeviceMesh):
    """Data-parallel matcher over the flattened ("host", "chip") batch.

    Returns ``fn(lefts, rights) -> (raw, filtered)`` on
    :func:`load_host_sharded` batches: each device matches the rows it
    holds with the single-card ``_match_core`` (K1-K4 and the configured
    post stack), the program of ``parallel.batch.batched_matcher``, with no
    collective. ``raw`` and ``filtered`` are :class:`HostBatch` es of this
    process's rows, each shard on its input's device.
    """
    check_slice(config)

    def fn(lefts: HostBatch, rights: HostBatch
           ) -> tuple[HostBatch, HostBatch]:
        if not (isinstance(lefts, HostBatch)
                and isinstance(rights, HostBatch)):
            raise TypeError("the multihost matcher takes load_host_sharded "
                            "batches")
        if lefts.bounds != rights.bounds:
            raise ValueError(f"left rows {lefts.bounds} and right rows "
                             f"{rights.bounds} differ")
        raws, filtered = [], []
        for ls, rs in zip(lefts.shards, rights.shards):
            outs = [_match_core(l, r, config) for l, r in zip(ls, rs)]
            raws.append(torch.stack([raw for raw, _ in outs]))
            filtered.append(torch.stack([filt for _, filt in outs]))
        return (HostBatch(tuple(raws), lefts.bounds, lefts.n_items),
                HostBatch(tuple(filtered), lefts.bounds, lefts.n_items))

    return fn
