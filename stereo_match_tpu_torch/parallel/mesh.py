"""Device meshes and the splits of tensors over their axes (single process).

Counterpart of ``stereo_match_tpu/parallel/mesh.py``. JAX runs one
controller over a list of devices (``jax.sharding.Mesh``); the PyTorch idiom
for that is one process that places each shard's work with ``.to(device)``.
A :class:`DeviceMesh` is a numpy object array of ``torch.device`` with named
axes:

* ``"batch"`` — data parallelism over stereo pairs / video frames,
* ``"rows"``  — spatial tiling of image rows within one pair (the SGM
  vertical and diagonal path state crosses shard boundaries; see
  ``parallel/tiling.py`` for the carry chain),
* ``"stage"`` — the stages of ``parallel/pipeline_stage.py``,
* ``"disp"``  — the disparity planes of ``parallel/dsharding.py``,
* ``"host"``, ``"chip"`` — the processes and each process's cards of
  ``parallel/multihost.py``,
* ``"data"``, ``"model"`` — the MC-CNN trainer's batch and conv output
  channels (``models/mccnn.py``).

A device may appear several times, but only where the caller lists it
(``devices=["cuda:0"] * 4`` runs a 4-shard chain on one card). The default
is the visible CUDA devices, and a mesh larger than the list raises:
nothing falls back silently. Processes (one per host, or one per card)
join a ``torch.distributed`` group through :func:`initialize_multihost`;
within a process the shards are placed with ``.to(device)``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class DeviceMesh:
    """Devices on named axes: ``devices.shape`` follows ``axis_names``."""
    devices: np.ndarray
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))


def mesh_devices(devices=None) -> list[torch.device]:
    """``devices`` as ``torch.device``s; None means the visible CUDA cards."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("no CUDA device is visible: pass devices= "
                               "explicitly (e.g. ['cpu'] * 4)")
    return [torch.device(d) for d in devices]


def named_mesh(devices, shape: tuple[int, ...],
               axis_names: tuple[str, ...]) -> DeviceMesh:
    """``devices`` (default: the CUDA cards) on axes ``axis_names`` of
    sizes ``shape``, in row-major order; their product must be the number
    of devices listed."""
    devs = mesh_devices(devices)
    if len(shape) != len(axis_names):
        raise ValueError(f"shape {shape} does not fit the axes {axis_names}")
    if int(np.prod(shape)) != len(devs):
        raise ValueError(f"a {shape} mesh needs {int(np.prod(shape))} "
                         f"devices, {len(devs)} listed")
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return DeviceMesh(arr.reshape(shape), tuple(axis_names))


def make_mesh(batch: int = 1, rows: int | None = None,
              devices=None) -> DeviceMesh:
    """A ("batch", "rows") mesh over ``devices`` (default: the CUDA cards).

    ``rows`` defaults to len(devices) / batch; ``batch * rows`` must equal
    the number of devices listed.
    """
    devs = mesh_devices(devices)
    n = len(devs)
    if rows is None:
        if n % batch:
            raise ValueError(f"{n} devices not divisible by batch={batch}")
        rows = n // batch
    if batch * rows != n:
        raise ValueError(f"batch*rows = {batch * rows} != {n} devices")
    return named_mesh(devs, (batch, rows), ("batch", "rows"))


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         backend: str = "nccl") -> None:
    """Join the process group of a multi-process run.

    Counterpart of the JAX package's ``initialize_multihost``
    (``jax.distributed.initialize``). A no-op when ``num_processes`` is
    None or at most 1. Otherwise ``torch.distributed.init_process_group``
    over ``tcp://{coordinator_address}`` ("host:port", rank 0's address)
    with ``num_processes`` ranks, this one ``process_id``. ``backend`` is
    ``"nccl"`` (CUDA tensors, one card a rank) unless the caller asks for
    ``"gloo"`` (CPU tensors); it is never picked from what is found, and a
    group that cannot form raises.
    """
    if num_processes is None or num_processes <= 1:
        return
    if coordinator_address is None or process_id is None:
        raise ValueError("a multi-process run needs coordinator_address "
                         "('host:port') and process_id")
    import torch.distributed as dist
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


@dataclass(frozen=True)
class Split:
    """A tensor split along ``dim`` over the mesh axis ``axis``.

    Shard k holds the k-th block of ``ceil(n / shards)`` entries (the last
    one shorter, or empty) on the k-th device along ``axis`` (of the first
    index of the other axes), as a ``NamedSharding`` lays out a padded
    array. A tuple of axes splits over their devices flattened in that
    order (``("host", "chip")``: host-major).
    """
    mesh: DeviceMesh
    axis: str | tuple[str, ...]
    dim: int

    def devices(self) -> list[torch.device]:
        axes = (self.axis,) if isinstance(self.axis, str) else self.axis
        ks = [self.mesh.axis_names.index(a) for a in axes]
        index = tuple(slice(None) if i in ks else 0
                      for i in range(self.mesh.devices.ndim))
        # the kept dims come in mesh order; put them in ``axes``' order
        sub = self.mesh.devices[index].transpose(np.argsort(np.argsort(ks)))
        return list(sub.reshape(-1))

    def bounds(self, n: int, unit: int = 1) -> list[tuple[int, int]]:
        """[lo, hi) of each shard of n entries, shard sizes multiples of
        ``unit`` (but for the last)."""
        shards = len(self.devices())
        size = -(-n // (shards * unit)) * unit
        return [(min(k * size, n), min((k + 1) * size, n))
                for k in range(shards)]

    def shards(self, t: torch.Tensor) -> list[torch.Tensor]:
        """Each shard of ``t``, contiguous, on its device."""
        return [t.narrow(self.dim, lo, hi - lo).contiguous().to(dev)
                for dev, (lo, hi) in zip(self.devices(),
                                         self.bounds(t.shape[self.dim]))]

    def gather(self, parts, device: torch.device | str) -> torch.Tensor:
        """The shards joined along ``dim`` on ``device``."""
        return torch.cat([p.to(device) for p in parts], dim=self.dim)


def batch_sharding(mesh: DeviceMesh) -> Split:
    """Leading-axis split of a batch of images or pairs."""
    return Split(mesh, "batch", 0)


def volume_sharding(mesh: DeviceMesh) -> Split:
    """(D, H, W) cost volume: rows (H) split."""
    return Split(mesh, "rows", 1)


def image_sharding(mesh: DeviceMesh) -> Split:
    """(H, W) image with rows split."""
    return Split(mesh, "rows", 0)
