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
* ``"stage"`` — the stages of ``parallel/pipeline_stage.py``.

A device may appear several times, but only where the caller lists it
(``devices=["cuda:0"] * 4`` runs a 4-shard chain on one card). The default
is the visible CUDA devices, and a mesh larger than the list raises:
nothing falls back silently. Multi-host runs (``initialize_multihost``)
are not ported; they will use ``torch.distributed`` (ROADMAP.md).
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
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return DeviceMesh(arr.reshape(batch, rows), ("batch", "rows"))


@dataclass(frozen=True)
class Split:
    """A tensor split along ``dim`` over the mesh axis ``axis``.

    Shard k holds the k-th block of ``ceil(n / shards)`` entries (the last
    one shorter, or empty) on the k-th device along ``axis`` (of the first
    index of the other axes), as a ``NamedSharding`` lays out a padded
    array.
    """
    mesh: DeviceMesh
    axis: str
    dim: int

    def devices(self) -> list[torch.device]:
        k = self.mesh.axis_names.index(self.axis)
        index = [0] * self.mesh.devices.ndim
        index[k] = slice(None)
        return list(self.mesh.devices[tuple(index)])

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
