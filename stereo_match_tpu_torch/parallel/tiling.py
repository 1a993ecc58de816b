"""Row-sharded SGM: spatial tiling over a device list with carry hand-off.

Counterpart of ``stereo_match_tpu/parallel/tiling.py``, in one process.
SGM's directional recurrences are sequential along their path, so sharding
image rows cuts every *horizontal* scan into local work, while *vertical
and diagonal* scans must chain a carry — the (D, W) L of the shard's
scan-order-last row — from each shard to the next. The local scans are the
single-card kernel, K3 (``ops/cuda_kernels.sgm_path_scan``), with its
``init_carry`` / ``return_carry``; on CPU tensors its plain version.

Two modes:

* ``exact`` — a sequential chain: shard k scans with shard k-1's carry
  (top to bottom for the downward directions, bottom to top for the upward
  ones), the carry moving with ``.to(next_device)``. The directions are
  added in ``PATH_DIRECTIONS_8`` order, as ``aggregate_paths`` adds them,
  so the total equals the single-card K3 total bit for bit, on any costs.
* ``halo`` — shard k also scans ``halo`` rows copied from its scan-order
  predecessor, from a zero carry, and drops them. The recurrence forgets
  its initial state geometrically (P2 clamps the influence), so a 32–64
  row halo makes the boundary effects all but invisible, and no shard
  waits for another.

The shards are JAX's: shard height ``ceil(H / (rows * unit)) * unit`` with
unit the TPU's sublane block in exact mode (8 rows float32, 16 int16) and
1 in halo mode, the last shard shorter. JAX pads the last shard with zero
rows; those keep a zero carry, so the results equal JAX's after its slice
without the padding here.

:func:`sgm_aggregate_blocks` is the scan over blocks that already sit on
their devices (JAX's ``_local_sgm``), which ``parallel/dsharding.py``
calls after its plane-to-row re-shard; :func:`sgm_aggregate_sharded`
cuts a whole volume into such blocks first.
"""

from __future__ import annotations

import torch

from stereo_match_tpu_torch.ops.cuda_kernels import sgm_path_scan
from stereo_match_tpu_torch.ops.sgm import PATH_DIRECTIONS_8
from stereo_match_tpu_torch.parallel.mesh import DeviceMesh, volume_sharding


def _chain(local, totals, devices, dy, dx, p1, p2, accumulate, scan):
    """Exact cross-shard scan of one direction: carry shard to shard."""
    order = range(len(local)) if dy > 0 else range(len(local) - 1, -1, -1)
    carry = None
    for k in order:
        init = None if carry is None else carry.to(devices[k])
        _, carry = scan(local[k], totals[k], dy, dx, p1, p2, accumulate,
                        init_carry=init, return_carry=True)


def _halo_scan(local, totals, dy, dx, p1, p2, accumulate, halo, scan):
    """Approximate cross-shard scan: warm up through ``halo`` rows copied
    from the scan-order predecessor block (none for the first)."""
    n = len(local)
    for k, (block, total) in enumerate(zip(local, totals)):
        skip = 0
        if dy > 0 and k > 0:      # the predecessor's last rows come first
            warm = local[k - 1][:, -halo:]
            ext = torch.cat([warm.to(block.device), block], dim=1)
            skip = warm.shape[1]
        elif dy < 0 and k < n - 1:   # the successor's first rows, reversed
            ext = torch.cat([block, local[k + 1][:, :halo].to(block.device)],
                            dim=1)
        else:
            ext = block
        L = torch.empty_like(ext)
        scan(ext, L, dy, dx, p1, p2, accumulate=False)
        part = L[:, skip:skip + block.shape[1]]
        if accumulate:
            total.add_(part)
        else:
            total.copy_(part)


def check_modes(num_paths: int, mode: str) -> None:
    """Raise unless ``num_paths`` is 2, 4 or 8 and ``mode`` exact or halo."""
    if num_paths not in (2, 4, 8):
        raise ValueError("num_paths must be 2, 4 or 8")
    if mode not in ("exact", "halo"):
        raise ValueError("mode must be 'exact' or 'halo'")


def sgm_aggregate_blocks(local: list[torch.Tensor], p1: float, p2: float,
                         num_paths: int = 8, mode: str = "exact",
                         halo: int = 48,
                         scan=sgm_path_scan) -> list[torch.Tensor]:
    """The SGM totals of row blocks that already sit on their devices.

    Counterpart of JAX's ``_local_sgm`` (what runs inside its shard_map):
    ``local`` are the (D, H_k, W) float32 or int16 blocks of one volume in
    row order, contiguous, each on its shard's device, every block but the
    last of one height. Returns each block's total on its device. The
    horizontal directions run block by block; the others chain their
    carry (``exact``) or warm up through ``min(halo, H_0)`` rows of the
    neighbouring block (``halo``), as the module doc says.
    """
    check_modes(num_paths, mode)
    devices = [block.device for block in local]
    totals = [torch.empty_like(block) for block in local]
    h = max(1, min(halo, local[0].shape[1]))   # JAX's local height bounds it
    for i, (dy, dx) in enumerate(PATH_DIRECTIONS_8[:num_paths]):
        accumulate = i > 0
        if dy == 0:
            for c, t in zip(local, totals):
                scan(c, t, dy, dx, p1, p2, accumulate)
        elif mode == "exact":
            _chain(local, totals, devices, dy, dx, p1, p2, accumulate, scan)
        else:
            _halo_scan(local, totals, dy, dx, p1, p2, accumulate, h, scan)
    return totals


def sgm_aggregate_sharded(cost: torch.Tensor, p1: float, p2: float,
                          mesh: DeviceMesh, num_paths: int = 8,
                          mode: str = "exact", halo: int = 48,
                          scan=sgm_path_scan) -> torch.Tensor:
    """Row-sharded SGM total of ``cost`` over ``mesh``'s "rows" axis.

    ``cost``: (D, H, W) float32 or int16 (other dtypes become float32).
    Shard k runs on the k-th device of the "rows" axis (first "batch"
    index); the total (of the volume's dtype) is returned on ``cost``'s
    device. ``mode``: "exact" (bit-equal to the single-card total) or
    "halo" (independent shards, warmed up through ``halo`` rows). ``scan``
    is K3 by default; ``cuda_kernels.sgm_path_scan_plain`` gives the plain
    version on any device.
    """
    check_modes(num_paths, mode)
    if cost.dtype not in (torch.float32, torch.int16):
        cost = cost.to(torch.float32)
    cost = cost.contiguous()
    split = volume_sharding(mesh)
    unit = (8 if cost.dtype == torch.float32 else 16) \
        if mode == "exact" else 1
    local = [cost[:, lo:hi].contiguous().to(dev) for dev, (lo, hi)
             in zip(split.devices(), split.bounds(cost.shape[1], unit))
             if hi > lo]
    totals = sgm_aggregate_blocks(local, p1, p2, num_paths, mode, halo, scan)
    return torch.cat([t.to(cost.device) for t in totals], dim=1)
