"""Speckle filtering: remove small connected blobs of outlier disparity.

Counterpart of ``stereo_match_tpu/ops/speckle.py`` (its XLA path, which the
JAX package's Pallas kernel equals): OpenCV ``filterSpeckles`` semantics.
Two pixels are connected when 4-adjacent, both finite, and
``|d_a - d_b| <= max_diff``; components of fewer than ``max_speckle_size``
pixels become NaN.

Components come from min-label flood fill by segmented min scans. Labels
start as the linear index ``y * W + x`` (``H * W + 1`` for invalid pixels);
one sweep runs the x-forward, x-reverse, y-forward and y-reverse scans, each
restarting its running minimum where a pixel is not connected to its
scan-order predecessor. Sweeps repeat while one of them lowers a label, at
most ``max_iters`` times. Sizes are then the count of pixels per label. If
the last sweep still changed a label, the fixpoint was not reached and the
filter keeps every valid pixel, as the reference does.

The sweep is K5 and the count + threshold K6 (``ops/cuda_kernels.py``):
CPU tensors run their plain versions, CUDA tensors the kernels. Reading
the changed flag once per sweep is one host sync per sweep.
"""

from __future__ import annotations

import torch

from stereo_match_tpu_torch.ops.cuda_kernels import (CONN_UP, CONN_LEFT,
                                                     speckle_count_keep,
                                                     speckle_sweep)


def _neighbor_shift(x: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """Shift (H, W) by (dy, dx) filling exposed cells."""
    out = torch.roll(x, (dy, dx), dims=(0, 1))
    if dy == 1:
        out[0, :] = fill
    elif dy == -1:
        out[-1, :] = fill
    if dx == 1:
        out[:, 0] = fill
    elif dx == -1:
        out[:, -1] = fill
    return out


def connectivity(d: torch.Tensor, max_diff: float) -> torch.Tensor:
    """(H, W) float32 disparities -> (H, W) uint8 packed connectivity.

    Bit ``CONN_LEFT`` of a pixel is set when it is connected to its left
    neighbour (``conn_x`` of the reference), bit ``CONN_UP`` when it is
    connected to the pixel above (``conn_y``). Invalid pixels compare as
    ``inf``, so they connect to nothing.
    """
    valid = torch.isfinite(d)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=d.device)
    dval = torch.where(valid, d, inf)
    tol = torch.tensor(max_diff, dtype=torch.float32, device=d.device)
    conn_x = valid & ((_neighbor_shift(dval, 0, 1, inf) - dval).abs() <= tol)
    conn_y = valid & ((_neighbor_shift(dval, 1, 0, inf) - dval).abs() <= tol)
    return (conn_x.to(torch.uint8) * CONN_LEFT) | \
        (conn_y.to(torch.uint8) * CONN_UP)


def speckle_filter(disparity: torch.Tensor, max_speckle_size: int,
                   max_diff: float, max_iters: int = 64,
                   sweep=speckle_sweep,
                   count_keep=speckle_count_keep) -> torch.Tensor:
    """Invalidate (NaN) connected components smaller than max_speckle_size.

    ``max_speckle_size <= 0`` disables the filter (the settings.ini
    default) and returns the input. ``sweep`` and ``count_keep`` are K5 and
    K6 by default; ``speckle_sweep_plain`` and ``speckle_count_keep_plain``
    give the plain versions on any device.
    """
    if max_speckle_size <= 0:
        return disparity
    d = disparity.to(torch.float32).contiguous()
    H, W = d.shape
    valid = torch.isfinite(d)
    lin = torch.arange(H * W, dtype=torch.int32, device=d.device).view(H, W)
    labels = torch.where(valid, lin, H * W + 1).to(torch.int32).contiguous()
    conn = connectivity(d, max_diff)
    changed, it = True, 0
    while changed and it < max_iters:
        changed = bool(sweep(labels, conn))        # one host sync per sweep
        it += 1
    return count_keep(d, labels, max_speckle_size, changed)
