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
most ``max_iters`` times. Sizes are then the count of valid pixels per
label. If the last sweep still changed a label, the fixpoint was not
reached and the filter keeps every valid pixel, as the reference does.

The whole filter is K5 (``ops/cuda_kernels.speckle_filter``): on a CUDA
tensor one kernel launch runs the sweeps to the fixpoint, the count and
the threshold, with no host sync; a CPU tensor runs its plain version,
``speckle_fixpoint_plain``, which reads the changed flag once a sweep.
The packed connectivity (``K.connectivity``) is the plain version's.
"""

from __future__ import annotations

import torch

from stereo_match_tpu_torch.ops import cuda_kernels as K


def speckle_filter(disparity: torch.Tensor, max_speckle_size: int,
                   max_diff: float, max_iters: int = 64) -> torch.Tensor:
    """Invalidate (NaN) connected components smaller than max_speckle_size.

    ``max_speckle_size <= 0`` disables the filter (the settings.ini
    default) and returns the input; otherwise the tensor's device decides,
    as for every kernel wrapper.
    """
    if max_speckle_size <= 0:
        return disparity
    d = disparity.to(torch.float32).contiguous()
    return K.speckle_filter(d, max_speckle_size, max_diff, max_iters)[0]
