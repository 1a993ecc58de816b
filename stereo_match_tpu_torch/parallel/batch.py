"""Data-parallel stereo matching: a batch of pairs across the mesh.

Counterpart of ``stereo_match_tpu/parallel/batch.py``: each device of the
mesh's "batch" axis matches its share of the frames with the single-card
pipeline (``_match_core``); no data crosses devices while matching.
"""

from __future__ import annotations

import torch

from stereo_match_tpu_torch.config import DisparityConfig
from stereo_match_tpu_torch.parallel.mesh import DeviceMesh, batch_sharding
from stereo_match_tpu_torch.pipeline.stereo import _match_core, check_slice


def batched_matcher(config: DisparityConfig, mesh: DeviceMesh):
    """A matcher over the mesh's "batch" axis.

    Returns ``fn(lefts, rights) -> (raw, filtered)`` for (B, H, W) inputs
    (numpy arrays or tensors); B must be divisible by the batch-axis size.
    Device k matches frames ``[k * B / n, (k + 1) * B / n)``; the results
    are stacked on the first device of the axis.
    """
    check_slice(config)
    split = batch_sharding(mesh)
    n = mesh.shape["batch"]

    def fn(lefts, rights):
        lefts = torch.as_tensor(lefts, dtype=torch.float32)
        rights = torch.as_tensor(rights, dtype=torch.float32)
        if lefts.shape[0] % n:
            raise ValueError(f"batch of {lefts.shape[0]} frames is not "
                             f"divisible by the {n} devices of the batch "
                             "axis")
        raws, filtered = [], []
        for ls, rs in zip(split.shards(lefts), split.shards(rights)):
            outs = [_match_core(l, r, config) for l, r in zip(ls, rs)]
            raws.append(torch.stack([raw for raw, _ in outs]))
            filtered.append(torch.stack([filt for _, filt in outs]))
        out = split.devices()[0]
        return split.gather(raws, out), split.gather(filtered, out)

    return fn
