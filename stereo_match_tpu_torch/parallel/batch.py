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
from stereo_match_tpu_torch.utils.profiling import count, span


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
        if len(lefts) % n:
            raise ValueError(f"batch of {len(lefts)} frames is not "
                             f"divisible by the {n} devices of the batch "
                             "axis")
        from_host = not (torch.is_tensor(lefts) and lefts.is_cuda)
        with span("smt.upload"):
            lshards, rshards = (
                split.shards(torch.as_tensor(a, dtype=torch.float32))
                for a in (lefts, rights))
        count("upload_bytes", sum(t.nbytes for t in lshards + rshards
                                  if from_host and t.is_cuda))
        raws, filtered = [], []
        for ls, rs in zip(lshards, rshards):
            outs = [_match_core(l, r, config) for l, r in zip(ls, rs)]
            raws.append(torch.stack([raw for raw, _ in outs]))
            filtered.append(torch.stack([filt for _, filt in outs]))
        out = split.devices()[0]
        return split.gather(raws, out), split.gather(filtered, out)

    return fn
