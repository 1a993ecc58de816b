"""Parallel modes over a list of devices, in one process.

Counterpart of ``stereo_match_tpu/parallel`` without ``multihost`` (and
without ``dsharding``): the row-tiled SGM, the data-parallel batch matcher
and the stage-pipelined stream.
"""

from stereo_match_tpu_torch.parallel.mesh import (  # noqa: F401
    DeviceMesh, batch_sharding, image_sharding, make_mesh, volume_sharding,
)
from stereo_match_tpu_torch.parallel.tiling import (  # noqa: F401
    sgm_aggregate_sharded,
)
from stereo_match_tpu_torch.parallel.batch import batched_matcher  # noqa: F401
from stereo_match_tpu_torch.parallel.pipeline_stage import (  # noqa: F401
    StreamingPipeline, make_stage_mesh,
)
