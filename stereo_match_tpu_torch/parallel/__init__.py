"""Parallel modes over a list of devices, and over processes.

Counterpart of ``stereo_match_tpu/parallel``: the row-tiled SGM, the
data-parallel batch matcher, the stage-pipelined stream and the D-sharded
matcher (``dsharding``) run in one process over a device list;
``multihost`` adds the ("host", "chip") meshes of a ``torch.distributed``
group of processes.
"""

from stereo_match_tpu_torch.parallel.mesh import (  # noqa: F401
    DeviceMesh, batch_sharding, image_sharding, initialize_multihost,
    make_mesh, volume_sharding,
)
from stereo_match_tpu_torch.parallel.tiling import (  # noqa: F401
    sgm_aggregate_sharded,
)
from stereo_match_tpu_torch.parallel.batch import batched_matcher  # noqa: F401
from stereo_match_tpu_torch.parallel.pipeline_stage import (  # noqa: F401
    StreamingPipeline, make_stage_mesh,
)
from stereo_match_tpu_torch.parallel.multihost import (  # noqa: F401
    HostBatch, batched_matcher_multihost, host_local_slice,
    load_host_sharded, make_host_mesh,
)
