"""Multi-device and multi-process fitting (port of
``nestfit_tpu/parallel``): the ``(dp, sp)`` device mesh and the
per-process pixel stripes."""

from nestfit_tpu_torch.parallel.mesh import (
    Mesh,
    ShardedBatch,
    make_mesh,
    pad_to_multiple,
    pixel_sharding,
    replicated,
    shard_pixel_batch,
)
from nestfit_tpu_torch.parallel.distributed import (
    host_chunk_name,
    host_pixel_shard,
    host_pixel_stripe,
    initialize_distributed,
)
