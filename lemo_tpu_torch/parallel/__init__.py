"""Scale-out over cards, one process per card (`torch.distributed`)."""

from lemo_tpu_torch.parallel.sharding import (  # noqa: F401
    clip_sharded_fit,
    data_parallel_step,
    initialize_multihost,
    make_mesh,
    make_pod_mesh,
    shard_frames,
)
