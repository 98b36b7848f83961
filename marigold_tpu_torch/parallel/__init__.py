from marigold_tpu_torch.parallel.mesh import (
    data_parallel_sharding,
    get_mesh,
    replicate,
    shard_batch,
)

__all__ = ["get_mesh", "shard_batch", "replicate", "data_parallel_sharding"]
