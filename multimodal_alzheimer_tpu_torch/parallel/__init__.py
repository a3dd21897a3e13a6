"""Data parallelism over ``torch.distributed`` (port of
``multimodal_alzheimer_tpu/parallel``; ``tp.py``, channel and depth
sharding, is not ported yet)."""

from multimodal_alzheimer_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    BatchShard,
    Mesh,
    all_reduce_sum,
    batch_sharding,
    current,
    data_parallel,
    gather_rows,
    make_mesh,
    replicate,
    replicated_sharding,
    shard_batch,
)

__all__ = ["DATA_AXIS", "make_mesh", "batch_sharding",
           "replicated_sharding", "replicate", "shard_batch", "Mesh",
           "BatchShard", "all_reduce_sum", "current", "data_parallel",
           "gather_rows"]
