"""Data, tensor and spatial parallelism over ``torch.distributed`` (port of
``multimodal_alzheimer_tpu/parallel``): ``mesh.py`` the data-parallel mesh,
``tp.py`` the (data, model, spatial) mesh with channel- and depth-sharded
layers."""

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
from multimodal_alzheimer_tpu_torch.parallel.tp import (
    MODEL_AXIS,
    SPATIAL_AXIS,
    BatchShard3D,
    Mesh3D,
    gather_state,
    make_mesh_3d,
    shard_batch_3d,
    shard_state,
    tensor_parallel,
)

__all__ = ["DATA_AXIS", "make_mesh", "batch_sharding",
           "replicated_sharding", "replicate", "shard_batch", "Mesh",
           "BatchShard", "all_reduce_sum", "current", "data_parallel",
           "gather_rows", "MODEL_AXIS", "SPATIAL_AXIS", "Mesh3D",
           "BatchShard3D", "make_mesh_3d", "shard_state", "gather_state",
           "shard_batch_3d", "tensor_parallel"]
