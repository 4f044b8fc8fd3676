"""Data parallelism and keypoint-axis context parallelism over
``torch.distributed`` (port of ``openglue_tpu/parallel``): start-up, meshes
and their groups, the data-parallel step, the ring schedule and the sharding
of pair batches."""

from openglue_tpu_torch.parallel.context_parallel import (
    gather_pair_batch, gather_rows, shard_pair_batch_cp, shard_train_step_cp,
)
from openglue_tpu_torch.parallel.distributed import MeshGroups, barrier, data_parallel_world_size, initialize
from openglue_tpu_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, local_batch_slice, make_mesh, mesh_groups, shard_batch, shard_eval_step,
    shard_train_step,
)

__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "MeshGroups", "barrier", "data_parallel_world_size", "gather_pair_batch",
    "gather_rows", "initialize", "local_batch_slice", "make_mesh", "mesh_groups", "shard_batch",
    "shard_eval_step", "shard_pair_batch_cp", "shard_train_step", "shard_train_step_cp",
]
