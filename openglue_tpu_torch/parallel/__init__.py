"""Keypoint-axis context parallelism over ``torch.distributed`` (port of
``openglue_tpu/parallel``): meshes, start-up, the ring schedule and the
sharding of pair batches."""

from openglue_tpu_torch.parallel.context_parallel import gather_pair_batch, gather_rows, shard_pair_batch_cp
from openglue_tpu_torch.parallel.distributed import barrier, initialize
from openglue_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, make_mesh

__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "barrier", "gather_pair_batch", "gather_rows", "initialize",
    "make_mesh", "shard_pair_batch_cp",
]
