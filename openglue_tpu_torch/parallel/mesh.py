"""Device mesh over the processes of a ``torch.distributed`` job and the
data-parallel step (port of ``openglue_tpu/parallel/mesh.py``).

Each process drives one device; a mesh names axes over the processes. The
``data`` axis cuts the global batch: each data rank holds its contiguous rows
(``local_batch_slice``, ``shard_batch``), and ``shard_train_step`` makes a
rank's step compute what one process computes on the whole batch: the loss
is the global one, the parameter gradients are summed over every rank after
backward, the BatchNorm statistics are those of the whole batch, and every
rank takes the same Adam update. The ``model`` axis carries keypoint-axis
context parallelism (the ring schedule of ``parallel/ring.py``, chosen by
``SuperGlueConfig.ring_axis``, or the all-gather route;
``context_parallel.shard_train_step_cp``) or tensor parallelism
(``tensor_parallel``).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from openglue_tpu_torch.core.types import PairBatch, map_tensors
from openglue_tpu_torch.parallel.distributed import MeshGroups

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(axis_sizes: Optional[Mapping[str, int]] = None, device_type: str = "cuda") -> DeviceMesh:
    """A mesh over every process of the initialized job (``distributed.
    initialize``). ``axis_sizes`` maps axis name -> size; one axis may be -1
    to take the remaining processes. Default: every process on ``data``.
    ``device_type`` is "cuda" or "cpu"; the collectives run on the job's
    backend."""
    world = dist.get_world_size()
    if axis_sizes is None:
        axis_sizes = {DATA_AXIS: world}
    names = tuple(axis_sizes)
    sizes = [int(s) for s in axis_sizes.values()]
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        sizes[sizes.index(-1)] = world // max(known, 1)
    if math.prod(sizes) != world:
        raise ValueError(f"Mesh {dict(zip(names, sizes))} needs {math.prod(sizes)} processes, have {world}")
    return init_device_mesh(device_type, tuple(sizes), mesh_dim_names=names)


def axis_size_rank(mesh: DeviceMesh, name: str) -> Tuple[int, int]:
    """(size, this process's rank) of the mesh's axis ``name``; (1, 0) when
    the mesh has no such axis."""
    names = mesh.mesh_dim_names or ()
    if name not in names:
        return 1, 0
    return mesh.size(names.index(name)), mesh.get_local_rank(name)


def mesh_groups(mesh: Optional[DeviceMesh]) -> MeshGroups:
    """The groups a step of a rank of ``mesh`` reduces over (none without a
    mesh: one process)."""
    if mesh is None:
        return MeshGroups()

    def axis(name):
        return mesh.get_group(name) if axis_size_rank(mesh, name)[0] > 1 else None

    return MeshGroups(axis(DATA_AXIS), axis(MODEL_AXIS), dist.group.WORLD if mesh.size() > 1 else None)


def local_batch_slice(global_batch_size: int, mesh: Optional[DeviceMesh] = None) -> Tuple[int, int]:
    """[start, stop) of this rank's rows of the global batch: by its rank on
    the mesh's ``data`` axis, or without a mesh by its rank in the job (one
    process: the whole batch). A batch that does not divide raises."""
    if mesh is not None:
        size, rank = axis_size_rank(mesh, DATA_AXIS)
    elif dist.is_initialized():
        size, rank = dist.get_world_size(), dist.get_rank()
    else:
        size, rank = 1, 0
    if global_batch_size % size:
        raise ValueError(f"global batch {global_batch_size} not divisible by {size} data ranks")
    per_rank = global_batch_size // size
    return rank * per_rank, (rank + 1) * per_rank


def batch_size(batch: Any) -> int:
    """The leading (batch) length of a pair batch or an online image batch."""
    return batch.side0.keypoints.shape[0] if isinstance(batch, PairBatch) else batch["image0"].shape[0]


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This process's device of ``mesh``: its current card on "cuda"."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def shard_batch(batch: Any, mesh: DeviceMesh) -> Any:
    """This rank's rows of a global batch (``local_batch_slice``), on this
    rank's device."""
    start, stop = local_batch_slice(batch_size(batch), mesh)
    device = mesh_device(mesh)
    return map_tensors(batch, lambda t: t[start:stop].to(device))


def shard_train_step(train_step: Callable, mesh: Optional[DeviceMesh]) -> Callable:
    """A ``(state, batch) -> metrics`` step for each rank of ``mesh`` (the
    port of JAX's ``shard_train_step``, whose replicated state and
    data-sharded batch make XLA sum the gradients). ``batch`` is this rank's
    rows (``shard_batch``, or a loader of this rank's rows). The first time
    it meets a state the state is made the mesh's
    (``TrainState.replicate``: rank 0's parameters and buffers on every
    rank, the BatchNorm statistics over every rank, the groups the step
    reduces over); the metrics are then the global batch's on every rank.
    Without a mesh (one process) this is ``train_step``."""
    if mesh is None:
        return train_step
    groups = mesh_groups(mesh)

    def step(state, batch):
        if state.groups != groups:
            state.replicate(groups)
        return train_step(state, batch)

    return step


def shard_eval_step(eval_step: Callable, mesh: Optional[DeviceMesh]) -> Callable:
    """A ``(state, batch) -> outputs`` eval step over a GLOBAL batch (the port
    of JAX's ``shard_eval_step``): each rank evaluates its contiguous share of
    the rows, and the outputs of every row come back to every rank, as one
    process computes them. The rows are split as evenly as they go, so a
    batch that does not divide, such as a validation tail smaller than the
    data axis, is evaluated whole by the ranks that get rows. Without a mesh
    this is ``eval_step``."""
    if mesh is None:
        return eval_step
    size, rank = axis_size_rank(mesh, DATA_AXIS)
    data_group = mesh.get_group(DATA_AXIS) if size > 1 else None

    def step(state, batch):
        if data_group is None:
            return eval_step(state, batch)
        bounds = np.linspace(0, batch_size(batch), size + 1).round().astype(int)
        start, stop = int(bounds[rank]), int(bounds[rank + 1])
        device = mesh_device(mesh)
        mine = None
        if stop > start:
            out = eval_step(state, map_tensors(batch, lambda t: t[start:stop].to(device)))
            mine = {k: v.cpu() for k, v in out.items()}
        parts = [None] * size
        dist.all_gather_object(parts, mine, group=data_group)
        parts = [p for p in parts if p is not None]
        return {k: torch.cat([p[k] for p in parts]).to(device) for k in parts[0]}

    return step
