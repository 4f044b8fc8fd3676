"""Keypoint-axis context parallelism for the whole model (port of
``openglue_tpu/parallel/context_parallel.py``).

In the JAX package a pair batch is placed with its keypoint axis sharded over
the ``model`` mesh axis and GSPMD partitions the model, around the ring's
``shard_map``s with ``ring_axis``. Here each rank runs its own program on its
contiguous slice of the keypoints (``shard_pair_batch_cp``); ``SuperGlue`` on
the mesh (with ``ring_axis``: the ring; without, on a ``model`` axis of
several ranks: the all-gather route) makes the collectives the global program
needs, and ``gather_rows`` / ``gather_pair_batch`` put whole tensors together
where a caller needs them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch.distributed.device_mesh import DeviceMesh

from openglue_tpu_torch.core.types import PairBatch, map_tensors
from openglue_tpu_torch.parallel.distributed import all_gather
from openglue_tpu_torch.parallel.mesh import MODEL_AXIS, axis_size_rank, local_batch_slice, shard_train_step

_KEYPOINT_FIELDS = ("keypoints", "descriptors", "side_info", "mask")


def shard_pair_batch_cp(batch: PairBatch, mesh: DeviceMesh) -> PairBatch:
    """This rank's shard of a global pair batch: its rows by its rank on the
    ``data`` axis (``local_batch_slice``), and of those rows its contiguous
    slice of the keypoints of both images by its rank on the ``model`` axis
    (keypoints, descriptors, side info, masks, per-keypoint depths); image
    sizes, the homography or the pose and intrinsics, and dense depth maps
    keep every keypoint. Both keypoint counts must divide by the ``model``
    axis."""
    if MODEL_AXIS not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"the mesh has no {MODEL_AXIS!r} axis: {mesh.mesh_dim_names}")
    size, rank = axis_size_rank(mesh, MODEL_AXIS)
    start, stop = local_batch_slice(batch.side0.keypoints.shape[0], mesh)
    batch = map_tensors(batch, lambda t: t[start:stop])

    def cut(x):
        n = x.shape[1]
        if n % size:
            raise ValueError(f"{n} keypoints do not divide over a model axis of {size}")
        return x[:, rank * (n // size):(rank + 1) * (n // size)]

    sides = [
        dataclasses.replace(side, **{f: cut(getattr(side, f)) for f in _KEYPOINT_FIELDS})
        for side in (batch.side0, batch.side1)
    ]
    tf = batch.transformation
    if tf is not None and tf.kind == "3d_reprojection":
        tf = dataclasses.replace(tf, **{
            name: cut(d) for name in ("depth0", "depth1")
            if (d := getattr(tf, name)) is not None and d.dim() == 2
        })
    return PairBatch(sides[0], sides[1], tf)


def shard_train_step_cp(train_step: Callable, mesh: DeviceMesh) -> Callable:
    """A ``(state, batch) -> metrics`` step over a GLOBAL pair batch for each
    rank of a data x model mesh (port of JAX's ``shard_train_step_cp``): the
    rank takes its shard (``shard_pair_batch_cp``) and runs
    ``mesh.shard_train_step``'s step, so that the attention reaches every
    key over the ``model`` group while the BatchNorm statistics, the loss's
    value and the gradients are summed over both axes. The model is a
    ``SuperGlue`` on ``mesh``, with ``ring_axis`` (the ring) or without (the
    all-gather route)."""
    step = shard_train_step(train_step, mesh)
    return lambda state, batch: step(state, shard_pair_batch_cp(batch, mesh))


def gather_pair_batch(batch: PairBatch, group) -> PairBatch:
    """The whole pair batch from every rank's shard (the inverse of
    ``shard_pair_batch_cp``), on every rank, without gradient."""
    with torch.no_grad():
        sides = [
            dataclasses.replace(side, **{f: all_gather(getattr(side, f), group) for f in _KEYPOINT_FIELDS})
            for side in (batch.side0, batch.side1)
        ]
        tf = batch.transformation
        if tf is not None and tf.kind == "3d_reprojection":
            tf = dataclasses.replace(tf, **{
                name: all_gather(d, group) for name in ("depth0", "depth1")
                if (d := getattr(tf, name)) is not None and d.dim() == 2
            })
    return PairBatch(sides[0], sides[1], tf)


def gather_rows(scores: torch.Tensor, group) -> torch.Tensor:
    """[B, n_loc + 1, M + 1] (this rank's rows of the log-assignment, then the
    replicated dustbin row) -> the whole [B, N + 1, M + 1], on every rank."""
    return torch.cat([all_gather(scores[:, :-1], group), scores[:, -1:]], dim=1)
