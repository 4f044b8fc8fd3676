"""Tensor parallelism for the matcher over the ``model`` mesh axis (port of
``openglue_tpu/parallel/tensor_parallel.py``).

The Megatron layout of each attention and FFN block, over the port's
state-dict names (a ``Conv1x1`` weight is ``[out, in, 1]``):

* the q/k/v projections column-parallel (output channels, that is whole
  heads: channel c belongs to head c // head_dim), their biases with them;
* the out-projection row-parallel (input channels), its bias replicated;
* the FFN's first dense column-parallel, the BatchNorm between the FFN's
  halves on its sharded channels, the second dense row-parallel, its bias
  replicated;
* everything else (the keypoint encoder, ``linear_proj``, the mix and
  dustbin parameters, FAVOR projections) replicated.

In the JAX package GSPMD inserts the collectives; here ``shard_model_tp``
makes the model the program of one rank, which its own forward runs: each
layer's attention holds its H/P heads (with ``use_pallas`` softmax attention
through the attention kernel) and its FFN half the hidden channels, and the
out-projection and the second dense become ``RowParallelConv1x1``: the
partial products summed with one all-reduce, the bias added once after the
sum. The dense products stay plain matmuls: the JAX package computes them in
XLA on this path too. ``tp_forward`` runs the eval forward, as JAX's
``tp_forward_jit`` does.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from openglue_tpu_torch.models.layers import Conv1x1, _compute_dtype
from openglue_tpu_torch.parallel.distributed import all_reduce_sum
from openglue_tpu_torch.parallel.mesh import MODEL_AXIS, axis_size_rank

COLUMN, ROW = 0, 1  # the sharded dimension of a [out, in, 1] weight
_RULES = {
    **{f"mha.in_proj_{x}.{p}": COLUMN for x in "qkv" for p in ("weight", "bias")},
    "mha.out_proj.weight": ROW,
    "fc.0.weight": COLUMN, "fc.0.bias": COLUMN,
    **{f"fc.2.{p}": 0 for p in ("weight", "bias", "running_mean", "running_var")},
    "fc.3.weight": ROW,
}


def shard_dim(name: str) -> Optional[int]:
    """The dimension of the state-dict entry ``name`` that tensor
    parallelism shards over the ``model`` axis; None: replicated."""
    if not name.startswith("attention_gnn.layers."):
        return None
    return _RULES.get(name.split(".module.", 1)[1])


def matcher_param_pspecs(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Optional[int]]:
    """``shard_dim`` of every entry of a matcher's state dict (JAX's
    PartitionSpec tree, over the port's names)."""
    return {name: shard_dim(name) for name in state_dict}


def shard_params_tp(state_dict: Mapping[str, torch.Tensor], mesh: DeviceMesh,
                    axis: str = MODEL_AXIS) -> Dict[str, torch.Tensor]:
    """This rank's state dict: its contiguous slice of every sharded entry
    (by its rank on ``axis``), every other entry as it is."""
    size, rank = axis_size_rank(mesh, axis)
    out = {}
    for name, value in state_dict.items():
        dim = shard_dim(name)
        if dim is not None and value.shape[dim] % size:
            raise ValueError(f"{name} {tuple(value.shape)} does not divide over a {axis} axis of {size}")
        out[name] = value if dim is None else value.chunk(size, dim)[rank].clone()
    return out


class RowParallelConv1x1(Conv1x1):
    """A ``Conv1x1`` whose input channels are sharded over ``group``: this
    rank's partial product, summed over the group by one all-reduce, then the
    (replicated) bias once. Its parameters keep their names."""

    def __init__(self, conv: Conv1x1, group):
        super().__init__(conv.weight.shape[1], conv.weight.shape[0], conv.dtype)
        self.weight, self.bias, self.group = conv.weight, conv.bias, group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute_dtype(x, self.weight, self.dtype)
        partial = torch.matmul(x.to(dt), self.weight[:, :, 0].to(dt).t())
        return all_reduce_sum(partial, self.group) + self.bias.to(dt)


def shard_model_tp(model: torch.nn.Module, mesh: DeviceMesh, axis: str = MODEL_AXIS) -> torch.nn.Module:
    """Make ``model`` (a ``SuperGlue`` whose keypoints are not sharded) this
    rank's part of it, in place: only this rank's shard of every tensor the
    rules shard, each attention over its H/P heads on the composed modules,
    the out-projections and the FFNs' second denses row-parallel. Returns the
    model."""
    if model.keypoint_group is not None:
        raise ValueError("shard_model_tp takes a model whose keypoints are not sharded")
    size, _ = axis_size_rank(mesh, axis)
    if size == 1:
        return model
    local = shard_params_tp(model.state_dict(), mesh, axis)
    with torch.no_grad():
        for name, tensor in [*model.named_parameters(), *model.named_buffers()]:
            if shard_dim(name) is not None:
                tensor.data = local[name].to(tensor.device)
    group = mesh.get_group(axis)
    for wrapper in model.attention_gnn.layers:
        layer = wrapper.module
        layer.fused = False  # the fused layer kernels hold every head
        layer.mha.num_heads //= size
        layer.mha.out_proj = RowParallelConv1x1(layer.mha.out_proj, group)
        layer.fc[3] = RowParallelConv1x1(layer.fc[3], group)
    return model


def tp_forward(model: torch.nn.Module, **inputs) -> Dict[str, torch.Tensor]:
    """The eval forward of a ``SuperGlue`` sharded by ``shard_model_tp`` on
    this rank, every input replicated; its outputs are the same on every
    rank."""
    if model.training:
        raise ValueError("tp_forward runs the eval forward: call model.eval() first")
    return model(**inputs)
