"""Building-block layers (port of ``openglue_tpu/models/layers.py``).

Everything works on channels-last ``[B, N, C]``. A 1x1 convolution over the
keypoint axis is a per-keypoint dense layer; ``Conv1x1`` keeps the reference's
``Conv1d`` weight layout ``[out, in, 1]`` and default init so state dicts
carry over by name.

Compute type: a layer built with ``dtype=None`` computes in the promotion of
its input's and its parameters' types (a bf16 input meets f32 weights in
f32), as flax does for the JAX package. torch does not promote a matmul by
itself, so the cast is explicit.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence

import torch
from torch import nn

from openglue_tpu_torch.parallel.distributed import all_reduce_sum


def _compute_dtype(x: torch.Tensor, param: torch.Tensor, dtype: Optional[torch.dtype]):
    return dtype if dtype is not None else torch.promote_types(x.dtype, param.dtype)


class Conv1x1(nn.Module):
    """Dense layer over the last axis with a ``[out, in, 1]`` weight and the
    torch ``Conv1d`` default init, U(-1/sqrt(in), 1/sqrt(in)) for weight and
    bias (kaiming_uniform with a=sqrt(5) reduces to it)."""

    def __init__(self, in_features: int, out_features: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features, 1))
        self.bias = nn.Parameter(torch.empty(out_features))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        bound = 1.0 / math.sqrt(self.weight.shape[1])
        with torch.no_grad():
            nn.init.uniform_(self.weight, -bound, bound, generator=generator)
            nn.init.uniform_(self.bias, -bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute_dtype(x, self.weight, self.dtype)
        return torch.matmul(x.to(dt), self.weight[:, :, 0].to(dt).t()) + self.bias.to(dt)


def group_moments(flat: torch.Tensor, mask: Optional[torch.Tensor], group):
    """The mean and the biased variance ``[C]`` of the rows of ``flat``
    ``[R, C]`` that ``mask`` ``[R, 1]`` keeps (None: every row), and their
    count. With ``group`` they are those of every rank's rows: the sum and the
    count are all-reduced, then the sum of squared deviations from the global
    mean, with differentiable all-reduces."""
    if mask is None:
        sums = torch.cat([flat.sum(dim=0), flat.new_full((1,), flat.shape[0])])
    else:
        sums = torch.cat([(flat * mask).sum(dim=0), mask.sum()[None]])
    if group is not None:
        sums = all_reduce_sum(sums, group)
    count = torch.clamp(sums[-1], min=1.0)
    mean = sums[:-1] / count
    squares = (flat - mean) ** 2
    squares = (squares if mask is None else squares * mask).sum(dim=0)
    return mean, (squares if group is None else all_reduce_sum(squares, group)) / count, count


@torch.no_grad()
def update_running_statistics(bn: nn.Module, mean: torch.Tensor, var: torch.Tensor, count: torch.Tensor) -> None:
    """torch's update of a BatchNorm's running statistics by ``momentum``,
    the variance the unbiased one of ``count`` rows."""
    unbiased = var * count / torch.clamp(count - 1.0, min=1.0)
    bn.running_mean.mul_(1 - bn.momentum).add_(bn.momentum * mean)
    bn.running_var.mul_(1 - bn.momentum).add_(bn.momentum * unbiased)


class MaskedBatchNorm(nn.Module):
    """BatchNorm over every axis but the last, with torch ``BatchNorm1d``
    semantics (biased batch variance to normalize, unbiased variance into the
    running stats, momentum 0.1) and an optional ``[...]`` validity mask that
    keeps padded keypoints out of the statistics. The output type is
    ``dtype`` or, when None, the input's type. While ``update_running`` is
    False a training-mode call leaves the running statistics alone: a forward
    that is run again to rebuild activations (``frozen_running_statistics``)
    must count once.

    ``group`` makes the training statistics those of every rank's valid
    keypoints, as GSPMD makes them in the JAX package: the count and the
    masked sum are all-reduced, then the masked sum of squared deviations
    from the global mean, with differentiable all-reduces. A model whose
    keypoints are sharded (``SuperGlue.keypoint_group``) sets it to that
    group; a data-parallel step (``parallel.shard_train_step``) to
    the whole data x model world (``set_batch_norm_group``). The running
    statistics then move with the global count, alike on every rank; eval
    needs no collective."""

    def __init__(
        self,
        num_features: int,
        momentum: float = 0.1,
        eps: float = 1e-5,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.dtype = dtype
        self.update_running = True
        self.group = None
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x32 = x.float()
        if self.training:
            flat = x32.reshape(-1, x32.shape[-1])
            mean, var, count = group_moments(flat, None if mask is None else mask.reshape(-1, 1).float(), self.group)
            if self.update_running:
                update_running_statistics(self, mean, var, count)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        y = y * self.weight + self.bias
        return y.to(self.dtype or x.dtype)


class GroupBatchNorm2d(nn.BatchNorm2d):
    """torch's ``BatchNorm2d`` (the extractors' BatchNorms) whose training
    statistics, with ``group`` set, are those of every rank's images, as
    GSPMD makes flax's in the JAX package, taken by ``group_moments`` as
    ``MaskedBatchNorm`` takes them: the biased variance normalizes, and
    torch's unbiased one with the global count moves the running variance.
    Without ``group``, or in eval, it is ``BatchNorm2d``."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and self.group is not None):
            return super().forward(x)
        mean, var, count = group_moments(x.movedim(1, -1).reshape(-1, x.shape[1]), None, self.group)
        self.num_batches_tracked.add_(1)
        update_running_statistics(self, mean, var, count)
        shape = (1, x.shape[1], 1, 1)
        y = (x - mean.view(shape)) * torch.rsqrt(var + self.eps).view(shape)
        if self.affine:
            y = y * self.weight.view(shape) + self.bias.view(shape)
        return y


def set_batch_norm_group(module: nn.Module, group) -> None:
    """Every ``MaskedBatchNorm`` and ``GroupBatchNorm2d`` under ``module``
    takes its training statistics over ``group`` (None: this process's batch
    alone)."""
    for m in module.modules():
        if isinstance(m, (MaskedBatchNorm, GroupBatchNorm2d)):
            m.group = group


@contextlib.contextmanager
def frozen_running_statistics(module: nn.Module):
    """Within the context, the ``MaskedBatchNorm`` layers under ``module``
    normalize as before but do not update their running statistics."""
    norms = [m for m in module.modules() if isinstance(m, MaskedBatchNorm)]
    saved = [m.update_running for m in norms]
    for m in norms:
        m.update_running = False
    try:
        yield
    finally:
        for m, flag in zip(norms, saved):
            m.update_running = flag


class FeedForwardNet(nn.Sequential):
    """[1x1 conv -> ReLU -> BatchNorm] x k -> 1x1 conv. ``sizes`` lists the
    input size, the hidden sizes and the output size. Submodule indices are
    the reference's ``nn.Sequential`` ones (conv 3i, ReLU 3i+1, BN 3i+2, final
    conv 3k), so state-dict keys carry over."""

    def __init__(self, sizes: Sequence[int], dtype: Optional[torch.dtype] = None):
        layers = []
        for fan_in, size in zip(sizes[:-2], sizes[1:-1]):
            layers += [Conv1x1(fan_in, size, dtype), nn.ReLU(), MaskedBatchNorm(size, dtype=dtype)]
        layers.append(Conv1x1(sizes[-2], sizes[-1], dtype))
        super().__init__(*layers)

    def forward(
        self, x: torch.Tensor, mask: Optional[torch.Tensor] = None, skip_to_hidden: bool = False
    ) -> torch.Tensor:
        """``skip_to_hidden``: ``x`` is already the first hidden layer's
        activation after the ReLU (computed by a fused kernel that consumed the
        first conv's parameters, ``ops.kernels.gnn_layer_kernel.
        fused_train_layer_half``): start at the first BatchNorm."""
        for layer in list(self)[2 if skip_to_hidden else 0:]:
            x = layer(x, mask) if isinstance(layer, MaskedBatchNorm) else layer(x)
        return x


class FeedForwardNetSiren(nn.Module):
    """[dense -> sin(30 x)] x k -> dense with the SIREN init: every weight
    U(+-sqrt(6 / in) / 30) except the first layer's U(+-1 / in); biases zero
    (the JAX package's choice). It has no BatchNorm, so ``mask`` is unused.
    The layers are named ``dense_{i}``."""

    def __init__(self, sizes: Sequence[int], dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_layers = len(sizes) - 1
        for i, (fan_in, size) in enumerate(zip(sizes[:-1], sizes[1:])):
            self.add_module(f"dense_{i}", Conv1x1(fan_in, size, dtype))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            for i in range(self.num_layers):
                dense = getattr(self, f"dense_{i}")
                fan_in = dense.weight.shape[1]
                bound = 1.0 / fan_in if i == 0 else math.sqrt(6.0 / fan_in) / 30.0
                nn.init.uniform_(dense.weight, -bound, bound, generator=generator)
                nn.init.zeros_(dense.bias)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        for i in range(self.num_layers - 1):
            x = torch.sin(30.0 * getattr(self, f"dense_{i}")(x))
        return getattr(self, f"dense_{self.num_layers - 1}")(x)


ENCODERS = {
    "FeedForwardNet": FeedForwardNet,
    "FeedForwardNetSiren": FeedForwardNetSiren,
}
