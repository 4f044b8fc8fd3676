"""What the device extractors share: f32 convolutions without TF32, a seeded
initialization, the image layout they take and an exact top-k in JAX's order.

The extractors compute in f32 and hold their card runs to their CPU runs
(``chip_smoke.py``'s ``device_extractors`` phase), so each runs its
convolutions and matrix products with TF32 off, whatever the caller's
``torch.backends`` flags say (``full_f32``).
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple

import torch
from torch import nn


@contextlib.contextmanager
def full_f32():
    """TF32 off for cuDNN convolutions and CUDA matmuls inside the block (or
    the call, as a decorator: ``@full_f32()``); the caller's flags come back
    after it."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def seeded_init_(module: nn.Module, generator: Optional[torch.Generator]) -> nn.Module:
    """Redraw every convolution's weight and bias from ``generator`` with
    PyTorch's default bounds (uniform in +-1/sqrt(fan_in)); BatchNorms keep
    their unit scale and zero shift and statistics. Returns ``module``."""
    for conv in module.modules():
        if isinstance(conv, nn.Conv2d):
            bound = 1.0 / math.sqrt(conv.weight[0].numel())
            with torch.no_grad():
                nn.init.uniform_(conv.weight, -bound, bound, generator=generator)
                if conv.bias is not None:
                    nn.init.uniform_(conv.bias, -bound, bound, generator=generator)
    return module


def gray_batch(image: torch.Tensor) -> torch.Tensor:
    """[B, H, W] or [B, 1, H, W] grayscale -> [B, H, W] f32."""
    if image.dim() == 4:
        image = image[:, 0]
    return image.float()


def top_k(values: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest of each row of ``values`` [B, M] and their indices,
    in ``jax.lax.top_k``'s order: descending, the lower index first among
    equal values (a stable sort; ``torch.topk`` promises no order among
    ties, and the extractors pad with rows of equal zero scores)."""
    sorted_values, order = torch.sort(values, dim=1, descending=True, stable=True)
    return sorted_values[:, :k], order[:, :k]
