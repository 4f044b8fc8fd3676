"""MLP positional encoding of keypoint coordinates + side info (port of
``openglue_tpu/models/positional_encoding.py``; the Siren encoder comes with
a later slice)."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from openglue_tpu_torch.models.layers import FeedForwardNet


class MLPPositionalEncoding(nn.Module):
    """concat[xy, side_info] -> ``FeedForwardNet`` -> ``output_size``."""

    def __init__(
        self,
        output_size: int,
        hidden_layers_sizes: Sequence[int] = (),
        side_info_size: int = 1,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.encoder = FeedForwardNet(
            (2 + side_info_size, *hidden_layers_sizes, output_size), dtype=dtype
        )

    def forward(
        self, kpts: torch.Tensor, side_info: torch.Tensor, mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        return self.encoder(torch.cat([kpts, side_info], dim=-1), mask)
