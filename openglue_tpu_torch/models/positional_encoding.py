"""MLP positional encoding of keypoint coordinates + side info (port of
``openglue_tpu/models/positional_encoding.py``)."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from openglue_tpu_torch.models.layers import ENCODERS, FeedForwardNetSiren


class MLPPositionalEncoding(nn.Module):
    """concat[xy, side_info] -> encoder -> ``output_size``; ``encoder_name`` is
    ``FeedForwardNet`` (conv, ReLU, BatchNorm) or ``FeedForwardNetSiren``."""

    def __init__(
        self,
        output_size: int,
        hidden_layers_sizes: Sequence[int] = (),
        side_info_size: int = 1,
        encoder_name: str = "FeedForwardNet",
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        if encoder_name not in ENCODERS:
            raise NameError(
                f"{encoder_name} was not found among positional encoders. "
                f"Choose one of: {', '.join(ENCODERS)}"
            )
        self.encoder = ENCODERS[encoder_name](
            (2 + side_info_size, *hidden_layers_sizes, output_size), dtype=dtype
        )

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The Siren encoder's own init, after the default init of every
        1x1 conv; the FeedForwardNet encoder keeps that default."""
        if isinstance(self.encoder, FeedForwardNetSiren):
            self.encoder.reset_parameters(generator)

    def forward(
        self, kpts: torch.Tensor, side_info: torch.Tensor, mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        return self.encoder(torch.cat([kpts, side_info], dim=-1), mask)
