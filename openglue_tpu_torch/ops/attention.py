"""Attention over padded keypoint sets (port of ``openglue_tpu/ops/attention.py``,
softmax kind only; the linear and FAVOR kinds come with a later slice).

Layout is ``[B, H, N, Dh]``; ``kv_mask [B, M]`` bool excludes padded keys by
setting their logits to -1e9 (finite, so a fully masked key set gives the
uniform average instead of NaN).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e9


def softmax_attention(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    kv_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """query [B, H, N, Dh]; key/value [B, H, M, Dh]; kv_mask [B, M] or None.
    Returns (out [B, H, N, Dh], attention [B, H, N, M])."""
    head_dim = query.shape[-1]
    logits = torch.einsum("bhnd,bhmd->bhnm", query, key) * head_dim**-0.5
    if kv_mask is not None:
        logits = torch.where(kv_mask[:, None, None, :], logits, logits.new_tensor(NEG_INF))
    attention = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhnm,bhmd->bhnd", attention, value)
    return out, attention
