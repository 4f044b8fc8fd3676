"""Attention over padded keypoint sets (port of ``openglue_tpu/ops/attention.py``):
softmax, linear (ELU+1 feature map), FAVOR+ with the ReLU kernel and the FAVOR+
softmax-kernel estimator.

Layout is ``[B, H, N, Dh]``; ``kv_mask [B, M]`` bool excludes padded keys. The
softmax kind sets their logits to -1e9 (finite, so a fully masked key set gives
the uniform average instead of NaN); the linear kinds zero their feature rows,
so they leave both the KV aggregate and the normalizer (a fully masked key set
then divides 0 by 0). FAVOR projections are per head ``[K, Dh]``.

``group`` (the linear kinds and the FAVOR-softmax keys): the keys and values
are this rank's shard of a key set sharded over the process group, as GSPMD
partitions these einsums in the JAX package. The ``[B, H, K, Dh]`` KV
aggregate and the ``[B, H, K]`` key sum go through one differentiable sum
all-reduce; the FAVOR-softmax key stabilizer is the max over every rank's
valid keys (``distributed.max_over``); the queries stay local.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from openglue_tpu_torch.parallel.distributed import all_reduce_sum, max_over

NEG_INF = -1e9


def _mask_logits(logits: torch.Tensor, kv_mask: Optional[torch.Tensor]) -> torch.Tensor:
    if kv_mask is None:
        return logits
    return torch.where(kv_mask[:, None, None, :], logits, logits.new_tensor(NEG_INF))


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
    attention = torch.softmax(_mask_logits(logits, kv_mask), dim=-1)
    out = torch.einsum("bhnm,bhmd->bhnd", attention, value)
    return out, attention


def softmax_attention_with_lse(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    kv_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax attention and the per-row logsumexp of the scaled, masked
    logits (the statistic that merges attention over key blocks). Returns
    (out [B, H, N, Dh], lse [B, H, N])."""
    head_dim = query.shape[-1]
    logits = torch.einsum("bhnd,bhmd->bhnm", query, key) * head_dim**-0.5
    logits = _mask_logits(logits, kv_mask)
    row_max = logits.amax(dim=-1)
    p = torch.exp(logits - row_max[..., None])
    denom = p.sum(dim=-1)
    out = torch.einsum("bhnm,bhmd->bhnd", p / denom[..., None], value)
    return out, row_max + torch.log(denom)


def linear_attention(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    kv_mask: Optional[torch.Tensor] = None,
    group=None,
) -> Tuple[torch.Tensor, None]:
    """Linear attention on feature maps that are already positive: O(N) in the
    set size. query [B, H, N, K]; key [B, H, M, K]; value [B, H, M, Dh]."""
    if kv_mask is not None:
        key = key * kv_mask[:, None, :, None].to(key.dtype)
    kv = torch.einsum("bhmk,bhmd->bhkd", key, value)
    key_sum = key.sum(dim=2)
    if group is not None:
        both = all_reduce_sum(torch.cat([kv, key_sum[..., None]], dim=-1), group)
        kv, key_sum = both[..., :-1], both[..., -1]
    out = torch.einsum("bhnk,bhkd->bhnd", query, kv)
    normalizer = torch.einsum("bhnk,bhk->bhn", query, key_sum)
    return out / normalizer[..., None], None


def linear_attention_elu(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    kv_mask: Optional[torch.Tensor] = None,
    eps: float = 1e-6,
    group=None,
) -> Tuple[torch.Tensor, None]:
    """Linear attention with the ELU(x)+1 feature map."""
    query = torch.nn.functional.elu(query) + 1.0 + eps
    key = torch.nn.functional.elu(key) + 1.0 + eps
    return linear_attention(query, key, value, kv_mask, group)


def sample_orthogonal_random_matrix(
    generator: Optional[torch.Generator],
    num_rows: int,
    num_cols: int,
    dtype: torch.dtype = torch.float32,
    device=None,
) -> torch.Tensor:
    """Orthogonal random features [num_rows, num_cols]: QR of Gaussian
    ``num_cols`` x ``num_cols`` blocks, rows rescaled by the norms of the
    Gaussian rows, so rows are orthogonal within each block and their norms are
    chi distributed. Drawn on the generator's device (the CPU when None)."""
    num_blocks = math.ceil(num_rows / num_cols)
    draw_device = generator.device if generator is not None else "cpu"
    unstructured = torch.randn(
        num_blocks, num_cols, num_cols, generator=generator, device=draw_device
    )
    norms = torch.linalg.norm(unstructured, dim=-1).reshape(-1, 1)
    q, _ = torch.linalg.qr(unstructured)
    q = q.transpose(-1, -2).reshape(-1, num_cols)
    return (q[:num_rows] * norms[:num_rows]).to(dtype=dtype, device=device or draw_device)


def _favor_projection(x: torch.Tensor, projection: torch.Tensor) -> torch.Tensor:
    if projection.dim() == 2:
        return torch.einsum("bhnd,kd->bhnk", x, projection)
    return torch.einsum("bhnd,hkd->bhnk", x, projection)


def favor_features_relu(
    x: torch.Tensor, projection: torch.Tensor, eps: float = 1e-8
) -> torch.Tensor:
    """Generalized FAVOR feature map with the ReLU kernel. x [B, H, N, Dh];
    projection [K, Dh] (shared by the heads) or [H, K, Dh]. Returns positive
    features [B, H, N, K] for ``linear_attention``."""
    x = x * x.shape[-1] ** -0.25
    return torch.relu(_favor_projection(x, projection)) + eps


def favor_features_softmax(
    x: torch.Tensor,
    projection: torch.Tensor,
    is_query: bool,
    kv_mask: Optional[torch.Tensor] = None,
    eps: float = 1e-8,
    group=None,
) -> torch.Tensor:
    """Positive softmax-kernel estimator features (Performer), stabilized by a
    max: queries subtract a per-row max, keys one max over valid keypoints and
    features per (element, head), over every rank's keys with ``group``.
    Returns [B, H, N, K]."""
    data_normalizer = x.shape[-1] ** -0.25
    ratio = projection.shape[-2] ** -0.5
    proj = _favor_projection(x * data_normalizer, projection)
    diag = 0.5 * (x**2).sum(dim=-1, keepdim=True) * data_normalizer**2
    if is_query:
        stab = proj.amax(dim=-1, keepdim=True)
    else:
        if kv_mask is not None:
            proj_for_max = torch.where(kv_mask[:, None, :, None], proj, proj.new_tensor(NEG_INF))
        else:
            proj_for_max = proj
        stab = proj_for_max.amax(dim=(-1, -2), keepdim=True)
        if group is not None:
            stab = max_over(stab, group)
    return ratio * (torch.exp(proj - diag - stab) + eps)
