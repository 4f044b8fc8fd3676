"""Keypoint-axis context parallelism: ring attention and row-sharded Sinkhorn
(port of ``openglue_tpu/parallel/ring.py``).

The keypoint sets are split into contiguous shards, one per rank of a process
group (the ``model`` axis of a mesh). Every function here is the program of
one rank, as the JAX functions are the body of a ``shard_map``:

* ``ring_softmax_attention``: queries stay on their rank; the K/V/mask blocks
  travel around the ring (``distributed.rotate``) and each block is merged by
  its LSE, so the full [N, M] score matrix never exists on one rank. The same
  schedule serves self attention (K/V are the same image's shards) and the
  bipartite cross attention (the other image's shards);
* ``sharded_log_sinkhorn``: score-matrix rows sharded; the row update is
  local, the column update reduces partial logsumexps across the ranks with
  one MAX (detached) and one differentiable SUM all-reduce per iteration. The
  dustbin row is replicated and folded into the column reduction once;
* ``log_optimal_transport_ring``: the dustbin-augmented transport on this
  rank's rows, with the marginals of the whole problem.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from openglue_tpu_torch.ops import sinkhorn as sinkhorn_ops
from openglue_tpu_torch.ops.kernels import attention_kernel
from openglue_tpu_torch.parallel.distributed import all_reduce_max, all_reduce_sum, rotate

NEG_INF = -1e9


def _merged_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, L, dh] -> the contiguous [B, L, H * dh] buffer that travels
    (no copy when ``x`` is a head view of such a buffer)."""
    batch, heads, length, dh = x.shape
    return x.transpose(1, 2).contiguous().view(batch, length, heads * dh)


def _split_heads(buffer: torch.Tensor, heads: int) -> torch.Tensor:
    batch, length, dim = buffer.shape
    return buffer.view(batch, length, heads, dim // heads).transpose(1, 2)


def merge_block(
    acc: torch.Tensor, lse_run: torch.Tensor, out_blk: torch.Tensor, lse_blk: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold one key block's attention ``out_blk`` [B, H, n, dh] with its LSE
    ``lse_blk`` [B, H, n] into the running ``acc`` and ``lse_run`` (which may
    start at 0 and -inf: exp(-inf) weighs the empty start 0, forward and
    backward). Returns the new (acc, lse_run)."""
    lse_new = torch.logaddexp(lse_run, lse_blk)
    w_old = torch.exp(lse_run - lse_new)
    w_new = torch.exp(lse_blk - lse_new)
    acc = acc * w_old[..., None] + out_blk.to(acc.dtype) * w_new[..., None]
    return acc, lse_new


def ring_softmax_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor],
    group,
    use_pallas: bool = False,
) -> torch.Tensor:
    """Masked softmax attention with K/V sharded over ``group``: q [B, H,
    n_loc, dh] (this rank's queries), k/v [B, H, m_loc, dh] (this rank's key
    block), kv_mask [B, m_loc] bool or None -> [B, H, n_loc, dh], the softmax
    over the whole key set.

    ``use_pallas`` computes each block with the LSE-emitting attention kernel
    (``attention_kernel.masked_softmax_attention_with_lse``) and merges the
    blocks with ``merge_block``; a row whose merged LSE stays below -1e8 (no
    valid key anywhere) is 0. Without it, an online softmax in torch; a row
    with no valid key is then the uniform average over every key, as the -1e9
    logits give. The last block skips the rotation."""
    size = dist.get_world_size(group)
    heads = q.shape[1]
    if kv_mask is None:
        kv_mask = torch.ones(k.shape[0], k.shape[2], dtype=torch.bool, device=k.device)
    k_buf, v_buf, mask_blk = _merged_heads(k), _merged_heads(v), kv_mask

    if use_pallas:
        acc = torch.zeros_like(q)
        lse_run = torch.full_like(q[..., 0], float("-inf"))
        for step in range(size):
            out_blk, lse_blk = attention_kernel.masked_softmax_attention_with_lse(
                q, _split_heads(k_buf, heads), _split_heads(v_buf, heads), mask_blk
            )
            acc, lse_run = merge_block(acc, lse_run, out_blk, lse_blk)
            if step + 1 < size:
                k_buf, v_buf, mask_blk = rotate(group, k_buf, v_buf, mask_blk)
        # rows with no valid key anywhere carry only the -1e9 pseudo-mass
        return torch.where(lse_run[..., None] < -1e8, 0.0, acc)

    scale = q.shape[-1] ** -0.5
    acc = torch.zeros_like(q)
    m_run = torch.full_like(q[..., 0], NEG_INF)
    denom = torch.zeros_like(q[..., 0])
    for step in range(size):
        k_blk, v_blk = _split_heads(k_buf, heads), _split_heads(v_buf, heads)
        logits = torch.einsum("bhnd,bhmd->bhnm", q, k_blk) * scale
        logits = torch.where(mask_blk[:, None, None, :], logits, logits.new_tensor(NEG_INF))
        m_new = torch.maximum(m_run, logits.amax(dim=-1))
        corr = torch.exp(m_run - m_new)
        p = torch.exp(logits - m_new[..., None])
        denom = denom * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhnm,bhmd->bhnd", p, v_blk)
        m_run = m_new
        if step + 1 < size:
            k_buf, v_buf, mask_blk = rotate(group, k_buf, v_buf, mask_blk)
    return acc / torch.clamp(denom, min=1e-30)[..., None]


def sharded_log_sinkhorn(
    S_inner: torch.Tensor,
    S_dust_row: torch.Tensor,
    log_a_inner: torch.Tensor,
    log_a_dust: torch.Tensor,
    log_b: torch.Tensor,
    group,
    num_iters: int = 20,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Log-domain Sinkhorn with the rows sharded over ``group``.

    S_inner [B, n_loc, C]: this rank's rows (C = M + 1 with the dustbin
    column, already /reg and mask-filled); S_dust_row [B, 1, C], log_a_dust
    [B] and log_b [B, C]: replicated; log_a_inner [B, n_loc]. Returns
    (log_P_inner [B, n_loc, C], log_P_dust [B, 1, C]). The column max is a
    stabilizer only (the LSE and its gradient do not depend on it), so it is
    reduced detached, as JAX ``stop_gradient``s its ``pmax``."""
    u_inner = torch.zeros_like(S_inner[..., 0])
    u_dust = torch.zeros_like(log_a_dust)
    v = torch.zeros_like(log_b)
    dust_row = S_dust_row[:, 0, :]
    for _ in range(num_iters):
        u_inner = log_a_inner - sinkhorn_ops.logsumexp(S_inner + v[:, None, :], dim=2)
        u_dust = log_a_dust - sinkhorn_ops.logsumexp(dust_row + v, dim=1)
        part = S_inner + u_inner[:, :, None]  # [B, n_loc, C]
        dust_part = dust_row + u_dust[:, None]
        global_max = torch.maximum(all_reduce_max(part.amax(dim=1), group), dust_part).detach()
        total = all_reduce_sum(torch.exp(part - global_max[:, None, :]).sum(dim=1), group)
        total = total + torch.exp(dust_part - global_max)
        v = log_b - (global_max + torch.log(total))
    log_P_inner = S_inner + u_inner[:, :, None] + v[:, None, :]
    log_P_dust = S_dust_row + u_dust[:, None, None] + v[:, None, :]
    return log_P_inner, log_P_dust


def log_optimal_transport_ring(
    scores: torch.Tensor,
    dustbin_score: torch.Tensor,
    group,
    num_iters: int = 20,
    reg: float = 1.0,
    mask0: Optional[torch.Tensor] = None,
    mask1: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The dustbin-augmented transport of ``ops.sinkhorn.log_optimal_transport``
    on this rank's rows: scores [B, n_loc, M] (rows rank * n_loc onward),
    mask0 [B, N] and mask1 [B, M] of the WHOLE problem (the marginals' norm
    is -log(N0 + N1) over every valid keypoint) -> [B, n_loc + 1, M + 1]:
    this rank's rows of the log-assignment, then the replicated dustbin
    row."""
    batch, n_loc, m = scores.shape
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    if mask0 is None:
        mask0 = torch.ones(batch, n_loc * size, dtype=torch.bool, device=scores.device)
    if mask1 is None:
        mask1 = torch.ones(batch, m, dtype=torch.bool, device=scores.device)
    rows = slice(rank * n_loc, (rank + 1) * n_loc)
    log_a_inner, log_a_dust, log_b, norm = sinkhorn_ops.masked_otp_marginals(mask0, mask1, scores.dtype)
    S_inner, S_dust = sinkhorn_ops.masked_otp_matrix(scores, dustbin_score, reg, mask0[:, rows], mask1)
    log_P_inner, log_P_dust = sharded_log_sinkhorn(
        S_inner, S_dust, log_a_inner[:, rows], log_a_dust, log_b, group, num_iters
    )
    return torch.cat([log_P_inner, log_P_dust], dim=1) - norm[:, None, None]
