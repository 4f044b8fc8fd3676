"""Log-domain Sinkhorn optimal transport with dustbin augmentation.

Port of ``openglue_tpu/ops/sinkhorn.py``: the composed path that
``use_pallas=False`` runs. Scores ``S [B, m, n]`` get a learned dustbin
row/column; row marginals are ``-log(n+m)`` (dustbin row ``+log n``), column
marginals ``-log(n+m)`` (dustbin column ``+log m``); ``num_iters``
alternating logsumexp normalizations run on ``M = S / reg`` and the result is
rescaled by ``+log(n+m)``. Optional ``[B, m]`` / ``[B, n]`` bool masks exclude
padded keypoints: masked entries sit at -1e9 and per-element valid counts
drive the marginals.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e9


def logsumexp(x: torch.Tensor, dim: int) -> torch.Tensor:
    """log(sum(exp(x))) over ``dim`` as ``jax.nn.logsumexp`` computes it, with
    the max held out of the gradient, so that the gradient is exp(x - max) /
    sum. ``torch.logsumexp`` differentiates as exp(x - result), which fails
    on a masked row: every entry sits near -1e9, where f32 rounds x and the
    result to the same multiple of 64, so each of the row's C entries gets a
    weight of 1 instead of 1/C, and 20 iterations of that overflow to NaN."""
    m = x.detach().amax(dim=dim, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    return (m + torch.log(torch.exp(x - m).sum(dim=dim, keepdim=True))).squeeze(dim)


def log_sinkhorn(
    log_a: torch.Tensor,
    log_b: torch.Tensor,
    M: torch.Tensor,
    num_iters: int = 20,
    reg: float = 1.0,
) -> torch.Tensor:
    """log_a [B, R], log_b [B, C], M [B, R, C] -> log transport plan [B, R, C]."""
    M = M / reg
    u = torch.zeros_like(log_a)
    v = torch.zeros_like(log_b)
    for _ in range(num_iters):
        u = log_a - logsumexp(M + v[:, None, :], dim=2)
        v = log_b - logsumexp(M + u[:, :, None], dim=1)
    return M + u[:, :, None] + v[:, None, :]


def augment_scores(scores: torch.Tensor, dustbin_score: torch.Tensor) -> torch.Tensor:
    """[B, m, n] -> [B, m+1, n+1] with the dustbin row and column appended."""
    batch, m, n = scores.shape
    dust = torch.as_tensor(dustbin_score, dtype=scores.dtype, device=scores.device)
    row = dust.expand(batch, 1, n)
    col = dust.expand(batch, m + 1, 1)
    return torch.cat([torch.cat([scores, row], dim=1), col], dim=2)


def masked_otp_marginals(mask0: torch.Tensor, mask1: torch.Tensor, dtype: torch.dtype = torch.float32):
    """The masked marginals of the dustbin-augmented problem from the valid
    keypoints: mask0 [B, m], mask1 [B, n] bool -> (log_a_inner [B, m],
    log_a_dust [B], log_b [B, n+1], norm [B]), masked entries at -1e9."""
    count0 = mask0.sum(dim=1).to(dtype)
    count1 = mask1.sum(dim=1).to(dtype)
    norm = -torch.log(torch.clamp(count0 + count1, min=1.0))  # [B]
    ones = torch.ones(mask1.shape[0], 1, dtype=torch.bool, device=mask1.device)
    valid_col = torch.cat([mask1, ones], dim=1)
    log_a_inner = torch.where(mask0, norm[:, None], norm.new_tensor(NEG_INF))
    log_a_dust = norm + torch.log(torch.clamp(count1, min=1.0))
    log_b = torch.where(valid_col, norm[:, None], norm.new_tensor(NEG_INF))
    log_b = torch.cat(
        [log_b[:, :-1], (norm + torch.log(torch.clamp(count0, min=1.0)))[:, None]], dim=1
    )
    return log_a_inner, log_a_dust, log_b, norm


def masked_otp_matrix(
    scores: torch.Tensor, dustbin_score: torch.Tensor, reg: float, mask0: torch.Tensor, mask1: torch.Tensor
):
    """The masked matrix in split form: scores [B, m, n] with their row and
    column masks -> (S_inner [B, m, n+1], S_dust [B, 1, n+1]), already /reg
    with masked entries at -1e9. The rows may be any slice of the score
    matrix's rows, with ``mask0`` theirs."""
    batch, m, n = scores.shape
    dust = torch.as_tensor(dustbin_score, dtype=scores.dtype, device=scores.device)
    ones = torch.ones(batch, 1, dtype=torch.bool, device=scores.device)
    valid_col = torch.cat([mask1, ones], dim=1)
    S_inner = torch.cat([scores / reg, (dust / reg).expand(batch, m, 1)], dim=2)
    pair_valid = mask0[:, :, None] & valid_col[:, None, :]
    S_inner = torch.where(pair_valid, S_inner, S_inner.new_tensor(NEG_INF))
    S_dust = torch.where(
        valid_col[:, None, :],
        (dust / reg).expand(batch, 1, n + 1),
        S_inner.new_tensor(NEG_INF),
    )
    return S_inner, S_dust


def build_masked_otp_inputs(
    scores: torch.Tensor,
    dustbin_score: torch.Tensor,
    reg: float,
    mask0: torch.Tensor,
    mask1: torch.Tensor,
):
    """Masked marginals and matrix in split form (inner rows + dustbin row).

    Returns (S_inner [B, m, n+1], S_dust [B, 1, n+1], log_a_inner [B, m],
    log_a_dust [B], log_b [B, n+1], norm [B]); matrices are already /reg with
    masked entries at -1e9.
    """
    S_inner, S_dust = masked_otp_matrix(scores, dustbin_score, reg, mask0, mask1)
    return (S_inner, S_dust, *masked_otp_marginals(mask0, mask1, scores.dtype))


def log_optimal_transport(
    scores: torch.Tensor,
    dustbin_score: torch.Tensor,
    num_iters: int = 20,
    reg: float = 1.0,
    mask0: Optional[torch.Tensor] = None,
    mask1: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Dustbin-augmented entropic OT: scores [B, m, n] -> log-assignment
    [B, m+1, n+1]."""
    batch, m, n = scores.shape
    if mask0 is None and mask1 is None:
        S_aug = augment_scores(scores, dustbin_score)
        dtype, device = scores.dtype, scores.device
        norm = -torch.log(torch.tensor(float(n + m), dtype=dtype, device=device))
        log_a = norm.expand(m + 1).clone()
        log_a[-1] = log_a[-1] + torch.log(torch.tensor(float(n), dtype=dtype, device=device))
        log_b = norm.expand(n + 1).clone()
        log_b[-1] = log_b[-1] + torch.log(torch.tensor(float(m), dtype=dtype, device=device))
        log_P = log_sinkhorn(
            log_a.expand(batch, m + 1), log_b.expand(batch, n + 1), S_aug,
            num_iters=num_iters, reg=reg,
        )
        return log_P - norm

    if mask0 is None:
        mask0 = torch.ones(batch, m, dtype=torch.bool, device=scores.device)
    if mask1 is None:
        mask1 = torch.ones(batch, n, dtype=torch.bool, device=scores.device)
    S_inner, S_dust, log_a_inner, log_a_dust, log_b, norm = build_masked_otp_inputs(
        scores, dustbin_score, reg, mask0, mask1
    )
    S_aug = torch.cat([S_inner, S_dust], dim=1)
    log_a = torch.cat([log_a_inner, log_a_dust[:, None]], dim=1)
    # reg already applied by build_masked_otp_inputs
    log_P = log_sinkhorn(log_a, log_b, S_aug, num_iters=num_iters, reg=1.0)
    return log_P - norm[:, None, None]
