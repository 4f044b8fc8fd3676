"""Scale-domain Sinkhorn: the kernel wrapper (``ops/csrc/sinkhorn.cu``) and the
torch glue around it.

Port of ``openglue_tpu/ops/pallas/sinkhorn_kernel.py``. One CUDA kernel,
templated on K's storage type, replaces the three TPU kernels
``_sinkhorn_kernel_pair`` (:128), ``_sinkhorn_kernel`` (:56) and
``_blocked_scale_kernel`` (:315). Per batch element it runs

    rmax = max_j M_ij;  K = exp(M - rmax)   (written once, f32 or bf16)
    v̂ = 1;  T-1 times:  û = a ⊘ max(K v̂, 1e-30),  v̂ = b ⊘ max(Kᵀ û, 1e-30)
    u = log_a - rmax - log(max(K v̂, 1e-30))

with a = exp(log_a), b = exp(log_b), each iteration one pass over K. The
padded cost matrix, the marginals, the final column-stabilized
half-iteration and the log_P assembly stay in torch, as they stay in XLA in
the JAX package.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from openglue_tpu_torch.ops import kernels

NEG_INF = -1e9
TINY = 1e-30
COL_ALIGN = 8  # column pitch of M_pad and K: 16-byte aligned rows in f32 and bf16

# Port-owned copy of the JAX package's VMEM budget (sinkhorn_kernel.py:39-50).
# It sized a TPU core's VMEM and means nothing on the H100; it is kept only to
# pick K's storage type as the JAX package does (f32 when the block fits, bf16
# from about N=1280 up), so that the two packages' numbers agree.
_VMEM_BUDGET_BYTES = 13 * 1024 * 1024

counter = kernels.LaunchCounter()


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def fits_vmem(num_rows: int, num_cols: int) -> bool:
    rp = _round_up(num_rows, 8)
    cp = _round_up(num_cols, 128)
    return 2 * rp * cp * 4 + 8 * (rp + cp) * 4 < _VMEM_BUDGET_BYTES


def k_storage_dtype(num_rows: int, num_cols: int) -> torch.dtype:
    """K's storage type: f32 where the JAX package keeps M in VMEM, bf16 where
    it streams a pre-exponentiated bf16 K."""
    return torch.float32 if fits_vmem(num_rows, num_cols) else torch.bfloat16


def build_padded_otp_matrix(
    scores: torch.Tensor,
    dustbin_score: torch.Tensor,
    reg: float,
    mask0: Optional[torch.Tensor],
    mask1: Optional[torch.Tensor],
    rp: int,
    cp: int,
) -> torch.Tensor:
    """The dustbin-augmented, masked, padded, regularized cost [B, rp, cp] f32.
    Masked and padded entries are exactly -1e9."""
    batch, m, n = scores.shape
    device = scores.device
    S_pad = torch.nn.functional.pad(scores.float(), (0, cp - n, 0, rp - m))
    row_ids = torch.arange(rp, device=device)[None, :, None]
    col_ids = torch.arange(cp, device=device)[None, None, :]
    dust = torch.as_tensor(dustbin_score, dtype=torch.float32, device=device)
    vals = torch.where((row_ids == m) | (col_ids == n), dust, S_pad) / reg

    valid_row = row_ids <= m
    if mask0 is not None:
        mask0_pad = torch.nn.functional.pad(mask0, (0, rp - m))[:, :, None]
        valid_row = valid_row & (mask0_pad | (row_ids == m))
    valid_col = col_ids <= n
    if mask1 is not None:
        mask1_pad = torch.nn.functional.pad(mask1, (0, cp - n))[:, None, :]
        valid_col = valid_col & (mask1_pad | (col_ids == n))
    return torch.where(valid_row & valid_col, vals, vals.new_tensor(NEG_INF))


def otp_marginals(
    batch: int,
    m: int,
    n: int,
    mask0: Optional[torch.Tensor],
    mask1: Optional[torch.Tensor],
    device: torch.device,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Row/column log-marginals [B, m+1], [B, n+1] and the norm [B] (masked
    rows/columns at -1e9; dustbins carry the other side's valid count)."""
    f32 = torch.float32
    if mask0 is None:
        mask0 = torch.ones(batch, m, dtype=torch.bool, device=device)
    if mask1 is None:
        mask1 = torch.ones(batch, n, dtype=torch.bool, device=device)
    count0 = mask0.sum(dim=1).to(f32)
    count1 = mask1.sum(dim=1).to(f32)
    norm = -torch.log(torch.clamp(count0 + count1, min=1.0))
    neg = torch.tensor(NEG_INF, dtype=f32, device=device)
    log_a = torch.cat(
        [torch.where(mask0, norm[:, None], neg),
         (norm + torch.log(torch.clamp(count1, min=1.0)))[:, None]], dim=1)
    log_b = torch.cat(
        [torch.where(mask1, norm[:, None], neg),
         (norm + torch.log(torch.clamp(count0, min=1.0)))[:, None]], dim=1)
    return log_a, log_b, norm


def padded_marginals(log_a, log_b, rp: int, cp: int):
    """Pad [B, rows] / [B, cols] marginals to [B, rp] / [B, cp] with -1e9."""
    la = torch.nn.functional.pad(log_a.float(), (0, rp - log_a.shape[1]), value=NEG_INF)
    lb = torch.nn.functional.pad(log_b.float(), (0, cp - log_b.shape[1]), value=NEG_INF)
    return la.contiguous(), lb.contiguous()


def sinkhorn_scale_plain(
    M_pad: torch.Tensor, la: torch.Tensor, lb: torch.Tensor, num_iters: int,
    k_dtype: torch.dtype,
) -> torch.Tensor:
    """The plain version of the kernel: M_pad [B, R, C] f32, la [B, R],
    lb [B, C] -> u [B, R] f32. Arithmetic in f32; K stored in ``k_dtype``."""
    rmax = M_pad.amax(dim=2)
    K = torch.exp(M_pad - rmax[:, :, None]).to(k_dtype).float()
    a, b = torch.exp(la), torch.exp(lb)
    v_hat = torch.ones_like(lb)
    for _ in range(num_iters - 1):
        y = torch.bmm(K, v_hat[:, :, None])[:, :, 0]
        u_hat = a / torch.clamp(y, min=TINY)
        r = torch.bmm(u_hat[:, None, :], K)[:, 0, :]
        v_hat = b / torch.clamp(r, min=TINY)
    y = torch.bmm(K, v_hat[:, :, None])[:, :, 0]
    return la - rmax - torch.log(torch.clamp(y, min=TINY))


def sinkhorn_scale(
    M_pad: torch.Tensor, la: torch.Tensor, lb: torch.Tensor, num_iters: int,
    k_dtype: torch.dtype,
) -> torch.Tensor:
    """u [B, R] of the scale-domain recursion: the CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor."""
    if M_pad.device.type == "cpu":
        return sinkhorn_scale_plain(M_pad, la, lb, num_iters, k_dtype)
    batch, rows, cols = M_pad.shape
    kernels.require(M_pad.is_cuda, f"unsupported device {M_pad.device}")
    kernels.require(
        M_pad.dtype == la.dtype == lb.dtype == torch.float32, "M_pad, la, lb must be f32"
    )
    kernels.require(
        M_pad.is_contiguous() and la.is_contiguous() and lb.is_contiguous(),
        "M_pad, la, lb must be contiguous",
    )
    kernels.require(
        la.shape == (batch, rows) and lb.shape == (batch, cols), "marginal shapes"
    )
    kernels.require(cols % COL_ALIGN == 0, f"column count must be a multiple of {COL_ALIGN}")
    kernels.require(k_dtype in (torch.float32, torch.bfloat16), f"K storage {k_dtype}")
    kernels.require(num_iters >= 1, "num_iters must be >= 1")
    max_cols = 1536 if k_dtype == torch.float32 else 4096
    kernels.require(cols <= max_cols, f"K {k_dtype} holds at most {max_cols} columns")
    kernels.require(not torch.is_grad_enabled() or not M_pad.requires_grad,
                    "the Sinkhorn kernel is forward only")
    K = torch.empty(batch, rows, cols, dtype=k_dtype, device=M_pad.device)
    u = torch.empty(batch, rows, dtype=torch.float32, device=M_pad.device)
    fn = kernels.entry_point(
        "sinkhorn", "og_sinkhorn_scale",
        [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    )
    status = fn(
        int(k_dtype == torch.bfloat16), M_pad.data_ptr(), la.data_ptr(), lb.data_ptr(),
        K.data_ptr(), u.data_ptr(), batch, rows, cols, num_iters,
        kernels.stream_handle(M_pad.device),
    )
    kernels.check(status, "og_sinkhorn_scale")
    counter.add()
    return u


def final_half_iteration(
    M_pad: torch.Tensor, u: torch.Tensor, lb: torch.Tensor, rows: int, cols: int
) -> torch.Tensor:
    """The column-stabilized last half-iteration and the log_P assembly over
    the original M (dead columns need column stabilization that the
    row-stabilized K cannot give)."""
    x = M_pad[:, :rows, :cols] + u[:, :rows, None]
    v = lb[:, None, :cols] - torch.logsumexp(x, dim=1, keepdim=True)
    return x + v


def log_optimal_transport(
    scores: torch.Tensor,
    dustbin_score: torch.Tensor,
    num_iters: int = 20,
    reg: float = 1.0,
    mask0: Optional[torch.Tensor] = None,
    mask1: Optional[torch.Tensor] = None,
    k_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Dustbin-augmented OT through the scale-domain kernel: scores [B, m, n]
    -> log-assignment [B, m+1, n+1]. ``k_dtype`` None applies the storage rule
    (``k_storage_dtype``)."""
    batch, m, n = scores.shape
    rows, cols = m + 1, n + 1
    rp, cp = rows, _round_up(cols, COL_ALIGN)
    if k_dtype is None:
        k_dtype = k_storage_dtype(rows, cols)
    M_pad = build_padded_otp_matrix(scores, dustbin_score, reg, mask0, mask1, rp, cp)
    log_a, log_b, norm = otp_marginals(batch, m, n, mask0, mask1, scores.device)
    la, lb = padded_marginals(log_a, log_b, rp, cp)
    u = sinkhorn_scale(M_pad, la, lb, num_iters, k_dtype)
    log_P = final_half_iteration(M_pad, u, lb, rows, cols)
    return (log_P - norm[:, None, None]).to(scores.dtype)
