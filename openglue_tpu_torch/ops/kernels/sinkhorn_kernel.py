"""Scale-domain Sinkhorn: the kernel wrapper (``ops/csrc/sinkhorn.cu``) and the
torch glue around it.

Port of ``openglue_tpu/ops/pallas/sinkhorn_kernel.py``. One CUDA kernel,
templated on K's storage type, replaces the three TPU kernels
``_sinkhorn_kernel_pair`` (:128), ``_sinkhorn_kernel`` (:56) and
``_blocked_scale_kernel`` (:315). Per batch element it runs

    rmax = max_j M_ij;  K = exp(M - rmax)   (formed once, f32 or bf16)
    v̂ = 1;  T-1 times:  û = a ⊘ max(K v̂, 1e-30),  v̂ = b ⊘ max(Kᵀ û, 1e-30)
    u = log_a - rmax - log(max(K v̂, 1e-30))

with a = exp(log_a), b = exp(log_b). The kernel holds K on chip across the
iterations: a launch plan (``launch_plan``, the mirror of the C plan in
``ops/csrc/sinkhorn_rows.cuh``) spreads each element over enough CTAs that
each one's stripe of rows fits its shared memory, and fills the card where
the batch allows it. The fused kernel (K2, counted by ``counter``) takes at
most 1536 columns with f32 K and 4096 with bf16 K (``FUSED_MAX_COLS``).
Beyond that the wide kernel (K2s, counted by ``stream_counter``), the
counterpart of ``_blocked_scale_kernel``, runs the same recursion in one
launch on the same engine under its own plan (``wide_launch_plan``): the
rows past the card's shared memory are written once to the workspace and
read once per iteration through a ring of one-row buffers in shared memory,
each row's dot, its u and its share of the column sums taken in one visit;
an element over more than eight clusters exchanges in two levels. No
``[B, R, C]`` K is allocated: the workspace holds the spilled rows and the
exchange.

The wide plan's reach ends where a CTA can no longer hold a row's column
sums in registers, eight 16-byte vectors a thread (24,576 columns with bf16
K, 12,288 with f32 K), or, where rows spill, where the vector and the
receive buffer (8 bytes a column) and the ring of two rows (4 bytes a bf16
column) no longer fit its shared memory together (about 19,300 bf16
columns; the first square shape past it is N=19,184). That is short of the
28,688 columns at which the per-column buffers alone fill shared memory:
reaching them needs a ring of part-rows or the buffers in device memory,
and no configuration asks for more than 2048 keypoints. Past the reach the
older streaming kernel runs, counted apart by ``legacy_stream_counter``: it
allocates K ``[B, R, C]`` in device memory and reads it in every
half-iteration, three launches per iteration.
``forward_route`` names the route, chosen from the shape before anything
runs. The padded cost matrix, the marginals, the final column-stabilized
half-iteration and the log_P assembly stay in torch, as they stay in XLA in
the JAX package.

The backward is the port of ``_sinkhorn_vjp_kernel_path`` (:670). A second
kernel (``ops/csrc/sinkhorn_adjoint.cu``, replacing
``_sinkhorn_adjoint_factors_kernel`` :548), on the same engine and plan,
replays the T iterations and runs the adjoint recursion, emitting rank-2T
factors P ``[B, 2T, R]`` and Q ``[B, 2T, C]``; the torch glue around it
zeroes the cotangent on masked entries and forms
``dM = g - exp(M - rmax) o (P^T Q)``. Masked entries get no gradient. The
adjoint kernel takes at most ``ADJOINT_MAX_COLS`` columns; beyond that the
backward is the VJP of the plain log-domain loop
(``ops/sinkhorn.py::log_optimal_transport``) through autograd, as the JAX
package sends shapes its adjoint kernel cannot hold to the XLA VJP of the
same loop (``sinkhorn_kernel.py:790-801``). The route is chosen from the
shape (``backward_route``) before anything runs, and ``autograd_counter``
counts the backwards that took the autograd route.
"""

from __future__ import annotations

import ctypes
import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch

from openglue_tpu_torch.ops import kernels
from openglue_tpu_torch.ops import sinkhorn as sinkhorn_ref

NEG_INF = -1e9
TINY = 1e-30
COL_ALIGN = 8  # column pitch of M_pad and K: 16-byte aligned rows in f32 and bf16

# Port-owned copy of the JAX package's VMEM budget (sinkhorn_kernel.py:39-50).
# It sized a TPU core's VMEM and means nothing on the H100; it is kept only to
# pick K's storage type as the JAX package does (f32 when the block fits, bf16
# from about N=1280 up), so that the two packages' numbers agree.
_VMEM_BUDGET_BYTES = 13 * 1024 * 1024

counter = kernels.LaunchCounter("K2 sinkhorn_scale")
stream_counter = kernels.LaunchCounter("K2s sinkhorn_scale_wide")  # the wide kernel
legacy_stream_counter = kernels.LaunchCounter("K2 sinkhorn_scale_streaming")  # past the wide plan's reach
adjoint_counter = kernels.LaunchCounter("K3 sinkhorn_adjoint")
autograd_counter = kernels.LaunchCounter("autograd Sinkhorn backward")  # no kernel

# the column limits of the fused forward kernel, by K's storage type; past
# them ``sinkhorn_scale`` runs the wide kernel (``forward_route``)
FUSED_MAX_COLS = {torch.float32: 1536, torch.bfloat16: 4096}

# ---- the launch plan: a mirror of ``make_plan`` in ops/csrc/sinkhorn_rows.cuh
SMEM_LIMIT = 232448  # the shared memory one block may opt into on the H100
# clusters of 1, 2, 4, 8, 16 CTAs (one per SM at the full shared memory) an
# H100 holds at once, as cudaOccupancyMaxActiveClusters reports them for the
# fused kernel (NVIDIA H100 80GB HBM3), and its SM count
H100_CLUSTER_CAPS = (132, 66, 30, 15, 7)
H100_SMS = 132
STRIPE_THREADS = 384  # a CTA of the on-chip kernels
RING_BARS = 4  # mbarriers the wide plan's ring reserves
FLAT_MAX_GROUPS = 8  # the wide plan's exchange has two levels past this many clusters per element


@dataclass(frozen=True)
class LaunchPlan:
    """How the fused kernel or the adjoint lays B elements of R x C out on
    the card: ``cs`` CTAs per cluster, ``groups`` clusters and ``ctas`` CTAs
    per element, ``slots`` elements in flight, taken in ``waves`` groups,
    ``grid`` CTAs launched; a CTA's ``rows`` in shared memory
    (``smem_rows``) and, past the card's room, in device memory
    (``spill_rows``); ``cooperative`` where an element spans clusters. The
    wide plan (K2s) adds a ring of ``stages`` one-row buffers
    (``ring_bytes`` of shared memory with its mbarriers) through which the
    spilled rows are read, the ``col_vecs`` 16-byte column vectors a thread
    sums in registers, and ``exchange_levels`` 2 where an element spans more
    than ``FLAT_MAX_GROUPS`` clusters (1: every CTA polls every cluster; 0:
    one cluster per element)."""

    cs: int
    groups: int
    ctas: int
    slots: int
    waves: int
    grid: int
    rows: int
    smem_rows: int
    spill_rows: int
    smem_bytes: int
    cooperative: int
    stages: int
    ring_bytes: int
    col_vecs: int
    exchange_levels: int
    exchange_bytes: int
    workspace_bytes: int

    def on_chip_bytes(self, cols: int, k_dtype: torch.dtype) -> int:
        """Bytes of K one CTA holds in shared memory."""
        return self.smem_rows * cols * _K_BYTES[k_dtype]

    def rows_of(self, part: int, num_rows: int) -> range:
        """The rows of an element that its CTA ``part`` owns."""
        return range(min(part * self.rows, num_rows), min((part + 1) * self.rows, num_rows))


_K_BYTES = {torch.float32: 4, torch.bfloat16: 2}


def _fixed_smem_bytes(cols: int) -> int:
    # the vector, the receive buffer (with up to 16 float4 of rounding), two mbarriers
    return 4 * cols + (4 * cols + 16 * 16) + 16


def _smem_rows_for(rows: int, cols: int, kbytes: int) -> int:
    room = SMEM_LIMIT - _fixed_smem_bytes(cols) - 12 * rows
    return 0 if room <= 0 else min(room // (cols * kbytes), rows)


def launch_plan(
    batch: int, num_rows: int, num_cols: int, k_dtype: torch.dtype,
    sms: int = H100_SMS, caps: Sequence[int] = H100_CLUSTER_CAPS,
) -> Optional[LaunchPlan]:
    """The plan the C code makes for ``batch`` elements of ``num_rows`` x
    ``num_cols`` with K in ``k_dtype`` on a card of ``sms`` SMs that holds
    ``caps[i]`` clusters of 2**i CTAs at once; None where it places none."""
    kb = _K_BYTES[k_dtype]
    on_chip = SMEM_LIMIT // (num_cols * kb) + 1
    while on_chip > 1 and _smem_rows_for(on_chip, num_cols, kb) < on_chip:
        on_chip -= 1
    p_min = -(-num_rows // on_chip)
    log_cs = next((i for i in range(5) if 2**i >= p_min and caps[i] > 0), None)
    if log_cs is not None:
        # one cluster per element: widen it while the card has room for every element
        while log_cs < 4 and batch * 2 ** (log_cs + 1) <= sms and caps[log_cs + 1] > 0:
            log_cs += 1
        cs = ctas = 2**log_cs
        groups = 1
        slots = min(batch, caps[log_cs])
        grid = batch * ctas
    else:
        # several clusters per element, all resident at once (cooperative): of
        # the cluster sizes 16, 8, 4, 2, the one that spills the fewest rows,
        # then takes the fewest waves, then fills the most SMs, then needs the
        # fewest clusters
        best = None
        for i in (4, 3, 2, 1):
            c, cap = 2**i, caps[i] * 2**i
            if cap == 0:
                continue
            g = -(-p_min // c)
            if g * c > cap:
                g = cap // c  # past the card's on-chip room: the rest spills
            n_ctas = g * c
            n_slots = min(cap // n_ctas, batch)
            n_rows = -(-num_rows // n_ctas)
            key = (n_rows if n_rows > on_chip else 0, -(-batch // n_slots), -n_slots * n_ctas, g)
            if best is None or key < best[0]:
                best = (key, c, g, n_ctas, n_slots)
        if best is None:
            return None
        _, cs, groups, ctas, slots = best
        grid = slots * ctas
    if ctas == 0 or slots == 0:
        return None
    rows = -(-num_rows // ctas)
    smem_rows = _smem_rows_for(rows, num_cols, kb)
    smem_bytes = smem_rows * num_cols * kb + _fixed_smem_bytes(num_cols) + 12 * rows
    if smem_bytes > SMEM_LIMIT:
        return None
    # two buffers of every cluster's sums, a float and the exchange's number per 8 bytes
    exchange = 2 * slots * groups * num_cols * 8 if groups > 1 else 0
    return LaunchPlan(
        cs=cs, groups=groups, ctas=ctas, slots=slots, waves=-(-batch // slots), grid=grid, rows=rows,
        smem_rows=smem_rows, spill_rows=rows - smem_rows, smem_bytes=smem_bytes,
        cooperative=int(groups > 1), stages=0, ring_bytes=0, col_vecs=0, exchange_levels=int(groups > 1),
        exchange_bytes=exchange, workspace_bytes=exchange + grid * (rows - smem_rows) * num_cols * kb,
    )


def _ring_bytes(stages: int, cols: int, kbytes: int) -> int:
    # the one-row buffers, the ring's mbarriers, two slots per warp for a row's dot
    return stages * cols * kbytes + 8 * RING_BARS + 2 * (STRIPE_THREADS // 32) * 4


def wide_launch_plan(
    batch: int, num_rows: int, num_cols: int, k_dtype: torch.dtype,
    sms: int = H100_SMS, caps: Sequence[int] = H100_CLUSTER_CAPS,
) -> Optional[LaunchPlan]:
    """The wide kernel's plan (K2s), the mirror of ``make_wide_plan``:
    ``launch_plan``'s CTAs and clusters; where rows spill, a ring of two
    one-row buffers taken out of the shared-memory rows; the fewest of 2, 4,
    8 column vectors a thread that cover a row; two exchange levels past
    ``FLAT_MAX_GROUPS`` clusters per element (single buffers of every
    cluster's sums and of the next vector). None past its reach."""
    plan = launch_plan(batch, num_rows, num_cols, k_dtype, sms, caps)
    if plan is None:
        return None
    kb = _K_BYTES[k_dtype]
    nvec = num_cols * kb // 16
    col_vecs = next((v for v in (2, 4, 8) if nvec <= v * STRIPE_THREADS), 0)
    if col_vecs == 0:
        return None
    fields = dict(col_vecs=col_vecs)
    if plan.spill_rows > 0:
        fixed = _fixed_smem_bytes(num_cols) + 12 * plan.rows
        stages = 2
        ring = _ring_bytes(stages, num_cols, kb)
        if fixed + ring > SMEM_LIMIT:
            return None
        smem_rows = min((SMEM_LIMIT - fixed - ring) // (num_cols * kb), plan.rows)
        fields.update(stages=stages, ring_bytes=ring, smem_rows=smem_rows, spill_rows=plan.rows - smem_rows,
                      smem_bytes=smem_rows * num_cols * kb + fixed + ring)
    if plan.groups > FLAT_MAX_GROUPS:
        fields.update(exchange_levels=2, exchange_bytes=plan.slots * (plan.groups + 1) * num_cols * 8)
    spill = fields.get("spill_rows", plan.spill_rows)
    fields["workspace_bytes"] = fields.get("exchange_bytes", plan.exchange_bytes) + plan.grid * spill * num_cols * kb
    return dataclasses.replace(plan, **fields)


def forward_route(
    batch: int, num_rows: int, num_cols: int, k_dtype: torch.dtype, plan_of=wide_launch_plan,
) -> str:
    """The Sinkhorn forward's route for ``batch`` elements of ``num_rows`` x
    ``num_cols`` (padded) with K in ``k_dtype``: "fused" (K2) up to
    ``FUSED_MAX_COLS[k_dtype]`` columns, past them "wide" (K2s) where
    ``plan_of(batch, num_rows, num_cols, k_dtype)`` places the shape, else
    "stream", the older streaming kernel. ``plan_of``: the H100's plan by
    its mirror (the default); ``sinkhorn_scale`` asks the card's C plan."""
    if num_cols <= FUSED_MAX_COLS[k_dtype]:
        return "fused"
    return "wide" if plan_of(batch, num_rows, num_cols, k_dtype) is not None else "stream"


_plans: Dict[tuple, tuple] = {}


_CUDA_ERROR_INVALID_CONFIGURATION = 9  # what a C plan returns where it places nothing


def kernel_plan(batch: int, num_rows: int, num_cols: int, k_dtype: torch.dtype, adjoint: bool = False):
    """(plan, caps, sms) as the C code makes it on the current card for the
    fused forward (with ``adjoint``, the adjoint kernel): the plan it
    launches, the clusters of 1..16 CTAs the card holds at once and its SM
    count. Raises where the plan places nothing. The wide kernel's:
    ``wide_kernel_plan``."""
    status, found = _card_plan(batch, num_rows, num_cols, k_dtype, "adjoint" if adjoint else "fused")
    kernels.check(status, f"the Sinkhorn launch plan for B={batch} R={num_rows} C={num_cols}")
    return found


def wide_kernel_plan(batch: int, num_rows: int, num_cols: int, k_dtype: torch.dtype):
    """The wide kernel's (plan, caps, sms) on the current card, or None where
    its plan places nothing (past its reach)."""
    status, found = _card_plan(batch, num_rows, num_cols, k_dtype, "wide")
    if status == _CUDA_ERROR_INVALID_CONFIGURATION:
        return None
    kernels.check(status, f"the K2s launch plan for B={batch} R={num_rows} C={num_cols}")
    return found


def _card_plan(batch, num_rows, num_cols, k_dtype, kind):
    """(CUDA status, (plan, caps, sms) or None) of ``kind`` ("fused",
    "adjoint", "wide") from the C code; a plan is cached."""
    key = (kind, batch, num_rows, num_cols, k_dtype, torch.cuda.current_device())
    found = _plans.get(key)
    if found is not None:
        return 0, found
    out = (ctypes.c_int * 21)()
    nbytes = (ctypes.c_longlong * 2)()
    if kind == "adjoint":
        fn = kernels.entry_point(
            "sinkhorn_adjoint", "og_sinkhorn_adjoint_plan", [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2)
        status = fn(batch, num_rows, num_cols, out, nbytes)
    else:
        symbol = "og_sinkhorn_wide_plan" if kind == "wide" else "og_sinkhorn_plan"
        fn = kernels.entry_point("sinkhorn", symbol, [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2)
        status = fn(int(k_dtype == torch.bfloat16), batch, num_rows, num_cols, out, nbytes)
    if status != 0:
        return status, None
    plan = LaunchPlan(*out[:15], exchange_bytes=nbytes[0], workspace_bytes=nbytes[1])
    found = _plans[key] = (plan, tuple(out[16:21]), out[15])
    return 0, found


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
    return torch.where(valid_row & valid_col, vals, NEG_INF)


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
    log_a = torch.cat(
        [torch.where(mask0, norm[:, None], NEG_INF),
         (norm + torch.log(torch.clamp(count1, min=1.0)))[:, None]], dim=1)
    log_b = torch.cat(
        [torch.where(mask1, norm[:, None], NEG_INF),
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
    tensor (the fused kernel up to ``FUSED_MAX_COLS[k_dtype]`` columns, the
    wide kernel beyond, the older streaming kernel past the wide plan's
    reach: ``forward_route``), the plain version for a CPU tensor."""
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
    kernels.require(not torch.is_grad_enabled() or not M_pad.requires_grad,
                    "the Sinkhorn kernel is forward only")
    u = torch.empty(batch, rows, dtype=torch.float32, device=M_pad.device)
    route = forward_route(batch, rows, cols, k_dtype, plan_of=_wide_plan_on_card)
    if route == "wide":
        # the workspace holds the spilled rows and the exchange, no [B, R, C] K
        workspace = _workspace(_wide_plan_on_card(batch, rows, cols, k_dtype), M_pad.device)
        fn = kernels.entry_point(
            "sinkhorn", "og_sinkhorn_scale_wide",
            [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
        )
        status = fn(
            int(k_dtype == torch.bfloat16), M_pad.data_ptr(), la.data_ptr(), lb.data_ptr(), u.data_ptr(),
            workspace.data_ptr() if workspace is not None else None, batch, rows, cols, num_iters,
            kernels.stream_handle(M_pad.device),
        )
        kernels.check(status, "og_sinkhorn_scale_wide")
        stream_counter.add(u)
        return u
    if route == "stream":
        K = torch.empty(batch, rows, cols, dtype=k_dtype, device=M_pad.device)
        size = kernels.entry_point(
            "sinkhorn", "og_sinkhorn_scale_streaming_workspace", [ctypes.c_int] * 3, ctypes.c_size_t
        )(batch, rows, cols)
        workspace = torch.empty(size, dtype=torch.uint8, device=M_pad.device)
        fn = kernels.entry_point(
            "sinkhorn", "og_sinkhorn_scale_streaming",
            [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
        )
        status = fn(
            int(k_dtype == torch.bfloat16), M_pad.data_ptr(), la.data_ptr(), lb.data_ptr(),
            K.data_ptr(), u.data_ptr(), workspace.data_ptr(), batch, rows, cols, num_iters,
            kernels.stream_handle(M_pad.device),
        )
        kernels.check(status, "og_sinkhorn_scale_streaming")
        legacy_stream_counter.add(u)
        return u
    # K stays on chip: the workspace holds only the exchange between clusters
    # (and rows past the card's on-chip room, where the plan spills any)
    workspace = _workspace(kernel_plan(batch, rows, cols, k_dtype)[0], M_pad.device)
    fn = kernels.entry_point(
        "sinkhorn", "og_sinkhorn_scale",
        [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    )
    status = fn(
        int(k_dtype == torch.bfloat16), M_pad.data_ptr(), la.data_ptr(), lb.data_ptr(), u.data_ptr(),
        workspace.data_ptr() if workspace is not None else None, batch, rows, cols, num_iters,
        kernels.stream_handle(M_pad.device),
    )
    kernels.check(status, "og_sinkhorn_scale")
    counter.add(u)
    return u


def _wide_plan_on_card(batch: int, num_rows: int, num_cols: int, k_dtype: torch.dtype) -> Optional[LaunchPlan]:
    found = wide_kernel_plan(batch, num_rows, num_cols, k_dtype)
    return None if found is None else found[0]


def _workspace(plan: LaunchPlan, device: torch.device) -> Optional[torch.Tensor]:
    if plan.workspace_bytes == 0:
        return None
    return torch.empty(plan.workspace_bytes, dtype=torch.uint8, device=device)


def final_half_iteration(
    M_pad: torch.Tensor, u: torch.Tensor, lb: torch.Tensor, rows: int, cols: int
) -> torch.Tensor:
    """The column-stabilized last half-iteration and the log_P assembly over
    the original M (dead columns need column stabilization that the
    row-stabilized K cannot give)."""
    x = M_pad[:, :rows, :cols] + u[:, :rows, None]
    v = lb[:, None, :cols] - torch.logsumexp(x, dim=1, keepdim=True)
    return x + v


def _log_ot_forward(scores, dustbin_score, num_iters, reg, mask0, mask1, k_dtype):
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


def sinkhorn_adjoint_plain(
    M_pad: torch.Tensor, la: torch.Tensor, lb: torch.Tensor, rmax: torch.Tensor,
    g_rowsum: torch.Tensor, g_colsum: torch.Tensor, num_iters: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the adjoint kernel: M_pad [B, R, C], la, rmax,
    g_rowsum [B, R], lb, g_colsum [B, C] (f32) -> P [B, 2T, R], Q [B, 2T, C].

    Forward replay (v_0 = 1): y_t = max(K v_{t-1}, tiny), u_t = a / y_t,
    r_t = max(K^T u_t, tiny), v_t = b / r_t with K = exp(M - rmax). Reverse,
    t = T-1..0 from gv = g_colsum: P[t] = u_t, Q[t] = gv / r_t,
    gu = [t = T-1] g_rowsum - u_t o K (gv / r_t), P[T+t] = gu / y_t,
    Q[T+t] = v_{t-1} (1 at t = 0), gv = -v_{t-1} o K^T (gu / y_t)."""
    T = num_iters
    K = torch.exp(M_pad - rmax[:, :, None])
    a, b = torch.exp(la), torch.exp(lb)

    def rows_dot(vec):  # K vec, [B, R]
        return torch.bmm(K, vec[:, :, None])[:, :, 0]

    def cols_dot(vec):  # K^T vec, [B, C]
        return torch.bmm(vec[:, None, :], K)[:, 0, :]

    us, ys, rs, vs = [], [], [], []
    v_hat = torch.ones_like(lb)
    for _ in range(T):
        y = torch.clamp(rows_dot(v_hat), min=TINY)
        u_hat = a / y
        r = torch.clamp(cols_dot(u_hat), min=TINY)
        v_hat = b / r
        us.append(u_hat)
        ys.append(y)
        rs.append(r)
        vs.append(v_hat)

    batch, rows, cols = M_pad.shape
    P = torch.empty(batch, 2 * T, rows, dtype=torch.float32, device=M_pad.device)
    Q = torch.empty(batch, 2 * T, cols, dtype=torch.float32, device=M_pad.device)
    gv = g_colsum
    for t_rev in range(T):
        slot = T - 1 - t_rev
        w = gv / rs[slot]
        direct = g_rowsum if t_rev == 0 else torch.zeros_like(g_rowsum)
        gu = direct - us[slot] * rows_dot(w)
        v_prev = vs[slot - 1] if slot > 0 else torch.ones_like(gv)
        s = gu / ys[slot]
        P[:, slot], Q[:, slot] = us[slot], w
        P[:, T + slot], Q[:, T + slot] = s, v_prev
        gv = -v_prev * cols_dot(s)
    return P, Q


ADJOINT_MAX_COLS = 1536  # as K2's f32 path: past it the autograd route


def sinkhorn_adjoint(
    M_pad: torch.Tensor, la: torch.Tensor, lb: torch.Tensor, rmax: torch.Tensor,
    g_rowsum: torch.Tensor, g_colsum: torch.Tensor, num_iters: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rank-2T adjoint factors (P, Q): the CUDA kernel for a CUDA tensor,
    the plain version for a CPU tensor."""
    if M_pad.device.type == "cpu":
        return sinkhorn_adjoint_plain(M_pad, la, lb, rmax, g_rowsum, g_colsum, num_iters)
    batch, rows, cols = M_pad.shape
    device = M_pad.device
    vectors = (la, rmax, g_rowsum, lb, g_colsum)
    kernels.require(M_pad.is_cuda, f"unsupported device {device}")
    kernels.require(
        all(t.dtype == torch.float32 and t.is_contiguous() and t.device == device
            for t in (M_pad, *vectors)),
        "M_pad, la, lb, rmax and the cotangent sums must be contiguous f32 on one device",
    )
    kernels.require(
        la.shape == rmax.shape == g_rowsum.shape == (batch, rows)
        and lb.shape == g_colsum.shape == (batch, cols),
        "vector shapes",
    )
    kernels.require(cols % COL_ALIGN == 0, f"column count must be a multiple of {COL_ALIGN}")
    kernels.require(
        cols <= ADJOINT_MAX_COLS,
        f"the Sinkhorn adjoint kernel holds at most {ADJOINT_MAX_COLS} columns, got {cols}",
    )
    kernels.require(num_iters >= 1, "num_iters must be >= 1")
    T = num_iters
    hist = torch.empty(batch, T, 2 * rows + 2 * cols, dtype=torch.float32, device=device)
    P = torch.empty(batch, 2 * T, rows, dtype=torch.float32, device=device)
    Q = torch.empty(batch, 2 * T, cols, dtype=torch.float32, device=device)
    workspace = _workspace(kernel_plan(batch, rows, cols, torch.float32, adjoint=True)[0], device)
    fn = kernels.entry_point(
        "sinkhorn_adjoint", "og_sinkhorn_adjoint",
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    )
    status = fn(
        M_pad.data_ptr(), la.data_ptr(), lb.data_ptr(), rmax.data_ptr(), g_rowsum.data_ptr(),
        g_colsum.data_ptr(), hist.data_ptr(), P.data_ptr(), Q.data_ptr(),
        workspace.data_ptr() if workspace is not None else None, batch, rows, cols, T,
        kernels.stream_handle(device),
    )
    kernels.check(status, "og_sinkhorn_adjoint")
    adjoint_counter.add(P, Q)
    return P, Q


def valid_pairs(batch, m, n, mask0, mask1, device) -> torch.Tensor:
    """[B, m+1, n+1] bool: entries whose row and column are valid (dustbins
    always are)."""
    ones = torch.ones(batch, 1, dtype=torch.bool, device=device)
    if mask0 is None:
        mask0 = torch.ones(batch, m, dtype=torch.bool, device=device)
    if mask1 is None:
        mask1 = torch.ones(batch, n, dtype=torch.bool, device=device)
    valid_row = torch.cat([mask0, ones], dim=1)
    valid_col = torch.cat([mask1, ones], dim=1)
    return valid_row[:, :, None] & valid_col[:, None, :]


def log_optimal_transport_vjp(
    scores: torch.Tensor,
    dustbin_score: torch.Tensor,
    g: torch.Tensor,
    num_iters: int,
    reg: float,
    mask0: Optional[torch.Tensor],
    mask1: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d scores, d dustbin) from the cotangent g [B, m+1, n+1] of log_P: the
    port of ``_sinkhorn_vjp_kernel_path``. Cotangents on masked entries are
    zeroed first: every loss reads only valid entries, and the gradient
    through the -1e9 logits would otherwise be garbage-magnitude."""
    batch, m, n = scores.shape
    rows, cols = m + 1, n + 1
    rp, cp = rows, _round_up(cols, COL_ALIGN)
    device = scores.device
    M_pad = build_padded_otp_matrix(scores, dustbin_score, reg, mask0, mask1, rp, cp)
    log_a, log_b, _ = otp_marginals(batch, m, n, mask0, mask1, device)
    la, lb = padded_marginals(log_a, log_b, rp, cp)
    pair_valid = valid_pairs(batch, m, n, mask0, mask1, device)
    g_pad = torch.zeros(batch, rp, cp, dtype=torch.float32, device=device)
    g_pad[:, :rows, :cols] = torch.where(pair_valid, g.float(), 0.0)

    # the per-row max stabilizes the split exponentials of the factors; the
    # row and column sums are the only pieces of g the kernel needs
    rmax = M_pad.amax(dim=2)
    g_rowsum = g_pad.sum(dim=2)
    g_colsum = g_pad.sum(dim=1)
    P, Q = sinkhorn_adjoint(M_pad, la, lb, rmax, g_rowsum, g_colsum, num_iters)
    dm = g_pad - torch.exp(M_pad - rmax[:, :, None]) * torch.bmm(P.transpose(1, 2), Q)

    dS_aug = torch.where(pair_valid, dm[:, :rows, :cols] / reg, 0.0)
    dscores = dS_aug[:, :m, :n].to(scores.dtype)
    ddustbin = (dS_aug[:, m, :].sum() + dS_aug[:, :m, n].sum()).to(dustbin_score.dtype)
    return dscores, ddustbin


def backward_route(num_cols: int) -> str:
    """The Sinkhorn backward's route for ``num_cols`` padded columns (n + 1
    rounded up to ``COL_ALIGN``): "kernel", the adjoint kernel, where it holds
    the columns, else "autograd", the VJP of the plain log-domain loop."""
    return "kernel" if num_cols <= ADJOINT_MAX_COLS else "autograd"


def log_optimal_transport_autograd_vjp(
    scores: torch.Tensor,
    dustbin_score: torch.Tensor,
    g: torch.Tensor,
    num_iters: int,
    reg: float,
    mask0: Optional[torch.Tensor],
    mask1: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d scores, d dustbin) from the cotangent g [B, m+1, n+1] of log_P: the
    VJP of ``ops/sinkhorn.py::log_optimal_transport`` on the same inputs,
    through autograd (the JAX package's XLA route). g is taken as it comes,
    as that VJP takes it."""
    with torch.enable_grad():
        s = scores.detach().requires_grad_()
        d = dustbin_score.detach().requires_grad_()
        out = sinkhorn_ref.log_optimal_transport(s, d, num_iters, reg, mask0, mask1)
        return torch.autograd.grad(out, (s, d), g.to(out.dtype))


class _LogOptimalTransport(torch.autograd.Function):
    """Forward through the scale-domain kernel, backward through the adjoint
    kernel or, beyond its columns, the autograd route (``backward_route``);
    the gradient flows to the scores and the dustbin score."""

    @staticmethod
    def forward(ctx, scores, dustbin_score, num_iters, reg, mask0, mask1, k_dtype):
        ctx.save_for_backward(scores, dustbin_score, mask0, mask1)
        ctx.num_iters, ctx.reg = num_iters, reg
        return _log_ot_forward(scores, dustbin_score, num_iters, reg, mask0, mask1, k_dtype)

    @staticmethod
    def backward(ctx, g):
        scores, dustbin_score, mask0, mask1 = ctx.saved_tensors
        args = (scores, dustbin_score, g, ctx.num_iters, ctx.reg, mask0, mask1)
        if backward_route(_round_up(scores.shape[2] + 1, COL_ALIGN)) == "autograd":
            dscores, ddustbin = log_optimal_transport_autograd_vjp(*args)
            autograd_counter.add()
        else:
            dscores, ddustbin = log_optimal_transport_vjp(*args)
        return dscores, ddustbin, None, None, None, None, None


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
    -> log-assignment [B, m+1, n+1], differentiable in the scores and the
    dustbin score. ``k_dtype`` None applies the storage rule
    (``k_storage_dtype``)."""
    dustbin_score = torch.as_tensor(dustbin_score, dtype=torch.float32, device=scores.device)
    return _LogOptimalTransport.apply(scores, dustbin_score, num_iters, reg, mask0, mask1, k_dtype)
