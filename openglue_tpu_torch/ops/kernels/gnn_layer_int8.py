"""The int8-quantized eval layer of the serving path: the kernel wrapper
(``ops/csrc/gnn_layer_int8.cu``), its plain version, the weight quantizer and
the calibration pass.

Port of ``openglue_tpu/ops/pallas/gnn_layer_int8.py`` (``_layer_kernel_int8``
via ``fused_attention_propagation_int8``). It is the softmax eval layer of
``gnn_layer_kernel`` with its six dense products in s8 x s8 -> s32:

* weights: symmetric per-output-channel int8, quantized once from the folded
  f32 weights (scale = absmax / 127 + 1e-12);
* activations, dynamic: symmetric per-row int8, ``round(x / s_row)`` with
  ``s_row = absmax_row / 127 + 1e-12``; static: one calibrated scale per site,
  ``round(x * (1 / s))``. Rounding is half to even, then a clip to +-127;
* dequantization is exact: ``acc * (s_row * s_col) + bias`` in f32;
* attention runs in ``attn_dtype`` (bf16) as in the softmax layer, from the f32
  q, k, v; with ``quant_attention`` its two products run in s8 as well: q, k
  and v are quantized per tensor (``round(x * (1 / s))``), the logits are
  ``acc * (s_q * s_k * dh^-0.5) + (1 - mask) * -1e9``, the probabilities
  ``round(exp(logit - rowmax) * 127)`` against the final row max, the
  denominator sums the unquantized f32 p, and
  ``o = acc * (s_v / 127) / denom``.

The activation sites, in the order of ``act_scales`` and of the calibration
vector: kv, xq, attn, cat, h1 and, with ``quant_attention``, k_attn, v_attn,
q_attn.

Dynamic ``quant_attention`` takes ONE scale per batch element for each of q,
k and v, in the kernel and in the plain version alike. The TPU kernel takes
q's per query block and k/v's per element, and its block size depends on the
batch and the key count; the JAX XLA oracle takes one over the whole batch.
Here neither a block size nor the composition of a batch decides a served
result. Static mode shares one calibrated grid with the JAX package.

A fully masked key set averages uniformly, as in the softmax layer. Forward
only: this is a serving path.

The kernel (D = 128 or 256) runs every s8 product as a wgmma GEMM whose
64-row tiles own whole output rows, with each quantization folded into the
GEMM that produces or consumes it. Its launches, tiles, CTAs and shared
memory are mirrored here by ``int8_plan`` and its workspace by
``workspace_bytes``; the CPU tests hold the mirror at every shape, the card
tests against the C plan (``kernel_int8_plan``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from openglue_tpu_torch.ops import kernels
from openglue_tpu_torch.ops.kernels.gnn_layer_kernel import NEG_INF, PropagationWeights

EPS = 1e-12
SITES = 5  # kv, xq, attn, cat, h1
ATTENTION_SITES = 8  # + k_attn, v_attn, q_attn
WIDTHS = (128, 256)  # the model widths D the kernel is instantiated for

counter = kernels.LaunchCounter("K7 gnn_layer_int8")
# the kernels and memsets the layer's library launched, counted by its C code
launch_counter = kernels.LibraryLaunchCounter("gnn_layer_int8.cu", "og_gnn_layer_int8_launches", 0)
memset_counter = kernels.LibraryLaunchCounter("gnn_layer_int8.cu", "og_gnn_layer_int8_launches", 1)

# ---------------------------------------------------------------- the plan
# (mirrors og_gnn_layer_int8_plan and carve in ops/csrc/gnn_layer_int8.cu)

H100_SMS = 132
SMEM_CAP = 232448  # bytes of shared memory a block may take on sm_90
TILE_ROWS = 64  # rows of a GEMM tile: one wgmma M; it owns whole output rows
RESIDENT_BYTES = 131072  # the largest weight a GEMM CTA keeps in shared memory
RING_K, RING_STAGES = 64, 3  # the k-tile (bytes) and stages of a streamed weight
RAW_BYTES = 32768  # the raw rows a GEMM quantizes on load, per TMA fill
DUMP_LD = 36  # s32 per row of a GEMM consumer's 32-column dump tile
ATTN_QUERIES, ATTN_KEYS, ATTN_STAGES = 128, 128, 4  # attention_s8's tiles and ring
BF16_ATTN_STAGES = 3  # attention_bf16's ring (attention.cuh)
# the five GEMMs as (name, output columns / D, k / D, epilogue: None for the
# kv and q GEMMs, whose epilogue follows the attention mode); the first three
# quantize their A on load
GEMMS = (("kv", 2, 1, None), ("q", 1, 1, None), ("out", 1, 1, "cat8"), ("ffn1", 2, 2, "h18"),
         ("ffn2", 1, 2, "residual"))
QUANTIZED_ON_LOAD = ("kv", "q", "out")


class Int8Plan(NamedTuple):
    """How one layer runs: kernel launches and memsets per layer, rows per GEMM
    tile, persistent GEMM CTAs over the key rows and over the query rows,
    attention CTAs, and each launch's shared memory in bytes."""

    launches: int
    memsets: int
    tile_rows: int
    kv_ctas: int
    q_ctas: int
    attention_ctas: int
    smem_kv: int
    smem_q: int
    smem_out: int
    smem_ffn1: int
    smem_ffn2: int
    smem_attention: int


def gemm_smem_bytes(epilogue: str, cols: int, k: int, quantize_on_load: bool) -> int:
    """``S8Tile<EPI, QA, BN = cols / 2, K = k>::bytes``: 1024 bytes of slack to
    align to the swizzle period, the A tile of 64 x k bytes (two slots when
    TMA fills it, one when the consumers quantize it from 32 KB of raw rows),
    the weight (resident where cols x k <= 128 KB, else a three-stage ring of
    64-byte k-tiles), the out GEMM's x_q rows (64 x D, f32 at most), each
    consumer's dump tile of 32-column chunks (64 rows x 36 s32), the V^T
    staging tile [BN][80] of the static int8 attention's kv GEMM, the output
    columns' scales and biases (and a1, c1 for ffn1), the row scales, the
    row-absmax exchange and the barriers."""
    bn, slots = cols // 2, 1 if quantize_on_load else 2
    resident = cols * k <= RESIDENT_BYTES
    w_bytes = cols * k if resident else RING_STAGES * cols * RING_K
    stages = 1 if resident else RING_STAGES
    raw = RAW_BYTES if quantize_on_load else 0
    vt = bn * (TILE_ROWS + 16) if epilogue == "quant_attn" else 0
    vectors = (4 if epilogue == "h18" else 2) * cols * 4  # column scales, biases (a1, c1)
    x_rows = TILE_ROWS * cols * 4 if epilogue == "cat8" else 0  # the out GEMM's x_q rows (f32 at most)
    return (1024 + slots * TILE_ROWS * k + raw + w_bytes + x_rows + 2 * TILE_ROWS * DUMP_LD * 4 + vt + vectors
            + slots * TILE_ROWS * 4 + 4 * TILE_ROWS * 4 + (8 + 2 * stages) * 8)


def attention_smem_bytes(head_dim: int, quant_attention: bool) -> int:
    """attention_s8's (two Q tiles, four stages of a K and a V^T tile, their
    masks and key classes, barriers) or attention_bf16's (attention.cuh's Bf16Attn)."""
    if quant_attention:
        tile = ATTN_QUERIES * head_dim
        return 1024 + 2 * tile + ATTN_STAGES * 2 * tile + 2 * ATTN_STAGES * ATTN_KEYS * 4 + (4 + 2 * ATTN_STAGES) * 8
    tile = 128 * 2 * head_dim
    return 1024 + 2 * tile + 2 * BF16_ATTN_STAGES * tile + BF16_ATTN_STAGES * 128 * 4 + (4 + 2 * BF16_ATTN_STAGES) * 8


def int8_plan(batch, n, m, dim, heads, quant_attention, static, sms=H100_SMS) -> Int8Plan:
    """The plan of ``og_gnn_layer_int8_plan``: six launches (kv, q, the
    attention, out, ffn1, ffn2), seven and a memset with dynamic int8
    attention (+ the absmax memset and the q/k/V^T quantization); GEMM CTAs
    persistent over 64-row tiles, at most one per SM; attention CTAs over
    128-query tiles of one (element, head)."""
    dynamic_attention = quant_attention and not static
    kv_epilogue = ("quant_attn" if static else "f32_absmax") if quant_attention else "bf16"
    smem = [gemm_smem_bytes(epilogue or kv_epilogue, cols * dim, k * dim, name in QUANTIZED_ON_LOAD)
            for name, cols, k, epilogue in GEMMS]
    tiles = lambda rows: -(-rows // TILE_ROWS)
    attention_tiles = -(-n // 128) * heads * batch
    return Int8Plan(
        7 if dynamic_attention else 6, 1 if dynamic_attention else 0, TILE_ROWS,
        min(tiles(batch * m), sms), min(tiles(batch * n), sms), min(attention_tiles, sms), *smem,
        attention_smem_bytes(dim // heads, quant_attention),
    )


def vt_pos(m: int) -> int:
    """Where V^T keeps key m (``vt_pos`` in the kernel): inside each block of
    32, position 16 hf + 4 u + i holds key 16 hf + 8 (i >> 1) + 2 u + (i & 1),
    the key whose probability P.V's register A operand holds at that k index
    (the s32 accumulator's thread u owns columns 2u, 2u + 1, 8 + 2u, 9 + 2u of
    each half of 16)."""
    return (m & ~15) | (((m >> 1) & 3) << 2) | (((m >> 3) & 1) << 1) | (m & 1)


def keys_padded(m: int) -> int:
    """V^T's key count: M rounded up to 64 (the keys past M are 0)."""
    return -(-m // 64) * 64


def workspace_bytes(batch, n, m, dim, quant_attention, static) -> int:
    """``og_gnn_layer_int8_workspace``: the attention output (f32), cat8 and
    h18 (s8, 2D wide) with their f32 row scales; bf16 q and k|v, or q8, k8
    and V^T [B, H, dh, Mp] with, for dynamic scales, f32 q and k|v and three
    absmax words per element. Each block 256-byte aligned. No f32 cat or h1."""
    rq, rk = batch * n, batch * m
    blocks = [rq * dim * 4, rq * 2 * dim, rq * 4, rq * 2 * dim, rq * 4]
    if not quant_attention:
        blocks += [rk * 2 * dim * 2, rq * dim * 2]
    else:
        blocks += [rq * dim, rk * dim, batch * dim * keys_padded(m)]
        if not static:
            blocks += [rk * 2 * dim * 4, rq * dim * 4, 3 * batch * 4]
    return sum(-(-b // 256) * 256 for b in blocks)


def kernel_int8_plan(batch, n, m, dim, heads, quant_attention, static):
    """(Int8Plan, SM count) as the C code computes it on the current card
    (``og_gnn_layer_int8_plan``; builds the kernels on first use)."""
    fn = kernels.entry_point(
        "gnn_layer_int8", "og_gnn_layer_int8_plan", [ctypes.c_int] * 8 + [ctypes.POINTER(ctypes.c_int)]
    )
    out = (ctypes.c_int * 13)()
    status = fn(1, batch, n, m, dim, heads, int(quant_attention), int(static), out)
    kernels.check(status, "og_gnn_layer_int8_plan")
    return Int8Plan(*out[:12]), out[12]


def kernel_workspace_bytes(batch, n, m, dim, heads, quant_attention, static) -> int:
    """``og_gnn_layer_int8_workspace`` on the card (builds on first use)."""
    fn = kernels.entry_point(
        "gnn_layer_int8", "og_gnn_layer_int8_workspace", [ctypes.c_int] * 8, ctypes.c_size_t
    )
    return fn(1, batch, n, m, dim, heads, int(quant_attention), int(static))


def s8_wgmma_probe(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [64, K] s8 . b [N, K]^T -> s32 [64, N] (K = 64 or 128, N = 64, 128 or
    256) by one warpgroup's s8 wgmma on TMA tiles with the layer's swizzled
    descriptors (``og_s8_wgmma_probe``): the card test holds it bit-equal to
    ``torch._int_mm``."""
    kernels.require(a.is_cuda and a.dtype == torch.int8 and b.dtype == torch.int8, "s8 CUDA operands")
    k = a.shape[1]
    kernels.require(a.shape == (64, k) and k in (64, 128) and b.shape[1] == k and b.shape[0] in (64, 128, 256),
                    f"probe shapes {tuple(a.shape)} {tuple(b.shape)}")
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty(64, b.shape[0], dtype=torch.int32, device=a.device)
    fn = kernels.entry_point("gnn_layer_int8", "og_s8_wgmma_probe", [_VOID_P, _VOID_P, ctypes.c_int, ctypes.c_int,
                                                                       _VOID_P, _VOID_P])
    kernels.check(fn(a.data_ptr(), b.data_ptr(), b.shape[0], k, out.data_ptr(), kernels.stream_handle(a.device)),
                  "og_s8_wgmma_probe")
    return out


class QuantPropagationWeights(NamedTuple):
    """Per-output-channel symmetric int8 weights in torch layout ``[out, in]``
    with f32 scales ``[out]`` (absmax / 127 + 1e-12) and f32 biases ``[out]``;
    a1, c1 are the folded eval BatchNorm affine."""

    wq: torch.Tensor
    sq: torch.Tensor
    bq: torch.Tensor
    wk: torch.Tensor
    sk: torch.Tensor
    bk: torch.Tensor
    wv: torch.Tensor
    sv: torch.Tensor
    bv: torch.Tensor
    wo: torch.Tensor
    so: torch.Tensor
    bo: torch.Tensor
    w1: torch.Tensor
    s1: torch.Tensor
    b1: torch.Tensor
    a1: torch.Tensor
    c1: torch.Tensor
    w2: torch.Tensor
    s2: torch.Tensor
    b2: torch.Tensor


def _absmax_scale(absmax: torch.Tensor) -> torch.Tensor:
    """absmax / 127 + 1e-12 with a true f32 division on every device (torch
    turns a division by a Python scalar into a multiplication by its
    reciprocal on CUDA, which moves the scale by an ulp)."""
    return absmax / absmax.new_tensor(127.0) + EPS


def _quantize_per_channel(w: torch.Tensor):
    """[out, in] -> (int8 [out, in], f32 scale [out])."""
    w = w.float()
    scale = _absmax_scale(w.abs().amax(dim=1))
    wi8 = torch.clamp(torch.round(w / scale[:, None]), -127, 127).to(torch.int8)
    return wi8.contiguous(), scale.contiguous()


def quantize_propagation_weights(w: PropagationWeights) -> QuantPropagationWeights:
    """Quantize folded eval-mode layer weights to per-channel int8."""
    out = []
    for name in ("q", "k", "v", "o", "1", "2"):
        out += [*_quantize_per_channel(getattr(w, f"w{name}")), getattr(w, f"b{name}").float()]
        if name == "1":
            out += [w.a1.float(), w.c1.float()]
    return QuantPropagationWeights(*out)


def _int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The exact integer product of two int8-valued tensors, as f32 (the
    rounding of an s32 -> f32 conversion): computed in f64, where every
    partial sum is exact."""
    return torch.matmul(a.double(), b.double()).float()


def _check_sites(act_scales: Optional[torch.Tensor], quant_attention: bool) -> None:
    if quant_attention and act_scales is not None and act_scales.shape[0] < ATTENTION_SITES:
        raise ValueError(
            "quant_attention=True needs 8 calibrated activation sites (kv, xq, attn, cat, "
            f"h1, k_attn, v_attn, q_attn); got act_scales.shape={tuple(act_scales.shape)}. "
            "Re-calibrate with quantize='int8_static_attn' (the 5-site int8_static "
            "calibration does not cover the attention operands)."
        )


def layer_int8_plain(
    x_q: torch.Tensor,
    x_kv: torch.Tensor,
    kv_mask: Optional[torch.Tensor],
    w: QuantPropagationWeights,
    num_heads: int,
    use_offset: bool = False,
    attn_dtype: torch.dtype = torch.bfloat16,
    act_scales: Optional[torch.Tensor] = None,
    collect_absmax: bool = False,
    quant_attention: bool = False,
):
    """The plain version of the kernel, with its rounding points (module
    docstring). ``act_scales`` [5] or [8] f32 selects static quantization;
    ``collect_absmax`` also returns the per-site absmax of the quantized
    activations, [5] or [8]: the calibration pass."""
    _check_sites(act_scales, quant_attention)
    batch, n, dim = x_q.shape
    m = x_kv.shape[1]
    dh = dim // num_heads
    absmaxes = [None] * (ATTENTION_SITES if quant_attention else SITES)

    def quant_rows(x, site):
        if collect_absmax:
            absmaxes[site] = x.abs().amax()
        if act_scales is not None:
            sx = act_scales[site].float()
            xi = torch.round(x * (1.0 / sx))
        else:
            sx = _absmax_scale(x.abs().amax(dim=-1, keepdim=True))
            xi = torch.round(x / sx)
        return torch.clamp(xi, -127, 127), sx

    def quant_tensor(x, site):  # one scale per batch element, or the calibrated one
        if collect_absmax:
            absmaxes[site] = x.abs().amax()
        if act_scales is not None:
            sx = act_scales[site].float().reshape(1, 1, 1)
        else:
            sx = _absmax_scale(x.abs().amax(dim=(1, 2), keepdim=True))
        return torch.clamp(torch.round(x * (1.0 / sx)), -127, 127), sx

    def qdense(xi, sx, wi8, sw, bias):
        return _int_matmul(xi, wi8.t()) * (sx * sw) + bias

    def split(t, length):  # [B, L, D] -> [B, H, L, dh]
        return t.reshape(batch, length, num_heads, dh).transpose(1, 2)

    xq = x_q.float()
    kv_i8, s_kv = quant_rows(x_kv.float(), 0)
    xq_i8, s_xq = quant_rows(xq, 1)
    kf = qdense(kv_i8, s_kv, w.wk, w.sk, w.bk)
    vf = qdense(kv_i8, s_kv, w.wv, w.sv, w.bv)
    qf = qdense(xq_i8, s_xq, w.wq, w.sq, w.bq)

    if kv_mask is None:
        mask_add = torch.zeros(batch, m, dtype=torch.float32, device=x_q.device)
    else:
        mask_add = (1.0 - kv_mask.float()) * NEG_INF
    mask_add = mask_add[:, None, None, :]
    if quant_attention:
        k_i8, s_ka = quant_tensor(kf, 5)
        v_i8, s_va = quant_tensor(vf, 6)
        q_i8, s_qa = quant_tensor(qf, 7)
        acc = _int_matmul(split(q_i8, n), split(k_i8, m).transpose(-1, -2))
        logits = acc * (s_qa * s_ka * dh**-0.5)[:, None] + mask_add
        p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
        denom = p.sum(dim=-1, keepdim=True)
        o_acc = _int_matmul(torch.round(p * 127.0), split(v_i8, m))
        o = o_acc * (s_va * (1.0 / 127.0))[:, None] / denom
    else:
        q, k, v = qf.to(attn_dtype), kf.to(attn_dtype), vf.to(attn_dtype)
        logits = torch.matmul(split(q, n).float(), split(k, m).float().transpose(-1, -2))
        logits = logits * dh**-0.5 + mask_add
        p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
        denom = p.sum(dim=-1, keepdim=True)
        o = torch.matmul(p.to(attn_dtype).float(), split(v, m).float()) / denom
    attn = o.transpose(1, 2).reshape(batch, n, dim)

    msg = qdense(*quant_rows(attn, 2), w.wo, w.so, w.bo)
    cat = torch.cat([xq - msg if use_offset else xq, msg], dim=-1)
    h1 = torch.relu(qdense(*quant_rows(cat, 3), w.w1, w.s1, w.b1))
    h1 = h1 * w.a1 + w.c1
    upd = qdense(*quant_rows(h1, 4), w.w2, w.s2, w.b2)
    out = (xq + upd).to(x_q.dtype)
    if collect_absmax:
        return out, torch.stack(absmaxes)
    return out


def reference_activation_absmax(
    x_q: torch.Tensor,
    x_kv: torch.Tensor,
    kv_mask: Optional[torch.Tensor],
    w: QuantPropagationWeights,
    num_heads: int,
    use_offset: bool = False,
    quant_attention: bool = False,
) -> torch.Tensor:
    """The calibration pass of static quantization: the dynamically quantized
    plain forward's per-site activation absmax, [5], or [8] with
    ``quant_attention``. Static scales are absmax * headroom / 127."""
    _, absmax = layer_int8_plain(
        x_q, x_kv, kv_mask, w, num_heads, use_offset, collect_absmax=True,
        quant_attention=quant_attention,
    )
    return absmax


_VOID_P = ctypes.c_void_p


def fused_attention_propagation_int8(
    x_q: torch.Tensor,
    x_kv: torch.Tensor,
    kv_mask: Optional[torch.Tensor],
    w: QuantPropagationWeights,
    num_heads: int,
    use_offset: bool = False,
    attn_dtype: torch.dtype = torch.bfloat16,
    act_scales: Optional[torch.Tensor] = None,
    quant_attention: bool = False,
) -> torch.Tensor:
    """One eval layer with its dense products in int8: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors. x_q [B, N, D], x_kv
    [B, M, D] (f32 or bf16), kv_mask [B, M] bool or None -> [B, N, D] in x_q's
    type. ``act_scales`` [5] or [8] f32 switches to static scales;
    ``quant_attention`` runs q.k^T and P.V in int8 too."""
    _check_sites(act_scales, quant_attention)
    if x_q.device.type == "cpu":
        return layer_int8_plain(
            x_q, x_kv, kv_mask, w, num_heads, use_offset, attn_dtype, act_scales,
            quant_attention=quant_attention,
        )
    batch, n, dim = x_q.shape
    m = x_kv.shape[1]
    device = x_q.device
    kernels.require(x_q.is_cuda and x_kv.device == device, "x_q and x_kv must share a CUDA device")
    kernels.require(
        x_q.dtype == x_kv.dtype and x_q.dtype in (torch.float32, torch.bfloat16),
        f"x_q and x_kv must both be f32 or bf16, got {x_q.dtype}/{x_kv.dtype}",
    )
    kernels.require(attn_dtype == torch.bfloat16, "the kernel's attention runs in bf16 or int8")
    kernels.require(x_kv.shape[0] == batch and x_kv.shape[2] == dim, "x_kv shape")
    kernels.require_heads(dim, num_heads)
    kernels.require(dim in WIDTHS, f"the int8 layer kernel takes D = 128 or 256, got D={dim}")
    kernels.require(m >= 1, "empty key set")
    kernels.require(x_q.is_contiguous() and x_kv.is_contiguous(), "x_q and x_kv must be contiguous")
    mats = (w.wq, w.wk, w.wv, w.wo, w.w1, w.w2)
    vecs = (w.sq, w.bq, w.sk, w.bk, w.sv, w.bv, w.so, w.bo, w.s1, w.b1, w.a1, w.c1, w.s2, w.b2)
    shapes = [(dim, dim)] * 4 + [(2 * dim, 2 * dim), (dim, 2 * dim)]
    for t, shape in zip(mats, shapes):
        kernels.require(t.shape == shape and t.dtype == torch.int8, f"weight {tuple(t.shape)} {t.dtype}")
    for t, size in zip(vecs, (dim,) * 8 + (2 * dim,) * 4 + (dim,) * 2):
        kernels.require(t.shape == (size,) and t.dtype == torch.float32, "scale/bias/affine vectors")
    for t in (*mats, *vecs):
        kernels.require(t.device == device and t.is_contiguous(), "weights: device/contiguity")
    for t in (x_q, x_kv, *mats, *vecs):  # TMA tiles and 16-byte loads
        kernels.require(t.data_ptr() % 16 == 0, "x and the weights must be 16-byte aligned")
    if kv_mask is not None:
        kernels.require(kv_mask.shape == (batch, m) and kv_mask.dtype == torch.bool, "kv_mask")
        kernels.require(kv_mask.device == device, "kv_mask device")
    if torch.is_grad_enabled():
        kernels.require(
            not (x_q.requires_grad or x_kv.requires_grad),
            "the int8 layer kernel is forward only (run under torch.no_grad())",
        )
    scales = None
    if act_scales is not None:
        kernels.require(act_scales.dim() == 1 and act_scales.shape[0] >= SITES, "act_scales: [5] or [8]")
        scales = act_scales.detach().to(device=device, dtype=torch.float32).contiguous()
    shape_args = (int(x_q.dtype == torch.bfloat16), batch, n, m, dim, num_heads, int(quant_attention))
    size = kernels.entry_point(
        "gnn_layer_int8", "og_gnn_layer_int8_workspace", [ctypes.c_int] * 8, ctypes.c_size_t
    )(*shape_args, int(scales is not None))
    workspace = torch.empty(size, dtype=torch.uint8, device=device)
    out = torch.empty_like(x_q)
    mask = None if kv_mask is None else kv_mask.contiguous().view(torch.uint8)
    fn = kernels.entry_point(
        "gnn_layer_int8", "og_gnn_layer_int8",
        [ctypes.c_int] * 8 + [_VOID_P] * 4 + [ctypes.POINTER(_VOID_P)] * 2 + [_VOID_P] * 3,
    )
    status = fn(
        *shape_args, int(use_offset), x_q.data_ptr(), x_kv.data_ptr(),
        None if mask is None else mask.data_ptr(), None if scales is None else scales.data_ptr(),
        (_VOID_P * 6)(*(t.data_ptr() for t in mats)),
        (_VOID_P * 14)(*(t.data_ptr() for t in vecs)),
        workspace.data_ptr(), out.data_ptr(), kernels.stream_handle(device),
    )
    kernels.check(status, "og_gnn_layer_int8")
    counter.add(out)
    return out
