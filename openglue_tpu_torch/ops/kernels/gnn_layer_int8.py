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

counter = kernels.LaunchCounter()


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
        "gnn_layer_int8", "og_gnn_layer_int8_workspace", [ctypes.c_int] * 7, ctypes.c_size_t
    )(*shape_args)
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
    counter.add()
    return out
