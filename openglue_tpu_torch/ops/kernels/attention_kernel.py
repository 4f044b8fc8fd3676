"""Masked softmax attention on ``[B, H, N, dh]`` with a kernel backward: the
kernel wrappers (``ops/csrc/attention.cu``, ``ops/csrc/attention_backward.cu``),
their plain versions and the autograd Functions.

Port of ``openglue_tpu/ops/pallas/attention_kernel.py``:

* ``masked_softmax_attention`` (``_attention_kernel`` forward, counted by
  ``counter``; ``_attention_bwd_kernel`` backward, ``backward_counter``): the
  attention of the composed multi-head attention module when ``use_pallas``
  is set;
* ``masked_softmax_attention_with_lse`` (``_attention_kernel_lse`` forward,
  counted by ``lse_counter``): the same forward returning the per-row LSE too,
  which the ring schedule (``parallel/ring.py``) runs on every key block. The
  TPU needed a second kernel only for Mosaic's block rule on the LSE output;
  here it is the same CUDA forward with the LSE written. Its backward is the
  backward kernel with the LSE's cotangent ``g_lse`` (the JAX package replays
  ``ops/attention.py::softmax_attention_with_lse`` in XLA there): ``dS = P o
  (dP - rowsum(dP o P) + g_lse)``, and in an element whose keys are all masked
  dq = dk = 0 (XLA differentiates the ``where`` that set the logits to -1e9).

The function is

    out = softmax(q k^T * dh^-0.5 + (1 - mask) * -1e9) v

with the kernels' rounding points, which the plain versions keep:

* forward: logits, exp and the denominator in f32 (the denominator sums the
  unrounded p); p cast to v's type for P.V; the division after P.V; out in q's
  type;
* backward: P recomputed in f32 (masked logits replaced by -1e9); P cast to
  v's type for dV = P^T g; dP = g v^T and dS = P o (dP - rowsum(dP o P)) in
  f32; dS cast to q's type for dQ = dS k * scale and dK = dS^T q * scale; dq,
  dk, dv in their inputs' types.

A key set that is masked entirely gives the uniform average over its M keys,
forward and backward (the -1e9 absorbs every logit in f32). The TPU forward
averages over its 128-padded key axis there; the port does not pad.

The CUDA kernels take heads of width 32 or 64 (``kernels.HEAD_WIDTHS``) and
read every operand through its strides, so the ``[B, L, D]`` projections of
the multi-head attention, seen as ``[B, H, L, dh]`` through a transpose, are
read where they lie. The kernel forward returns ``out`` as such a view of a
``[B, N, H * dh]`` buffer, so that
merging the heads is free. A layout the kernels cannot take raises; nothing
is copied and nothing falls back. There is no shape gate: any N and M run.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from openglue_tpu_torch.ops import kernels

NEG_INF = -1e9

counter = kernels.LaunchCounter("K9 attention")
backward_counter = kernels.LaunchCounter("K10 attention_backward")
lse_counter = kernels.LaunchCounter("K11 attention_lse")
# the launches of the bf16 forward kernel from every entry (K9, K11 and the
# layer kernels K1, K4, K7, K8), counted by the C code where it launches it
bf16_counter = kernels.LibraryLaunchCounter("attention.cuh", "og_attention_launches", 0)
# the launches of the bf16 backward passes (two per backward: pass A, then
# pass B) from every entry (K10 and K5's bf16 attention), counted by the C code
bf16_backward_counter = kernels.LibraryLaunchCounter("attention_backward.cuh", "og_attention_backward_launches", 0)

_VOID_P = ctypes.c_void_p


def _masked_logits(q: torch.Tensor, k: torch.Tensor, kv_mask: Optional[torch.Tensor], additive: bool):
    """f32 scaled logits [B, H, N, M] from operands in their own type."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
    if kv_mask is None:
        return logits
    if additive:  # the forward kernel's mask
        return logits + ((1.0 - kv_mask.float()) * NEG_INF)[:, None, None, :]
    return torch.where(kv_mask[:, None, None, :], logits, logits.new_tensor(NEG_INF))


def attention_forward_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_mask: Optional[torch.Tensor] = None,
    want_lse: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The plain version of the forward kernel: q [B, H, N, dh], k/v
    [B, H, M, dh], kv_mask [B, M] bool or None -> (out [B, H, N, dh] in q's
    type, lse [B, H, N] f32 or, without ``want_lse``, None)."""
    logits = _masked_logits(q, k, kv_mask, additive=True)
    row_max = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - row_max)
    denom = p.sum(dim=-1, keepdim=True)
    out = (torch.matmul(p.to(v.dtype).float(), v.float()) / denom).to(q.dtype)
    return out, (row_max + torch.log(denom))[..., 0] if want_lse else None


def attention_backward_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_mask: Optional[torch.Tensor],
    g: torch.Tensor, out: Optional[torch.Tensor] = None, lse: Optional[torch.Tensor] = None,
    g_lse: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of the backward kernel, written out as the TPU
    kernel computes it: g is the cotangent of out -> (dq, dk, dv) in the
    types of q, k, v. It recomputes the softmax and takes neither ``out`` nor
    ``lse`` (the kernel's shortcuts). ``g_lse`` [B, H, N] f32, the cotangent
    of the LSE, adds to dS as P o g_lse, and an element whose keys are all
    masked then takes dS = 0 (the backward of ``masked_softmax_attention_with_lse``)."""
    scale = q.shape[-1] ** -0.5
    p = torch.softmax(_masked_logits(q, k, kv_mask, additive=False), dim=-1)
    g32 = g.to(q.dtype).float()
    dv = torch.matmul(p.to(v.dtype).float().transpose(-1, -2), g32)
    dp = torch.matmul(g32, v.float().transpose(-1, -2))
    row = (dp * p).sum(dim=-1, keepdim=True)
    if g_lse is not None:
        row = row - g_lse.float()[..., None]
    ds = p * (dp - row)
    if g_lse is not None and kv_mask is not None:
        ds = ds * kv_mask.any(dim=1).to(ds.dtype)[:, None, None, None]
    ds = ds.to(q.dtype).float()
    dq = torch.matmul(ds, k.float()) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _head_strides(t: torch.Tensor, name: str):
    """(batch, head, row) strides of a [B, H, L, dh] view the kernels can
    read: the last axis contiguous, every other stride and the address a
    multiple of 16 bytes."""
    unit = 16 // t.element_size()
    kernels.require(
        t.stride(3) == 1,
        f"{name}: the kernel reads heads whose last axis is contiguous, got strides {t.stride()}",
    )
    kernels.require(
        all(s % unit == 0 for s in t.stride()[:3]) and t.data_ptr() % 16 == 0,
        f"{name}: strides {t.stride()} and the address must be multiples of 16 bytes",
    )
    return t.stride()[:3]


def _check_inputs(q, k, v, kv_mask):
    kernels.require(q.dim() == 4 and k.dim() == 4 and v.dim() == 4, "q, k, v must be [B, H, L, dh]")
    batch, heads, n, dh = q.shape
    m = k.shape[2]
    kernels.require_head_width(dh)
    kernels.require(k.shape == (batch, heads, m, dh) and v.shape == k.shape, "k, v must be [B, H, M, dh]")
    kernels.require(n >= 1 and m >= 1, "empty query or key set")
    kernels.require(q.dtype in (torch.float32, torch.bfloat16), f"operand type {q.dtype}")
    kernels.require(q.dtype == k.dtype == v.dtype, f"q, k, v types differ: {q.dtype}/{k.dtype}/{v.dtype}")
    kernels.require(q.is_cuda and k.device == q.device and v.device == q.device, "q, k, v must share a CUDA device")
    if kv_mask is not None:
        kernels.require(kv_mask.shape == (batch, m) and kv_mask.dtype == torch.bool, "kv_mask must be [B, M] bool")
        kernels.require(kv_mask.device == q.device, "kv_mask device")


def _split_view(buffer: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, L, H * dh] -> its [B, H, L, dh] view."""
    batch, length, width = buffer.shape
    return buffer.view(batch, length, heads, width // heads).transpose(1, 2)


def attention_forward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_mask: Optional[torch.Tensor] = None,
    want_lse: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(out, lse) of the attention: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors. ``lse`` is None unless ``want_lse``."""
    if q.device.type == "cpu":
        return attention_forward_plain(q, k, v, kv_mask, want_lse)
    result = _launch_forward(q, k, v, kv_mask, want_lse)
    counter.add(*result)
    return result


def attention_lse_forward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) of one key block of the ring schedule: the CUDA forward with
    the LSE written for CUDA tensors (counted by ``lse_counter``), the plain
    version for CPU tensors."""
    if q.device.type == "cpu":
        return attention_forward_plain(q, k, v, kv_mask, True)
    result = _launch_forward(q, k, v, kv_mask, True)
    lse_counter.add(*result)
    return result


def _launch_forward(q, k, v, kv_mask, want_lse):
    _check_inputs(q, k, v, kv_mask)
    batch, heads, n, dh = q.shape
    m = k.shape[2]
    device = q.device
    out = _split_view(torch.empty(batch, n, heads * dh, dtype=q.dtype, device=device), heads)
    lse = torch.empty(batch, heads, n, dtype=torch.float32, device=device) if want_lse else None
    strides = [*_head_strides(q, "q"), *_head_strides(k, "k"), *_head_strides(v, "v"),
               *_head_strides(out, "out")]
    mask = None if kv_mask is None else kv_mask.contiguous().view(torch.uint8)
    fn = kernels.entry_point(
        "attention", "og_attention",
        [ctypes.c_int] * 6 + [_VOID_P] * 6 + [ctypes.POINTER(ctypes.c_longlong), _VOID_P],
    )
    status = fn(
        int(q.dtype == torch.bfloat16), batch, heads, n, m, dh, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if mask is None else mask.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), (ctypes.c_longlong * 12)(*strides),
        kernels.stream_handle(device),
    )
    kernels.check(status, "og_attention")
    return out, lse


def attention_backward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_mask: Optional[torch.Tensor],
    g: torch.Tensor, out: torch.Tensor, lse: torch.Tensor, g_lse: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) from the cotangent g of ``out`` (and ``g_lse`` of the LSE,
    for the LSE-emitting forward) and the forward's ``out`` and ``lse``: the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return attention_backward_plain(q, k, v, kv_mask, g, out, lse, g_lse)
    _check_inputs(q, k, v, kv_mask)
    batch, heads, n, dh = q.shape
    m = k.shape[2]
    device = q.device
    kernels.require(g.shape == q.shape and out.shape == q.shape, "g and out must have q's shape")
    kernels.require(out.dtype == q.dtype and out.device == device, "out must have q's type and device")
    kernels.require(
        lse.shape == (batch, heads, n) and lse.dtype == torch.float32 and lse.device == device,
        "lse must be [B, H, N] f32",
    )
    g = g.to(q.dtype)
    if g.stride(3) != 1 or any(s % (16 // g.element_size()) for s in g.stride()[:3]):
        g = g.contiguous()  # a cotangent autograd broadcast or sliced
    lse = lse.contiguous()
    if g_lse is not None:
        kernels.require(
            g_lse.shape == lse.shape and g_lse.device == device, "g_lse must be [B, H, N]"
        )
        g_lse = g_lse.float().contiguous()
    dq = _split_view(torch.empty(batch, n, heads * dh, dtype=q.dtype, device=device), heads)
    dk = _split_view(torch.empty(batch, m, heads * dh, dtype=q.dtype, device=device), heads)
    dv = _split_view(torch.empty(batch, m, heads * dh, dtype=q.dtype, device=device), heads)
    row_sums = torch.empty(batch, heads, n, dtype=torch.float32, device=device)
    strides = [
        *_head_strides(q, "q"), *_head_strides(k, "k"), *_head_strides(v, "v"), *_head_strides(g, "g"),
        *_head_strides(out, "out"), *_head_strides(dq, "dq"), *_head_strides(dk, "dk"),
    ]
    mask = dead = None
    if kv_mask is not None:
        mask = kv_mask.contiguous().view(torch.uint8)
        dead = (~kv_mask.any(dim=1)).view(torch.uint8)  # elements with no valid key
    fn = kernels.entry_point(
        "attention_backward", "og_attention_backward",
        [ctypes.c_int] * 6 + [ctypes.POINTER(_VOID_P)] + [_VOID_P] * 5
        + [ctypes.POINTER(_VOID_P), ctypes.POINTER(ctypes.c_longlong), _VOID_P],
    )
    status = fn(
        int(q.dtype == torch.bfloat16), batch, heads, n, m, dh,
        (_VOID_P * 5)(*(t.data_ptr() for t in (q, k, v, g, out))),
        None if mask is None else mask.data_ptr(), None if dead is None else dead.data_ptr(),
        lse.data_ptr(), None if g_lse is None else g_lse.data_ptr(), row_sums.data_ptr(),
        (_VOID_P * 3)(dq.data_ptr(), dk.data_ptr(), dv.data_ptr()),
        (ctypes.c_longlong * 21)(*strides), kernels.stream_handle(device),
    )
    kernels.check(status, "og_attention_backward")
    backward_counter.add(dq, dk, dv)
    return dq, dk, dv


class _MaskedSoftmaxAttention(torch.autograd.Function):
    """out = attention(q, k, v); the forward saves q, k, v, the mask, out and
    the LSE, and the backward runs the backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask):
        needs_grad = any(ctx.needs_input_grad[:3])
        out, lse = attention_forward(q, k, v, kv_mask, want_lse=needs_grad)
        if needs_grad:
            ctx.save_for_backward(q, k, v, kv_mask, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        dq, dk, dv = attention_backward(q, k, v, kv_mask, g, out, lse)
        return dq, dk, dv, None


def masked_softmax_attention(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    kv_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Softmax attention, differentiable in query, key and value: query
    [B, H, N, dh], key/value [B, H, M, dh], kv_mask [B, M] bool or None ->
    out [B, H, N, dh] in query's type. The kernels for CUDA tensors (dh = 32 or 64),
    the plain versions for CPU tensors."""
    return _MaskedSoftmaxAttention.apply(query, key, value, kv_mask)


class _MaskedSoftmaxAttentionWithLse(torch.autograd.Function):
    """(out, lse) = attention(q, k, v) with the LSE; the backward takes the
    cotangents of both (autograd gives zeros for an unused one) and runs the
    backward kernel with ``g_lse``."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask):
        out, lse = attention_lse_forward(q, k, v, kv_mask)
        if any(ctx.needs_input_grad[:3]):
            ctx.save_for_backward(q, k, v, kv_mask, out, lse)
        return out, lse

    @staticmethod
    def backward(ctx, g, g_lse):
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        dq, dk, dv = attention_backward(q, k, v, kv_mask, g, out, lse, g_lse)
        return dq, dk, dv, None


def masked_softmax_attention_with_lse(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    kv_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax attention and the per-row LSE of its scaled, masked logits,
    differentiable in query, key and value through both outputs: query
    [B, H, N, dh], key/value [B, H, M, dh], kv_mask [B, M] bool or None ->
    (out [B, H, N, dh] in query's type, lse [B, H, N] f32). The kernels for
    CUDA tensors (dh = 32 or 64), the plain versions for CPU tensors."""
    return _MaskedSoftmaxAttentionWithLse.apply(query, key, value, kv_mask)
