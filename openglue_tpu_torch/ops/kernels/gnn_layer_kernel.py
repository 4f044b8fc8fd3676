"""One eval-mode attentional-propagation layer (softmax attention): the kernel
wrapper (``ops/csrc/gnn_layer.cu``), its plain version and the weight fold.

Port of ``openglue_tpu/ops/pallas/gnn_layer_kernel.py`` (softmax kind of
``_layer_kernel`` via ``fused_attention_propagation``). The layer is
``x_q + FFN([x_q, MHA(x_q, x_kv)])`` with the FFN's eval BatchNorm folded into
a per-channel affine. The plain version keeps the kernel's rounding points:

* q, k and v are cast to the compute type after the bias;
* logits = (q . k) in f32, then * dh^-0.5, then + the additive mask
  ``(1 - mask) * -1e9`` (finite: a fully masked key set averages uniformly);
* exp in f32, the denominator summed from f32 p, P cast to the compute type
  for P.V, the division after P.V;
* attn, then msg, cast to the compute type;
* h1 = ReLU in f32, then the BN affine, then a cast;
* out = (x_q in f32 + update) cast to x_q's type.

Forward only: the wrapper raises when a gradient is required.
"""

from __future__ import annotations

import ctypes
from typing import Mapping, NamedTuple, Optional

import torch

from openglue_tpu_torch.ops import kernels

NEG_INF = -1e9

counter = kernels.LaunchCounter()


class PropagationWeights(NamedTuple):
    """Weights of one layer. Matrices are torch layout ``[out, in]`` in the
    compute type; biases and the folded BatchNorm affine (a1, c1) are f32
    vectors."""

    wq: torch.Tensor
    bq: torch.Tensor
    wk: torch.Tensor
    bk: torch.Tensor
    wv: torch.Tensor
    bv: torch.Tensor
    wo: torch.Tensor
    bo: torch.Tensor
    w1: torch.Tensor
    b1: torch.Tensor
    a1: torch.Tensor
    c1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor


def fold_propagation_weights(
    state: Mapping[str, torch.Tensor],
    compute_dtype: torch.dtype,
    bn_epsilon: float = 1e-5,
) -> PropagationWeights:
    """PropagationWeights from one layer's state dict (reference key names:
    ``mha.in_proj_{q,k,v}``, ``mha.out_proj``, ``fc.0`` dense, ``fc.2``
    BatchNorm, ``fc.3`` dense; 1x1-conv weights ``[out, in, 1]``), folding the
    eval BatchNorm into a1 = scale / sqrt(var + eps), c1 = bias - mean * a1."""

    def dense(name):
        w = state[f"{name}.weight"]
        w = w[..., 0] if w.dim() == 3 else w
        return w.to(compute_dtype).contiguous(), state[f"{name}.bias"].float().contiguous()

    wq, bq = dense("mha.in_proj_q")
    wk, bk = dense("mha.in_proj_k")
    wv, bv = dense("mha.in_proj_v")
    wo, bo = dense("mha.out_proj")
    w1, b1 = dense("fc.0")
    w2, b2 = dense("fc.3")
    a1 = state["fc.2.weight"].float() * torch.rsqrt(state["fc.2.running_var"].float() + bn_epsilon)
    c1 = state["fc.2.bias"].float() - state["fc.2.running_mean"].float() * a1
    return PropagationWeights(
        wq, bq, wk, bk, wv, bv, wo, bo, w1, b1, a1.contiguous(), c1.contiguous(), w2, b2
    )


def _dense_f32(x: torch.Tensor, kern: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """x . kern^T + bias with compute-type operands and f32 accumulation."""
    return torch.matmul(x.float(), kern.float().t()) + bias


def layer_plain(
    x_q: torch.Tensor,
    x_kv: torch.Tensor,
    kv_mask: Optional[torch.Tensor],
    w: PropagationWeights,
    num_heads: int,
    use_offset: bool = False,
) -> torch.Tensor:
    """The plain version of the kernel: x_q [B, N, D], x_kv [B, M, D],
    kv_mask [B, M] bool or None -> [B, N, D] in x_q's type."""
    dtype = w.wq.dtype
    batch, n, dim = x_q.shape
    m = x_kv.shape[1]
    dh = dim // num_heads
    xq_c = x_q.to(dtype)
    xkv_c = x_kv.to(dtype)
    q = _dense_f32(xq_c, w.wq, w.bq).to(dtype)
    k = _dense_f32(xkv_c, w.wk, w.bk).to(dtype)
    v = _dense_f32(xkv_c, w.wv, w.bv).to(dtype)

    def split(t, length):  # [B, L, D] -> [B, H, L, dh]
        return t.reshape(batch, length, num_heads, dh).transpose(1, 2)

    if kv_mask is None:
        mask_add = torch.zeros(batch, m, dtype=torch.float32, device=x_q.device)
    else:
        mask_add = (1.0 - kv_mask.float()) * NEG_INF
    logits = torch.matmul(split(q, n).float(), split(k, m).float().transpose(-1, -2))
    logits = logits * dh**-0.5 + mask_add[:, None, None, :]
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    denom = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(dtype).float(), split(v, m).float()) / denom
    attn = o.transpose(1, 2).reshape(batch, n, dim).to(dtype)

    msg = _dense_f32(attn, w.wo, w.bo).to(dtype)
    cat = torch.cat([xq_c - msg if use_offset else xq_c, msg], dim=-1)
    h1 = torch.relu(_dense_f32(cat, w.w1, w.b1))
    h1 = (h1 * w.a1 + w.c1).to(dtype)
    upd = _dense_f32(h1, w.w2, w.b2)
    return (x_q.float() + upd).to(x_q.dtype)


_VOID_P = ctypes.c_void_p


def fused_attention_propagation(
    x_q: torch.Tensor,
    x_kv: torch.Tensor,
    kv_mask: Optional[torch.Tensor],
    w: PropagationWeights,
    num_heads: int,
    use_offset: bool = False,
) -> torch.Tensor:
    """One eval layer: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. x_q [B, N, D], x_kv [B, M, D], kv_mask [B, M] bool or None."""
    if x_q.device.type == "cpu":
        return layer_plain(x_q, x_kv, kv_mask, w, num_heads, use_offset)
    batch, n, dim = x_q.shape
    m = x_kv.shape[1]
    dtype = w.wq.dtype
    device = x_q.device
    kernels.require(x_q.is_cuda and x_kv.device == device, "x_q and x_kv must share a CUDA device")
    kernels.require(dtype in (torch.float32, torch.bfloat16), f"compute type {dtype}")
    kernels.require(
        x_q.dtype == x_kv.dtype == dtype,
        f"the kernel takes x in its compute type {dtype}, got {x_q.dtype}/{x_kv.dtype}",
    )
    kernels.require(x_kv.shape[0] == batch and x_kv.shape[2] == dim, "x_kv shape")
    kernels.require(dim == 64 * num_heads, "the kernel takes heads of width 64")
    kernels.require(m >= 1, "empty key set")
    kernels.require(x_q.is_contiguous() and x_kv.is_contiguous(), "x_q and x_kv must be contiguous")
    mats = (w.wq, w.wk, w.wv, w.wo, w.w1, w.w2)
    vecs = (w.bq, w.bk, w.bv, w.bo, w.b1, w.a1, w.c1, w.b2)
    shapes = [(dim, dim)] * 4 + [(2 * dim, 2 * dim), (dim, 2 * dim)]
    for t, shape in zip(mats, shapes):
        kernels.require(t.shape == shape and t.dtype == dtype, f"weight {tuple(t.shape)} {t.dtype}")
    for t in (*mats, *vecs):
        kernels.require(t.device == device and t.is_contiguous(), "weights: device/contiguity")
    for t, size in zip(vecs, (dim,) * 4 + (2 * dim,) * 3 + (dim,)):
        kernels.require(t.shape == (size,) and t.dtype == torch.float32, "bias/affine vectors")
    if kv_mask is not None:
        kernels.require(kv_mask.shape == (batch, m) and kv_mask.dtype == torch.bool, "kv_mask")
        kernels.require(kv_mask.device == device, "kv_mask device")
    if torch.is_grad_enabled():
        kernels.require(
            not any(t.requires_grad for t in (x_q, x_kv, *mats, *vecs)),
            "the layer kernel is forward only (run under torch.no_grad())",
        )
    workspace = torch.empty(batch * (6 * n + 2 * m) * dim, dtype=dtype, device=device)
    out = torch.empty(batch, n, dim, dtype=dtype, device=device)
    mask = None if kv_mask is None else kv_mask.contiguous().view(torch.uint8)
    fn = kernels.entry_point(
        "gnn_layer", "og_gnn_layer",
        [ctypes.c_int] * 7 + [_VOID_P] * 3 + [ctypes.POINTER(_VOID_P)] * 2 + [_VOID_P] * 3,
    )
    status = fn(
        int(dtype == torch.bfloat16), batch, n, m, dim, num_heads, int(use_offset),
        x_q.data_ptr(), x_kv.data_ptr(), None if mask is None else mask.data_ptr(),
        (_VOID_P * 6)(*(t.data_ptr() for t in mats)),
        (_VOID_P * 8)(*(t.data_ptr() for t in vecs)),
        workspace.data_ptr(), out.data_ptr(), kernels.stream_handle(device),
    )
    kernels.check(status, "og_gnn_layer")
    counter.add()
    return out
