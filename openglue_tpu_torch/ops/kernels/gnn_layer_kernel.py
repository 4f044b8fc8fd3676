"""One eval-mode attentional-propagation layer, for every attention kind: the
kernel wrappers (``ops/csrc/gnn_layer.cu`` for softmax attention,
``ops/csrc/gnn_layer_features.cu`` for the O(N) kinds ``linear``,
``favor_relu`` and ``favor_softmax``), their plain version and the weight
fold.

Port of ``openglue_tpu/ops/pallas/gnn_layer_kernel.py`` (``_layer_kernel`` via
``fused_attention_propagation``). The layer is
``x_q + FFN([x_q, MHA(x_q, x_kv)])`` with the FFN's eval BatchNorm folded into
a per-channel affine. The plain version keeps the kernel's rounding points:

* q and v are cast to the compute type after the bias; so is k for softmax
  attention, while the feature kinds keep k in f32 into the feature map;
* softmax: logits = (q . k) in f32, then * dh^-0.5, then + the additive mask
  ``(1 - mask) * -1e9`` (finite: a fully masked key set averages uniformly);
  exp in f32, the denominator summed from f32 p, P cast to the compute type
  for P.V, the division after P.V;
* feature kinds: the feature map in f32 (the FAVOR projection with operands
  in the compute type); masked key rows multiplied by 0; the aggregate
  ``kf^T . v`` with kf cast to the compute type and kept in f32, the
  normalizer from the f32 kf; ``o = qf(compute type) . KV`` against the f32
  aggregate, ``norm = sum qf * ksum`` in f32, ``o / norm``. A fully masked key
  set leaves aggregate and normalizer 0, so its rows are NaN (0 / 0), as in
  the JAX kernel;
* attn, then msg, cast to the compute type;
* h1 = ReLU in f32, then the BN affine, then a cast;
* out = (x_q in f32 + update) cast to x_q's type.

Forward only: the wrapper raises when a gradient is required. The feature
kernel's launch plan (CTAs per (element, head), key and query runs, shared
memory) is mirrored here by ``feature_plan``, which the CPU tests hold at
every shape the wrapper takes and the card tests hold against the C plan.

The training path runs the attention half alone, with a gradient
(``fused_attention_message``, port of the JAX function of that name :1189):
the forward kernel ``ops/csrc/message_forward.cu`` (replacing
``_message_kernel`` :557) returns msg, attn and the per-row LSE, and the
backward kernel ``ops/csrc/message_backward.cu`` (replacing
``_message_bwd_kernel`` :627) returns the gradients of x_q, x_kv and the
eight weights from them. The FFN and its train-mode BatchNorm stay in torch
autograd.

A second training route runs the attention half and the FFN's first dense +
ReLU as one kernel (``fused_train_layer_half``, port of the JAX function of
that name :1076): the forward kernel ``ops/csrc/train_half.cu`` (replacing
``_train_half_kernel`` :587) returns z, the hidden before the BatchNorm, with
attn and the LSE; the backward peels dense + ReLU off the cotangent in torch
and ends in the message backward kernel.
"""

from __future__ import annotations

import ctypes
from typing import Mapping, NamedTuple, Optional

import torch

from openglue_tpu_torch.ops import kernels

NEG_INF = -1e9
ELU_EPS = 1e-6
FAVOR_EPS = 1e-8
FEATURE_KINDS = ("linear", "favor_relu", "favor_softmax")
ATTENTION_KINDS = ("softmax",) + FEATURE_KINDS
MAX_FEATURES = 256  # the widest feature map the feature kernel takes
# the feature kernel's attention part (ops/csrc/gnn_layer_features.cu)
FEATURE_WARPS = 8  # warps of a CTA
KEY_CHUNK = 64  # keys a CTA stages at a time
MAX_CLUSTER_CTAS = 8  # CTAs per (element, head): a portable cluster
SMEM_CAP = 232448  # the shared memory one block may opt into on the H100
H100_SMS = 132

counter = kernels.LaunchCounter("K1 gnn_layer")
feature_counter = kernels.LaunchCounter("K6 gnn_layer_features")
message_counter = kernels.LaunchCounter("K4 message_forward")
message_bwd_counter = kernels.LaunchCounter("K5 message_backward")
half_counter = kernels.LaunchCounter("K8 train_half")


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


def _mask_add(kv_mask: Optional[torch.Tensor], batch: int, m: int, device) -> torch.Tensor:
    if kv_mask is None:
        return torch.zeros(batch, m, dtype=torch.float32, device=device)
    return (1.0 - kv_mask.float()) * NEG_INF


def _features(xh, kind, projection, dtype, is_query, mask_add=None):
    """The per-head feature map [B, H, L, dh] f32 -> [B, H, L, F] f32."""
    if kind == "linear":
        return torch.where(xh > 0, xh + 1.0, torch.exp(torch.clamp(xh, max=0.0))) + ELU_EPS
    dh = xh.shape[-1]
    data_norm = dh**-0.25
    ph = torch.matmul((xh * data_norm).to(dtype).float(), projection.to(dtype).float().t())
    if kind == "favor_relu":
        return torch.relu(ph) + FAVOR_EPS
    diag = 0.5 * torch.square(xh * data_norm).sum(dim=-1, keepdim=True)
    if is_query:
        stab = ph.amax(dim=-1, keepdim=True)
    else:  # one max per (element, head) over valid keys x features
        stab = (ph + mask_add[:, None, :, None]).amax(dim=(-1, -2), keepdim=True)
    return projection.shape[0] ** -0.5 * (torch.exp(ph - diag - stab) + FAVOR_EPS)


def layer_plain(
    x_q: torch.Tensor,
    x_kv: torch.Tensor,
    kv_mask: Optional[torch.Tensor],
    w: PropagationWeights,
    num_heads: int,
    use_offset: bool = False,
    attention_kind: str = "softmax",
    projection: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The plain version of the kernels: x_q [B, N, D], x_kv [B, M, D],
    kv_mask [B, M] bool or None, projection [F, dh] f32 for the FAVOR kinds
    -> [B, N, D] in x_q's type."""
    dtype = w.wq.dtype
    batch, n, dim = x_q.shape
    m = x_kv.shape[1]
    dh = dim // num_heads
    xq_c = x_q.to(dtype)
    xkv_c = x_kv.to(dtype)
    q = _dense_f32(xq_c, w.wq, w.bq).to(dtype)
    k = _dense_f32(xkv_c, w.wk, w.bk)
    v = _dense_f32(xkv_c, w.wv, w.bv).to(dtype)

    def split(t, length):  # [B, L, D] -> [B, H, L, dh]
        return t.reshape(batch, length, num_heads, dh).transpose(1, 2)

    mask_add = _mask_add(kv_mask, batch, m, x_q.device)
    if attention_kind == "softmax":
        logits = torch.matmul(split(q, n).float(), split(k.to(dtype), m).float().transpose(-1, -2))
        logits = logits * dh**-0.5 + mask_add[:, None, None, :]
        p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
        denom = p.sum(dim=-1, keepdim=True)
        o = torch.matmul(p.to(dtype).float(), split(v, m).float()) / denom
    else:
        valid = torch.ones(batch, m, device=x_q.device) if kv_mask is None else kv_mask.float()
        kf = _features(split(k, m), attention_kind, projection, dtype, False, mask_add)
        kf = kf * valid[:, None, :, None]
        kv_agg = torch.matmul(kf.to(dtype).float().transpose(-1, -2), split(v, m).float())
        key_sum = kf.sum(dim=2)
        qf = _features(split(q, n).float(), attention_kind, projection, dtype, True)
        o = torch.matmul(qf.to(dtype).float(), kv_agg)
        o = o / (qf * key_sum[:, :, None, :]).sum(dim=-1, keepdim=True)
    attn = o.transpose(1, 2).reshape(batch, n, dim).to(dtype)

    msg = _dense_f32(attn, w.wo, w.bo).to(dtype)
    cat = torch.cat([xq_c - msg if use_offset else xq_c, msg], dim=-1)
    h1 = torch.relu(_dense_f32(cat, w.w1, w.b1))
    h1 = (h1 * w.a1 + w.c1).to(dtype)
    upd = _dense_f32(h1, w.w2, w.b2)
    return (x_q.float() + upd).to(x_q.dtype)


_VOID_P = ctypes.c_void_p


class FeaturePlan(NamedTuple):
    """How the feature kernel's attention part spreads over the card:
    ``cluster`` CTAs per (element, head), ``key_groups`` warps per feature
    tile of 16 (each takes every key_groups-th 16-key group of a chunk),
    ``tiles_per_warp`` feature tiles per warp, 64-key chunks and query tiles
    (``query_rows``) per CTA, whether FAVOR-softmax keeps its keys resident
    between its two sweeps, and a CTA's shared memory."""

    cluster: int
    key_groups: int
    tiles_per_warp: int
    chunks_per_cta: int
    query_tiles_per_cta: int
    resident: int
    smem_bytes: int


def _align16(x: int) -> int:
    return (x + 15) // 16 * 16


def query_rows(is_bf16) -> int:
    """Rows of the query tile a warp of the feature kernel takes at once."""
    return 32 if is_bf16 else 16


def feature_smem_bytes(num_features, head_dim, is_bf16, kind, key_groups, tiles_per_warp, chunks, resident) -> int:
    """A CTA's shared memory (mirror of ``make_layout``): T(proj) for FAVOR,
    ksum, the CTAs' maxes, the mask weight of each of the CTA's ``chunks``
    64-key chunks; the stage of 64-key chunks (rings of raw f32 keys
    and of v, three v buffers in bf16 and two in f32, one raw buffer fewer
    for FAVOR; T(k dh^-1/4) for FAVOR; diag), whose room later holds the key groups' partial KV + ksum and then
    each warp's two query tiles; the resident keys of FAVOR-softmax
    (T(k dh^-1/4) and diag of every chunk); then the query side's KV
    (bf16 hi + lo planes, or f32), whose room first holds the raw projection
    and, with two feature tiles per warp, the second tile's stage."""
    esz, ld = (2, head_dim + 8) if is_bf16 else (4, head_dim + 4)
    e4 = (num_features * head_dim + num_features) // 4
    head = (0 if kind == "linear" else _align16(num_features * ld * esz)) + _align16(num_features * 4) + 64
    head += chunks * KEY_CHUNK * 4
    raw_bytes, v_bytes = KEY_CHUNK * (head_dim + 4) * 4, KEY_CHUNK * ld * esz
    stages = 3 if is_bf16 else 2
    stage = (stages if kind == "linear" else stages - 1) * raw_bytes + (0 if kind == "linear" else v_bytes)
    stage += stages * v_bytes + KEY_CHUNK * 4
    queries = FEATURE_WARPS * 2 * query_rows(is_bf16) * ld * esz
    part = key_groups * e4 * 16
    keys = chunks * KEY_CHUNK * (ld * esz + 4) if resident else 0
    room = max(2 * num_features * ld * 2 if is_bf16 else num_features * ld * 4, num_features * head_dim * 4)
    if tiles_per_warp == 2:
        room = max(room, stage)
    return head + max(stage, queries, part) + keys + room


def feature_plan(batch, heads, n, m, num_features, head_dim, is_bf16, kind, sms=H100_SMS) -> FeaturePlan:
    """The plan of ``make_feature_plan`` in ``gnn_layer_features.cu``: the
    largest power of two C <= 8 of CTAs per (element, head) that keeps at
    most one CTA per SM, and no more CTAs than 64-key chunks or 64-query
    runs; FAVOR-softmax keeps its keys resident where they fit."""
    tiles = num_features // 16
    key_groups = 1 if tiles >= FEATURE_WARPS else min(4, FEATURE_WARPS // tiles)
    tiles_per_warp = 2 if tiles > FEATURE_WARPS else 1
    cluster = 1
    while cluster < MAX_CLUSTER_CTAS and 2 * batch * heads * cluster <= sms and cluster * KEY_CHUNK < max(m, n):
        cluster *= 2
    chunks_per_cta = -(-(-(-m // KEY_CHUNK)) // cluster)
    query_tiles_per_cta = -(-(-(-n // query_rows(is_bf16))) // cluster)
    args = (num_features, head_dim, is_bf16, kind, key_groups, tiles_per_warp, chunks_per_cta)
    smem, resident = feature_smem_bytes(*args, False), 0
    if kind == "favor_softmax" and feature_smem_bytes(*args, True) <= SMEM_CAP:
        smem, resident = feature_smem_bytes(*args, True), 1
    return FeaturePlan(cluster, key_groups, tiles_per_warp, chunks_per_cta, query_tiles_per_cta, resident, smem)


def kernel_feature_plan(batch, heads, n, m, num_features, head_dim, is_bf16, kind):
    """(FeaturePlan, SM count) as the C code computes it on the current card
    (``og_gnn_layer_features_plan``; builds the kernels on first use)."""
    fn = kernels.entry_point(
        "gnn_layer_features", "og_gnn_layer_features_plan", [ctypes.c_int] * 8 + [ctypes.POINTER(ctypes.c_int)]
    )
    out = (ctypes.c_int * 8)()
    status = fn(int(is_bf16), batch, n, m, heads * head_dim, heads, num_features, FEATURE_KINDS.index(kind), out)
    kernels.check(status, "og_gnn_layer_features_plan")
    return FeaturePlan(*out[:7]), out[7]


def check_layer_args(x_q, x_kv, kv_mask, w: PropagationWeights, num_heads, attention_kind, projection):
    """Raise ValueError unless the layer kernels take these arguments (their
    devices already checked to be one); returns (head_dim, num_features)."""
    batch, n, dim = x_q.shape
    m = x_kv.shape[1]
    dtype = w.wq.dtype
    device = x_q.device
    kernels.require(dtype in (torch.float32, torch.bfloat16), f"compute type {dtype}")
    kernels.require(
        x_q.dtype == x_kv.dtype == dtype,
        f"the kernel takes x in its compute type {dtype}, got {x_q.dtype}/{x_kv.dtype}",
    )
    kernels.require(x_kv.shape[0] == batch and x_kv.shape[2] == dim, "x_kv shape")
    head_dim = kernels.require_heads(dim, num_heads)
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
    num_features = head_dim
    if attention_kind in ("favor_relu", "favor_softmax"):
        kernels.require(
            projection.dim() == 2 and projection.shape[1] == head_dim and projection.device == device,
            f"projection must be [F, {head_dim}] on the inputs' device",
        )
        num_features = projection.shape[0]
        kernels.require(
            num_features % 16 == 0 and 16 <= num_features <= MAX_FEATURES,
            f"the kernel takes a multiple of 16 features up to {MAX_FEATURES}, got {num_features}",
        )
    return head_dim, num_features


def fused_attention_propagation(
    x_q: torch.Tensor,
    x_kv: torch.Tensor,
    kv_mask: Optional[torch.Tensor],
    w: PropagationWeights,
    num_heads: int,
    use_offset: bool = False,
    attention_kind: str = "softmax",
    projection: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One eval layer: a CUDA kernel for CUDA tensors (the softmax kernel or
    the feature-kind kernel), the plain version for CPU tensors. x_q
    [B, N, D], x_kv [B, M, D], kv_mask [B, M] bool or None; ``projection``
    [F, dh] f32 is the FAVOR kinds' orthogonal random matrix, a constant.
    With a feature kind, an element whose keys are all masked comes out NaN
    (see the module docstring)."""
    if attention_kind not in ATTENTION_KINDS:
        raise ValueError(f"unsupported attention_kind {attention_kind!r}")
    favor = attention_kind in ("favor_relu", "favor_softmax")
    if favor and projection is None:
        raise ValueError(f"{attention_kind} needs the FAVOR projection matrix")
    if x_q.device.type == "cpu":
        return layer_plain(x_q, x_kv, kv_mask, w, num_heads, use_offset, attention_kind, projection)
    batch, n, dim = x_q.shape
    m = x_kv.shape[1]
    dtype = w.wq.dtype
    device = x_q.device
    kernels.require(x_q.is_cuda and x_kv.device == device, "x_q and x_kv must share a CUDA device")
    _, num_features = check_layer_args(x_q, x_kv, kv_mask, w, num_heads, attention_kind, projection)
    mats = (w.wq, w.wk, w.wv, w.wo, w.w1, w.w2)
    vecs = (w.bq, w.bk, w.bv, w.bo, w.b1, w.a1, w.c1, w.b2)
    out = torch.empty(batch, n, dim, dtype=dtype, device=device)
    mask = None if kv_mask is None else kv_mask.contiguous().view(torch.uint8)
    mask_ptr = None if mask is None else mask.data_ptr()
    mat_ptrs = (_VOID_P * 6)(*(t.data_ptr() for t in mats))
    vec_ptrs = (_VOID_P * 8)(*(t.data_ptr() for t in vecs))
    is_bf16 = int(dtype == torch.bfloat16)
    if attention_kind == "softmax":
        workspace = torch.empty(batch * (6 * n + 2 * m) * dim, dtype=dtype, device=device)
        fn = kernels.entry_point(
            "gnn_layer", "og_gnn_layer",
            [ctypes.c_int] * 7 + [_VOID_P] * 3 + [ctypes.POINTER(_VOID_P)] * 2 + [_VOID_P] * 3,
        )
        status = fn(
            is_bf16, batch, n, m, dim, num_heads, int(use_offset),
            x_q.data_ptr(), x_kv.data_ptr(), mask_ptr, mat_ptrs, vec_ptrs,
            workspace.data_ptr(), out.data_ptr(), kernels.stream_handle(device),
        )
        kernels.check(status, "og_gnn_layer")
        counter.add(out)
        return out
    proj = projection.detach().float().contiguous() if favor else None
    shape_args = (is_bf16, batch, n, m, dim, num_heads, num_features)
    size = kernels.entry_point(
        "gnn_layer_features", "og_gnn_layer_features_workspace", [ctypes.c_int] * 7, ctypes.c_size_t
    )(*shape_args)
    workspace = torch.empty(size, dtype=torch.uint8, device=device)
    fn = kernels.entry_point(
        "gnn_layer_features", "og_gnn_layer_features",
        [ctypes.c_int] * 9 + [_VOID_P] * 3 + [ctypes.POINTER(_VOID_P)] * 2 + [_VOID_P] * 4,
    )
    status = fn(
        *shape_args, FEATURE_KINDS.index(attention_kind), int(use_offset),
        x_q.data_ptr(), x_kv.data_ptr(), mask_ptr, mat_ptrs, vec_ptrs,
        None if proj is None else proj.data_ptr(),
        workspace.data_ptr(), out.data_ptr(), kernels.stream_handle(device),
    )
    kernels.check(status, "og_gnn_layer_features")
    feature_counter.add(out)
    return out


# ----------------------------------------------------------- attention half


class MessageWeights(NamedTuple):
    """The attention half of a layer: q/k/v/out projections in torch layout
    ``[out, in]`` with ``[out]`` biases, kept in the parameter type (f32) so
    that their gradients come back in f32; the kernels cast them to the
    compute type."""

    wq: torch.Tensor
    bq: torch.Tensor
    wk: torch.Tensor
    bk: torch.Tensor
    wv: torch.Tensor
    bv: torch.Tensor
    wo: torch.Tensor
    bo: torch.Tensor


def extract_message_weights(params: Mapping[str, torch.Tensor]) -> MessageWeights:
    """MessageWeights from one layer's parameters (``mha.in_proj_{q,k,v}``,
    ``mha.out_proj``; 1x1-conv weights ``[out, in, 1]``) as views, so that a
    gradient reaches the parameters."""

    def dense(name):
        w = params[f"mha.{name}.weight"]
        return (w[..., 0] if w.dim() == 3 else w), params[f"mha.{name}.bias"]

    return MessageWeights(
        *dense("in_proj_q"), *dense("in_proj_k"), *dense("in_proj_v"), *dense("out_proj")
    )


def message_forward_plain(
    x_q: torch.Tensor,
    x_kv: torch.Tensor,
    kv_mask: Optional[torch.Tensor],
    w: MessageWeights,
    num_heads: int,
    compute_dtype: torch.dtype,
):
    """The plain version of the forward kernel: x_q [B, N, D], x_kv [B, M, D]
    -> (msg [B, N, D], attn [B, N, D], both in the compute type; lse
    [B, H, N] f32). Rounding points of ``_attention_half_body``: q, k, v cast
    after the bias; logits, exp and the denominator in f32; P cast for P.V,
    the division after it; attn and msg cast."""
    dtype = compute_dtype
    batch, n, dim = x_q.shape
    m = x_kv.shape[1]
    dh = dim // num_heads
    xq_c, xkv_c = x_q.to(dtype), x_kv.to(dtype)
    q = _dense_f32(xq_c, w.wq.to(dtype), w.bq.float()).to(dtype)
    k = _dense_f32(xkv_c, w.wk.to(dtype), w.bk.float()).to(dtype)
    v = _dense_f32(xkv_c, w.wv.to(dtype), w.bv.float()).to(dtype)

    def split(t, length):  # [B, L, D] -> [B, H, L, dh]
        return t.reshape(batch, length, num_heads, dh).transpose(1, 2)

    logits = torch.matmul(split(q, n).float(), split(k, m).float().transpose(-1, -2))
    logits = logits * dh**-0.5 + _mask_add(kv_mask, batch, m, x_q.device)[:, None, None, :]
    row_max = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - row_max)
    denom = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(dtype).float(), split(v, m).float()) / denom
    attn = o.transpose(1, 2).reshape(batch, n, dim).to(dtype)
    msg = _dense_f32(attn, w.wo.to(dtype), w.bo.float()).to(dtype)
    lse = (row_max + torch.log(denom))[..., 0]
    return msg, attn, lse


def message_backward_plain(
    x_q: torch.Tensor,
    x_kv: torch.Tensor,
    kv_mask: Optional[torch.Tensor],
    w: MessageWeights,
    g: torch.Tensor,
    attn: torch.Tensor,
    lse: torch.Tensor,
    num_heads: int,
    compute_dtype: torch.dtype,
):
    """The plain version of the backward kernel: the cotangent g of msg and
    the forward's attn and lse -> (dx_q in x_q's type, dx_kv in x_kv's type,
    MessageWeights of f32 gradients in torch layout). Rounding points of
    ``_message_bwd_kernel``: g cast for dattn = g Wo and dWo = attn^T g, dbo
    from f32 g; P rebuilt in f32 from lse and cast for dV; dP and
    dS = P o (dP - rowsum(dP o P)) in f32, dS cast for dQ and dK; dQ, dK, dV
    cast for dx and dW; the bias gradients from the f32 sums."""
    dtype = compute_dtype
    batch, n, dim = x_q.shape
    m = x_kv.shape[1]
    dh = dim // num_heads
    scale = dh**-0.5
    xq_c, xkv_c = x_q.to(dtype), x_kv.to(dtype)
    wq, wk, wv, wo = (t.to(dtype).float() for t in (w.wq, w.wk, w.wv, w.wo))
    q = (torch.matmul(xq_c.float(), wq.t()) + w.bq.float()).to(dtype)
    k = (torch.matmul(xkv_c.float(), wk.t()) + w.bk.float()).to(dtype)
    v = (torch.matmul(xkv_c.float(), wv.t()) + w.bv.float()).to(dtype)

    def split(t, length):  # [B, L, D] -> [B, H, L, dh]
        return t.reshape(batch, length, num_heads, dh).transpose(1, 2)

    def merge(t, length):  # [B, H, L, dh] -> [B, L, D]
        return t.transpose(1, 2).reshape(batch, length, dim)

    def wgrad(d, x):  # sum over rows of d^T x: torch layout [out, in]
        return torch.einsum("bno,bni->oi", d.float(), x.float())

    gc = g.to(dtype)
    dattn = torch.matmul(gc.float(), wo)
    dbo = g.float().sum(dim=(0, 1))
    dwo = wgrad(gc, attn.to(dtype))

    qh, kh, vh = split(q, n).float(), split(k, m).float(), split(v, m).float()
    logits = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    logits = logits + _mask_add(kv_mask, batch, m, x_q.device)[:, None, None, :]
    p = torch.exp(logits - lse[..., None])
    dah = split(dattn, n).to(dtype).float()
    dv = torch.matmul(p.to(dtype).float().transpose(-1, -2), dah)
    dp = torch.matmul(dah, vh.transpose(-1, -2))
    ds = (p * (dp - (dp * p).sum(dim=-1, keepdim=True))).to(dtype).float()
    dq = merge(torch.matmul(ds, kh) * scale, n)
    dk = merge(torch.matmul(ds.transpose(-1, -2), qh) * scale, m)
    dv = merge(dv, m)

    dqc, dkc, dvc = dq.to(dtype).float(), dk.to(dtype).float(), dv.to(dtype).float()
    dxq = torch.matmul(dqc, wq).to(x_q.dtype)
    dxkv = (torch.matmul(dkc, wk) + torch.matmul(dvc, wv)).to(x_kv.dtype)
    grads = MessageWeights(
        wgrad(dqc, xq_c), dq.sum(dim=(0, 1)), wgrad(dkc, xkv_c), dk.sum(dim=(0, 1)),
        wgrad(dvc, xkv_c), dv.sum(dim=(0, 1)), dwo, dbo,
    )
    return dxq, dxkv, grads


def _check_message_inputs(x_q, x_kv, kv_mask, w: MessageWeights, num_heads, dtype):
    batch, n, dim = x_q.shape
    m = x_kv.shape[1]
    device = x_q.device
    kernels.require(x_q.is_cuda and x_kv.device == device, "x_q and x_kv must share a CUDA device")
    kernels.require(dtype in (torch.float32, torch.bfloat16), f"compute type {dtype}")
    kernels.require(
        x_q.dtype == x_kv.dtype == dtype,
        f"the kernel takes x in its compute type {dtype}, got {x_q.dtype}/{x_kv.dtype}",
    )
    kernels.require(x_kv.shape[0] == batch and x_kv.shape[2] == dim, "x_kv shape")
    kernels.require_heads(dim, num_heads)
    kernels.require(n >= 1 and m >= 1, "empty query or key set")
    for t in w:
        kernels.require(t.device == device, "weights must be on the inputs' device")
    for t in (w.wq, w.wk, w.wv, w.wo):
        kernels.require(t.shape == (dim, dim), f"weight shape {tuple(t.shape)}")
    for t in (w.bq, w.bk, w.bv, w.bo):
        kernels.require(t.shape == (dim,) and t.dtype == torch.float32, "biases: f32 [D]")
    if kv_mask is not None:
        kernels.require(kv_mask.shape == (batch, m) and kv_mask.dtype == torch.bool, "kv_mask")
        kernels.require(kv_mask.device == device, "kv_mask device")


def _mask_ptr(kv_mask):
    if kv_mask is None:
        return None, None
    mask = kv_mask.contiguous().view(torch.uint8)
    return mask, mask.data_ptr()


def message_forward(
    x_q: torch.Tensor,
    x_kv: torch.Tensor,
    kv_mask: Optional[torch.Tensor],
    w: MessageWeights,
    num_heads: int,
    compute_dtype: torch.dtype,
):
    """(msg, attn, lse) of the attention half: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if x_q.device.type == "cpu":
        return message_forward_plain(x_q, x_kv, kv_mask, w, num_heads, compute_dtype)
    dtype = compute_dtype
    _check_message_inputs(x_q, x_kv, kv_mask, w, num_heads, dtype)
    batch, n, dim = x_q.shape
    m = x_kv.shape[1]
    device = x_q.device
    x_q, x_kv = x_q.contiguous(), x_kv.contiguous()
    mats = [t.detach().to(dtype).contiguous() for t in (w.wq, w.wk, w.wv, w.wo)]
    vecs = [t.detach().contiguous() for t in (w.bq, w.bk, w.bv, w.bo)]
    is_bf16 = int(dtype == torch.bfloat16)
    size = kernels.entry_point(
        "message_forward", "og_message_forward_workspace", [ctypes.c_int] * 5, ctypes.c_size_t
    )(is_bf16, batch, n, m, dim)
    workspace = torch.empty(size, dtype=torch.uint8, device=device)
    msg = torch.empty(batch, n, dim, dtype=dtype, device=device)
    attn = torch.empty(batch, n, dim, dtype=dtype, device=device)
    lse = torch.empty(batch, num_heads, n, dtype=torch.float32, device=device)
    mask, mask_ptr = _mask_ptr(kv_mask)
    fn = kernels.entry_point(
        "message_forward", "og_message_forward",
        [ctypes.c_int] * 6 + [_VOID_P] * 3 + [ctypes.POINTER(_VOID_P)] * 2 + [_VOID_P] * 5,
    )
    status = fn(
        is_bf16, batch, n, m, dim, num_heads, x_q.data_ptr(), x_kv.data_ptr(), mask_ptr,
        (_VOID_P * 4)(*(t.data_ptr() for t in mats)), (_VOID_P * 4)(*(t.data_ptr() for t in vecs)),
        workspace.data_ptr(), msg.data_ptr(), attn.data_ptr(), lse.data_ptr(),
        kernels.stream_handle(device),
    )
    kernels.check(status, "og_message_forward")
    message_counter.add(msg, attn, lse)
    return msg, attn, lse


def message_backward(
    x_q: torch.Tensor,
    x_kv: torch.Tensor,
    kv_mask: Optional[torch.Tensor],
    w: MessageWeights,
    g: torch.Tensor,
    attn: torch.Tensor,
    lse: torch.Tensor,
    num_heads: int,
    compute_dtype: torch.dtype,
):
    """(dx_q, dx_kv, weight gradients) of the attention half: the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors."""
    if x_q.device.type == "cpu":
        return message_backward_plain(x_q, x_kv, kv_mask, w, g, attn, lse, num_heads, compute_dtype)
    dtype = compute_dtype
    _check_message_inputs(x_q, x_kv, kv_mask, w, num_heads, dtype)
    batch, n, dim = x_q.shape
    m = x_kv.shape[1]
    device = x_q.device
    kernels.require(g.shape == attn.shape == x_q.shape, "g and attn must be [B, N, D]")
    kernels.require(attn.dtype == dtype and lse.dtype == torch.float32, "attn/lse types")
    kernels.require(lse.shape == (batch, num_heads, n), "lse must be [B, H, N]")
    x_q, x_kv = x_q.contiguous(), x_kv.contiguous()
    g, attn, lse = g.to(dtype).contiguous(), attn.contiguous(), lse.contiguous()
    mats = [t.detach().to(dtype).contiguous() for t in (w.wq, w.wk, w.wv, w.wo)]
    vecs = [t.detach().contiguous() for t in (w.bq, w.bk, w.bv)]
    dxq = torch.empty(batch, n, dim, dtype=dtype, device=device)
    dxkv = torch.empty(batch, m, dim, dtype=dtype, device=device)
    dws = [torch.empty(dim, dim, dtype=torch.float32, device=device) for _ in range(4)]
    dbs = [torch.empty(dim, dtype=torch.float32, device=device) for _ in range(4)]
    outputs = [dxq, dxkv, *dws, *dbs]
    is_bf16 = int(dtype == torch.bfloat16)
    size = kernels.entry_point(
        "message_backward", "og_message_backward_workspace", [ctypes.c_int] * 6, ctypes.c_size_t
    )(is_bf16, batch, n, m, dim, num_heads)
    workspace = torch.empty(size, dtype=torch.uint8, device=device)
    mask, mask_ptr = _mask_ptr(kv_mask)
    dead = None if kv_mask is None else (~kv_mask.any(dim=1)).view(torch.uint8)  # no valid key
    fn = kernels.entry_point(
        "message_backward", "og_message_backward",
        [ctypes.c_int] * 6 + [_VOID_P] * 7 + [ctypes.POINTER(_VOID_P)] * 3 + [_VOID_P] * 2,
    )
    status = fn(
        is_bf16, batch, n, m, dim, num_heads, x_q.data_ptr(), x_kv.data_ptr(), mask_ptr,
        None if dead is None else dead.data_ptr(), g.data_ptr(), attn.data_ptr(), lse.data_ptr(),
        (_VOID_P * 4)(*(t.data_ptr() for t in mats)), (_VOID_P * 3)(*(t.data_ptr() for t in vecs)),
        (_VOID_P * 10)(*(t.data_ptr() for t in outputs)),
        workspace.data_ptr(), kernels.stream_handle(device),
    )
    kernels.check(status, "og_message_backward")
    message_bwd_counter.add(*outputs)
    grads = MessageWeights(dws[0], dbs[0], dws[1], dbs[1], dws[2], dbs[2], dws[3], dbs[3])
    return dxq, dxkv, grads


class _FusedAttentionMessage(torch.autograd.Function):
    """msg = attention half of a layer; the forward saves x_q, x_kv, the mask,
    attn and lse, and the backward runs the backward kernel. For self
    attention x_q and x_kv are one tensor: both gradients are returned and
    autograd adds them."""

    @staticmethod
    def forward(ctx, x_q, x_kv, kv_mask, num_heads, compute_dtype, *weights):
        w = MessageWeights(*weights)
        msg, attn, lse = message_forward(x_q, x_kv, kv_mask, w, num_heads, compute_dtype)
        ctx.save_for_backward(x_q, x_kv, kv_mask, attn, lse, *weights)
        ctx.num_heads, ctx.compute_dtype = num_heads, compute_dtype
        return msg

    @staticmethod
    def backward(ctx, g):
        x_q, x_kv, kv_mask, attn, lse, *weights = ctx.saved_tensors
        dxq, dxkv, dw = message_backward(
            x_q, x_kv, kv_mask, MessageWeights(*weights), g, attn, lse, ctx.num_heads,
            ctx.compute_dtype,
        )
        return (dxq, dxkv, None, None, None, *dw)


def fused_attention_message(
    x_q: torch.Tensor,
    x_kv: torch.Tensor,
    kv_mask: Optional[torch.Tensor],
    weights: MessageWeights,
    num_heads: int,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """The attention half of a train-mode layer, differentiable in x_q, x_kv
    and the eight weights: x_q [B, N, D], x_kv [B, M, D] (in the compute
    type), kv_mask [B, M] bool or None -> msg [B, N, D] in the compute type
    (default: x_q's type). The kernels for CUDA tensors, the plain versions
    for CPU tensors."""
    dtype = compute_dtype or x_q.dtype
    return _FusedAttentionMessage.apply(x_q, x_kv, kv_mask, num_heads, dtype, *weights)


# ----------------------------------------------------------- train-mode layer half


def train_half_plain(
    x_q: torch.Tensor,
    x_kv: torch.Tensor,
    kv_mask: Optional[torch.Tensor],
    w: MessageWeights,
    w1: torch.Tensor,
    b1: torch.Tensor,
    num_heads: int,
    use_offset: bool,
    compute_dtype: torch.dtype,
):
    """The plain version of the train-half kernel: x_q [B, N, D], x_kv
    [B, M, D], w1 [2D, 2D] (torch layout [out, in]), b1 [2D] -> (z [B, N, 2D]
    and attn [B, N, D] in the compute type, lse [B, H, N] f32), with
    z = relu(concat[x_q (- msg), msg] W1^T + b1). msg is rounded to the compute
    type before the concat."""
    dtype = compute_dtype
    msg, attn, lse = message_forward_plain(x_q, x_kv, kv_mask, w, num_heads, dtype)
    xq_c = x_q.to(dtype)
    cat = torch.cat([xq_c - msg if use_offset else xq_c, msg], dim=-1)
    z = torch.relu(_dense_f32(cat, w1.to(dtype), b1.float())).to(dtype)
    return z, attn, lse


def train_half_forward(
    x_q: torch.Tensor,
    x_kv: torch.Tensor,
    kv_mask: Optional[torch.Tensor],
    w: MessageWeights,
    w1: torch.Tensor,
    b1: torch.Tensor,
    num_heads: int,
    use_offset: bool,
    compute_dtype: torch.dtype,
):
    """(z, attn, lse) of the layer half: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if x_q.device.type == "cpu":
        return train_half_plain(x_q, x_kv, kv_mask, w, w1, b1, num_heads, use_offset, compute_dtype)
    dtype = compute_dtype
    _check_message_inputs(x_q, x_kv, kv_mask, w, num_heads, dtype)
    batch, n, dim = x_q.shape
    m = x_kv.shape[1]
    device = x_q.device
    kernels.require(w1.shape == (2 * dim, 2 * dim) and w1.device == device, f"w1 shape {tuple(w1.shape)}")
    kernels.require(
        b1.shape == (2 * dim,) and b1.dtype == torch.float32 and b1.device == device, "b1: f32 [2D]"
    )
    x_q, x_kv = x_q.contiguous(), x_kv.contiguous()
    mats = [t.detach().to(dtype).contiguous() for t in (w.wq, w.wk, w.wv, w.wo, w1)]
    vecs = [t.detach().contiguous() for t in (w.bq, w.bk, w.bv, w.bo, b1)]
    is_bf16 = int(dtype == torch.bfloat16)
    size = kernels.entry_point(
        "train_half", "og_train_half_workspace", [ctypes.c_int] * 5, ctypes.c_size_t
    )(is_bf16, batch, n, m, dim)
    workspace = torch.empty(size, dtype=torch.uint8, device=device)
    z = torch.empty(batch, n, 2 * dim, dtype=dtype, device=device)
    attn = torch.empty(batch, n, dim, dtype=dtype, device=device)
    lse = torch.empty(batch, num_heads, n, dtype=torch.float32, device=device)
    mask, mask_ptr = _mask_ptr(kv_mask)
    fn = kernels.entry_point(
        "train_half", "og_train_half",
        [ctypes.c_int] * 7 + [_VOID_P] * 3 + [ctypes.POINTER(_VOID_P)] * 2 + [_VOID_P] * 5,
    )
    status = fn(
        is_bf16, batch, n, m, dim, num_heads, int(use_offset), x_q.data_ptr(), x_kv.data_ptr(), mask_ptr,
        (_VOID_P * 5)(*(t.data_ptr() for t in mats)), (_VOID_P * 5)(*(t.data_ptr() for t in vecs)),
        workspace.data_ptr(), z.data_ptr(), attn.data_ptr(), lse.data_ptr(),
        kernels.stream_handle(device),
    )
    kernels.check(status, "og_train_half")
    half_counter.add(z, attn, lse)
    return z, attn, lse


class _FusedTrainLayerHalf(torch.autograd.Function):
    """z = relu(concat[x_q (- msg), msg] W1^T + b1) with msg the attention
    half. The backward is the JAX package's: a torch prologue that peels dense
    + ReLU off the cotangent without forming the concat (w1 consumed in column
    halves, dw1 assembled from the x_q and rebuilt-msg blocks), then the
    message backward kernel with dmsg and the saved attn and lse."""

    @staticmethod
    def forward(ctx, x_q, x_kv, kv_mask, num_heads, use_offset, compute_dtype, w1, b1, *weights):
        w = MessageWeights(*weights)
        z, attn, lse = train_half_forward(
            x_q, x_kv, kv_mask, w, w1, b1, num_heads, use_offset, compute_dtype
        )
        ctx.save_for_backward(x_q, x_kv, kv_mask, z, attn, lse, w1, b1, *weights)
        ctx.num_heads, ctx.use_offset, ctx.compute_dtype = num_heads, use_offset, compute_dtype
        return z

    @staticmethod
    def backward(ctx, dz):
        x_q, x_kv, kv_mask, z, attn, lse, w1, b1, *weights = ctx.saved_tensors
        w = MessageWeights(*weights)
        dtype, dim = ctx.compute_dtype, x_q.shape[-1]
        ds = torch.where(z > 0, dz, 0.0).to(dtype).float()  # [B, N, 2D], rounded to the compute type
        wh = w1.to(dtype).float()  # [out, in]
        d_first = torch.matmul(ds, wh[:, :dim])  # cotangent of concat[..., :D]
        d_second = torch.matmul(ds, wh[:, dim:])
        dmsg = d_second - d_first if ctx.use_offset else d_second
        # msg rebuilt from the saved attention output
        msg = _dense_f32(attn, w.wo.to(dtype), w.bo.float()).to(dtype)

        def block(a):  # [out, D]: ds^T a over the B * N rows
            return torch.einsum("bno,bni->oi", ds, a.to(dtype).float())

        e_x, e_m = block(x_q), block(msg)
        dw1 = torch.cat([e_x - e_m if ctx.use_offset else e_x, e_m], dim=1)
        db1 = ds.sum(dim=(0, 1))
        dxq_attn, dxkv, dw = message_backward(
            x_q, x_kv, kv_mask, w, dmsg.to(dtype), attn, lse, ctx.num_heads, dtype
        )
        dxq = (dxq_attn.float() + d_first).to(x_q.dtype)
        return (dxq, dxkv.to(x_kv.dtype), None, None, None, None, dw1.to(w1.dtype), db1.to(b1.dtype), *dw)


def fused_train_layer_half(
    x_q: torch.Tensor,
    x_kv: torch.Tensor,
    kv_mask: Optional[torch.Tensor],
    weights: MessageWeights,
    w1: torch.Tensor,
    b1: torch.Tensor,
    num_heads: int,
    use_offset: bool = False,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """The attention half of a train-mode layer and the FFN's first dense +
    ReLU, differentiable in x_q, x_kv and the ten weights: x_q [B, N, D], x_kv
    [B, M, D] (in the compute type), w1 [2D, 2D] in torch layout [out, in] and
    b1 [2D] in the parameter type (f32; their gradients come back in it) ->
    z = relu(concat[x_q (- msg), msg] W1^T + b1) [B, N, 2D] in the compute
    type. The caller finishes the layer: the masked train-mode BatchNorm on z,
    the second dense and the residual add. The kernels for CUDA tensors, the
    plain versions for CPU tensors."""
    dtype = compute_dtype or x_q.dtype
    return _FusedTrainLayerHalf.apply(
        x_q, x_kv, kv_mask, num_heads, use_offset, dtype, w1, b1, *weights
    )
