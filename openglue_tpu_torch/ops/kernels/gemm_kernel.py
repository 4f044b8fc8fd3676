"""The dense GEMMs of the layer kernels on their own: the wrappers of
``ops/csrc/gemm.cu`` (``gemm.cuh``'s tiled GEMM with its fused epilogues and
``tn_gemm.cuh``'s weight-gradient GEMM), their plain versions, and the counts
of their launches.

They are the dense products inside the TPU layer kernels of
``openglue_tpu/ops/pallas/gnn_layer_kernel.py`` (``_layer_kernel``,
``_message_kernel``, ``_train_half_kernel``, ``_message_bwd_kernel``): the
projections, the FFN, the input gradients (the ``kn`` form, ``a . w`` for
``w`` stored ``[k, n_out]``) and the weight gradients (``tn_gemm``,
``x^T y``). The layer kernels (K1, K4, K5, K6, K8) launch the same device
code from their own C entries; nothing on the model's path calls ``gemm`` or
``tn_gemm``. They exist so that each GEMM can be held against its plain
version and timed alone.

The GEMM is ``y = a . w^T + bias`` (or ``a . w`` with ``kn``), f32
accumulation, with one of the epilogues, which keep the layer kernels'
rounding points (T is a's type, f32 or bf16):

* ``bias``: ``T(y)``; ``bias_f32``: ``y`` in f32;
* ``concat``: ``m = T(y)``, out ``[rows, 2 n_out]`` = ``[x, m]``, or with
  ``use_offset`` ``[T(x - m), m]``;
* ``relu_affine``: ``T(relu(y) * scale + shift)``; ``relu``: ``T(relu(y))``;
  the ReLU keeps NaN;
* ``residual``: ``T(x + y)``.

With ``split``, output columns from ``split`` on take their weight rows from
``w2`` and their bias from ``bias2`` (the stacked ``[wk; wv]`` of the k+v
projection); with ``kn`` and ``k_split``, rows of ``w`` from ``k_split`` on
are rows of ``w2``. ``n_out`` must be a multiple of 64 and ``k`` of 32; any
number of rows.

In bf16 the kernel is Hopper's: wgmma on tiles that TMA loads (see
``gemm.cuh``). TMA reads each operand through a tensor map, so ``a``, ``x``
and the weights must start on a 16-byte boundary with row strides that are
multiples of 16 bytes, and ``split`` and ``k_split`` must be multiples of 8;
a call that breaks this raises. A launch rule in ``gemm.cuh`` picks the bf16
kernel's tile from the shape.

Counts: ``counter``, ``tn_counter`` and ``bf16_counter`` read the launches of
``gemm_f32``, ``tn_gemm_f32`` and ``gemm_bf16``, which the C code counts
where it launches them (``gemm.cuh``'s ``og_gemm_launches``), whether this
module's wrappers or a layer kernel's C entry asked for them.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import torch

from openglue_tpu_torch.ops import kernels

EPILOGUES = ("bias", "concat", "relu_affine", "residual", "bias_f32", "relu")

counter = kernels.LibraryLaunchCounter("gemm.cuh", "og_gemm_launches", 0)
tn_counter = kernels.LibraryLaunchCounter("gemm.cuh", "og_gemm_launches", 1)
bf16_counter = kernels.LibraryLaunchCounter("gemm.cuh", "og_gemm_launches", 2)

_VOID_P = ctypes.c_void_p


def _weight(w, w2, split, kn, k_split) -> torch.Tensor:
    """The effective weight as f32 [k, n_out]."""
    if kn:
        rows = w if not k_split else torch.cat([w[:k_split], w2])
        return rows.float()
    rows = w if not split else torch.cat([w[:split], w2])
    return rows.float().t()


def gemm_plain(
    a: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None, epilogue: str = "bias", *,
    x: Optional[torch.Tensor] = None, scale: Optional[torch.Tensor] = None, shift: Optional[torch.Tensor] = None,
    use_offset: bool = False, w2: Optional[torch.Tensor] = None, bias2: Optional[torch.Tensor] = None,
    split: int = 0, kn: bool = False, k_split: int = 0,
) -> torch.Tensor:
    """The plain version of the GEMM kernel (see the module docstring)."""
    dtype = a.dtype
    y = torch.matmul(a.float(), _weight(w, w2, split, kn, k_split))
    n_out = y.shape[-1]
    if split:
        head = bias[:split] if bias is not None else y.new_zeros(split)
        y = y + torch.cat([head, bias2[: n_out - split]])
    elif bias is not None:
        y = y + bias
    if epilogue == "bias":
        return y.to(dtype)
    if epilogue == "bias_f32":
        return y
    if epilogue == "concat":
        m = y.to(dtype)
        xt = x.to(dtype)
        return torch.cat([xt - m if use_offset else xt, m], dim=-1)
    if epilogue == "relu_affine":
        return (torch.relu(y) * scale + shift).to(dtype)
    if epilogue == "relu":
        return torch.relu(y).to(dtype)
    if epilogue == "residual":
        return (x.float() + y).to(dtype)
    raise ValueError(f"unknown epilogue {epilogue!r}")


def tn_gemm_plain(xs: Sequence[torch.Tensor], ys: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The plain version of the weight-gradient kernel: ``x^T y`` in f32 for
    each pair, x [rows, P] and y [rows, Q]."""
    return [torch.matmul(x.float().t(), y.float()) for x, y in zip(xs, ys)]


def _rows_ok(t: torch.Tensor, name: str) -> None:
    unit = 16 // t.element_size()
    kernels.require(t.dim() == 2 and t.stride(1) == 1, f"{name} must be 2-D with contiguous rows")
    kernels.require(
        t.stride(0) % unit == 0 and t.data_ptr() % 16 == 0,
        f"{name}: the row stride and the address must be multiples of 16 bytes",
    )


def gemm(
    a: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None, epilogue: str = "bias", *,
    x: Optional[torch.Tensor] = None, scale: Optional[torch.Tensor] = None, shift: Optional[torch.Tensor] = None,
    use_offset: bool = False, w2: Optional[torch.Tensor] = None, bias2: Optional[torch.Tensor] = None,
    split: int = 0, kn: bool = False, k_split: int = 0,
) -> torch.Tensor:
    """The GEMM kernel for CUDA tensors, the plain version for CPU tensors.
    a [rows, k]; w [n_out, k] (with ``split``: its first ``split`` rows, w2
    the rest), or with ``kn`` [k, n_out] (with ``k_split``: its first
    ``k_split`` rows, w2 the rest); x [rows, n_out] for concat and residual;
    bias, bias2, scale, shift f32."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}; the kernel has {EPILOGUES}")
    if a.device.type == "cpu":
        return gemm_plain(a, w, bias, epilogue, x=x, scale=scale, shift=shift, use_offset=use_offset,
                          w2=w2, bias2=bias2, split=split, kn=kn, k_split=k_split)
    dtype, device = a.dtype, a.device
    kernels.require(a.is_cuda and dtype in (torch.float32, torch.bfloat16), f"a: a CUDA f32 or bf16 tensor, got {dtype}")
    kernels.require(not kn or epilogue == "bias", "the kn form takes the bias epilogue only")
    _rows_ok(a, "a")
    rows, k = a.shape
    mats = [w] + ([w2] if (split or k_split) else [])
    for t in mats:
        kernels.require(t.device == device and t.dtype == dtype and t.is_contiguous(), "weights: device/type/contiguity")
    if dtype == torch.bfloat16:  # the TMA boxes of the bf16 kernel
        kernels.require(all(t.data_ptr() % 16 == 0 for t in mats), "bf16 weights must start on 16-byte boundaries")
        kernels.require(split % 8 == 0 and k_split % 8 == 0,
                        f"bf16: split and k_split must be multiples of 8, got {split}, {k_split}")
    if kn:
        n_out = w.shape[1]
        k_rows = w.shape[0] if not k_split else k_split + w2.shape[0]
        kernels.require(k_rows == k and (not k_split or (w2.shape[1] == n_out and w.shape[0] >= k_split)),
                        "kn: w must be [k, n_out] (with k_split, w[:k_split] and w2)")
    else:
        n_out = w.shape[0] if not split else split + w2.shape[0]
        kernels.require(w.shape[1] == k and (not split or (w2.shape[1] == k and w.shape[0] >= split)),
                        "w must be [n_out, k] (with split, w[:split] and w2)")
        kernels.require(not split or bias2 is not None, "split takes bias2")
    kernels.require(rows >= 1 and k % 32 == 0 and n_out % 64 == 0 and n_out >= 64,
                    f"rows >= 1, k % 32 == 0 and n_out % 64 == 0, got rows {rows}, k {k}, n_out {n_out}")
    for t, size in ((bias, None), (bias2, None), (scale, n_out), (shift, n_out)):
        if t is not None:
            kernels.require(t.device == device and t.dtype == torch.float32 and t.is_contiguous(), "f32 vectors")
            kernels.require(size is None or t.shape == (size,), f"vector of {size}")
    if epilogue == "relu_affine":
        kernels.require(scale is not None and shift is not None, "relu_affine takes scale and shift")
    if epilogue in ("concat", "residual"):
        kernels.require(x is not None and x.shape == (rows, n_out) and x.dtype == dtype and x.device == device,
                        f"{epilogue} takes x [rows, n_out] in a's type")
        _rows_ok(x, "x")
    cols = 2 * n_out if epilogue == "concat" else n_out
    out = torch.empty(rows, cols, dtype=torch.float32 if epilogue == "bias_f32" else dtype, device=device)
    fn = kernels.entry_point("gemm", "og_gemm", [ctypes.c_int] * 6 + [_VOID_P, ctypes.c_int, _VOID_P, _VOID_P,
                             _VOID_P, ctypes.c_int, _VOID_P, ctypes.c_int, _VOID_P, _VOID_P, ctypes.c_int,
                             _VOID_P, _VOID_P, ctypes.c_int, ctypes.c_int, _VOID_P])
    ptr = lambda t: None if t is None else t.data_ptr()
    status = fn(
        int(dtype == torch.bfloat16), EPILOGUES.index(epilogue), int(kn), rows, n_out, k,
        a.data_ptr(), a.stride(0), w.data_ptr(), ptr(bias), out.data_ptr(), out.stride(0),
        ptr(x), 0 if x is None else x.stride(0), ptr(scale), ptr(shift), int(use_offset),
        ptr(w2), ptr(bias2), split, k_split, kernels.stream_handle(device),
    )
    kernels.check(status, "og_gemm")
    return out


def tn_gemm(xs: Sequence[torch.Tensor], ys: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``x^T y`` in f32 for up to four pairs (x [rows, P], y [rows, Q], rows
    per pair, f32 or bf16): the kernel for CUDA tensors (row-chunk partials
    summed in a fixed order), the plain version for CPU tensors."""
    kernels.require(1 <= len(xs) == len(ys) <= 4, "one to four (x, y) pairs")
    if xs[0].device.type == "cpu":
        return tn_gemm_plain(xs, ys)
    dtype, device = xs[0].dtype, xs[0].device
    kernels.require(dtype in (torch.float32, torch.bfloat16), f"operand type {dtype}")
    p, q = xs[0].shape[1], ys[0].shape[1]
    for x, y in zip(xs, ys):
        kernels.require(x.is_cuda and x.device == device and y.device == device, "one CUDA device")
        kernels.require(x.dtype == dtype and y.dtype == dtype, "one operand type")
        kernels.require(x.shape[1] == p and y.shape[1] == q and x.shape[0] == y.shape[0] >= 1,
                        "x [rows, P] and y [rows, Q], one P and Q for all pairs")
        _rows_ok(x, "x")
        _rows_ok(y, "y")
    kernels.require(p % 64 == 0 and q % 64 == 0, f"P and Q must be multiples of 64, got {p}, {q}")
    count = len(xs)
    rows = (ctypes.c_int * count)(*(x.shape[0] for x in xs))
    is_bf16 = int(dtype == torch.bfloat16)
    size = kernels.entry_point(
        "gemm", "og_tn_gemm_workspace", [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 2,
        ctypes.c_size_t,
    )(is_bf16, count, rows, p, q)
    workspace = torch.empty(size, dtype=torch.uint8, device=device)
    outs = [torch.empty(p, q, dtype=torch.float32, device=device) for _ in range(count)]
    ints = lambda values: (ctypes.c_int * count)(*values)
    fn = kernels.entry_point(
        "gemm", "og_tn_gemm",
        [ctypes.c_int] * 2 + [ctypes.POINTER(_VOID_P), ctypes.POINTER(ctypes.c_int)] * 2
        + [ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int, ctypes.POINTER(_VOID_P), _VOID_P, _VOID_P],
    )
    status = fn(
        is_bf16, count,
        (_VOID_P * count)(*(x.data_ptr() for x in xs)), ints(x.stride(0) for x in xs),
        (_VOID_P * count)(*(y.data_ptr() for y in ys)), ints(y.stride(0) for y in ys),
        rows, p, q, (_VOID_P * count)(*(o.data_ptr() for o in outs)), workspace.data_ptr(),
        kernels.stream_handle(device),
    )
    kernels.check(status, "og_tn_gemm")
    return outs
