"""Time the attending layer kernels and the dense GEMMs of one checkout of
the port on a CUDA card.

    python3 scripts/kernel_times.py --repo DIR [--label NAME] [--rounds 7] [--only TEXT ...]

Imports ``openglue_tpu_torch`` from the checkout DIR (its kernels build into
DIR/build/kernels) and prints one JSON line: the card (``nvidia-smi`` name and
power limit); each case's time in ms as the median of ``--rounds`` rounds of
20 back-to-back calls, queued while the card is held busy and timed with
CUDA events (every round listed); the device time by kernel
(torch.profiler) of one f32 ``message`` layer (K4 + K5), which splits the
layer into its GEMM, attention and reduction launches, of K10 and K5 in
bf16, which split the attention backward into its passes, and of K6 (each
kind, bf16 and f32), which splits the layer into its GEMMs and its attention
part; the registers and spill bytes per thread that ``ptxas -v`` reports for the attention kernels and the dense
GEMMs of DIR's sources; the flagship matcher serving a B=16 and a B=1
request at N=1024 (median host ms of 5 runs, pairs/s and the device busy ms
of one run, ``chip_smoke.py``'s model, requests and profile); and the host's
time per call of K1 and K9 at B=1 (where the bf16 kernels encode their TMA
tensor maps).

The cases, at the shapes of ``chip_smoke.py``: K1 B=16 N=1024 D=256; K4, K5,
K8 B=12 N=1024 D=256; K6 (linear, favor_relu and favor_softmax with F=128)
B=16 N=1024; each in bf16 and f32; K6 bf16 at D=128 (F=64); K5 bf16 at
D=128; K7 (the int8 layer) in its four modes at B=16 N=1024 D=256 with bf16 x
(static scales calibrated as ``chip_smoke.py`` calibrates them), int8 and
int8_static_attn at D=128, beside ``torch._int_mm`` on each of its six s8
products; K9, K10, K11 bf16 at B=12 N=1024 and B=4 N=2048 (H=4, heads of
width 64), K9 and K10 also at B=12 with heads of width 32 and in f32, each
beside ``scaled_dot_product_attention`` on the same inputs and mask (for K10
its forward and backward less its forward); K1's parts alone at B=16: its
attention on K1's operand layout beside the same library call, and its five
bf16 GEMMs, each beside ``F.linear``; K2 with f32 K at B=16, B=1 and B=12
N=1024 and with bf16 K at B=4 N=2048, K2s (the Sinkhorn forward past the
fused kernel's columns, whichever kernel the checkout runs there) with bf16
K at B=1 and B=4 N=4352 and B=1 N=8192 and N=16000 and with f32 K at B=1
N=4352 and N=8192, and K3 at B=12 N=1024 T=20
(padded, masked OT matrices); and, where the checkout has
``ops/kernels/gemm_kernel.py``, the f32 GEMM and weight-gradient GEMM alone at
the ``message`` step's shapes (12,288 rows, D=256). (``bf16_ablations.py``
times the bf16 GEMM at each of its tiles.)

To compare two checkouts on one card, run it in one session in the order
A, B, B, A. ``--only`` keeps the cases and profiles whose names hold one of
the given texts (``--only K7 _int_mm`` for the int8 layer, ``--only K2s``
for the wide Sinkhorn), the ptxas report of gnn_layer_int8 and sinkhorn
alone, and no serving or host readings.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

# the sources ptxas reports on (those the checkout has), and the kernels
# (the bf16 backward passes keep their names from the mma.sync design to the
# wgmma one, so one call reports both checkouts' passes; K6's attention part
# is listed under its one-launch name and its three earlier kernels' names)
PTXAS_SOURCES = ("gnn_layer", "gnn_layer_features", "gnn_layer_int8", "message_forward", "message_backward",
                 "train_half", "attention", "attention_backward", "gemm", "sinkhorn")
PTXAS_KERNELS = ("feature_attention", "key_features_kernel", "aggregate_kernel", "query_kernel", "attention_bf16",
                 "attn_bwd_dq_bf16", "attn_bwd_dkdv_bf16", "gemm_f32", "tn_gemm_f32", "gemm_bf16", "gemm_s8",
                 "attention_s8", "quant_", "sinkhorn_")


def own_profiling():
    """``openglue_tpu_torch/profiling.py`` of the checkout this script lies
    in, loaded by its path (it imports only torch), so that every ``--repo``
    tree is timed by one method, also a tree from before that module."""
    path = Path(__file__).resolve().parents[1] / "openglue_tpu_torch" / "profiling.py"
    spec = importlib.util.spec_from_file_location("kernel_times_profiling", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def kernel_cases(gen):
    from openglue_tpu_torch.ops.attention import sample_orthogonal_random_matrix
    from openglue_tpu_torch.ops.kernels import attention_kernel as ak
    from openglue_tpu_torch.ops.kernels import gnn_layer_kernel as glk

    dev = torch.device("cuda")

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    def ragged(batch, n, low):
        counts = torch.randint(low, n + 1, (batch,), generator=gen, device=dev)
        return torch.arange(n, device=dev)[None] < counts[:, None]

    cases = {}
    dim, heads = 256, 4
    d2 = 2 * dim
    for dt, tag in ((torch.bfloat16, ""), (torch.float32, " f32")):
        lw = layer_weights(gen, dim, dt)
        xq, xkv, mask = r(16, 1024, dim).to(dt), r(16, 1024, dim).to(dt), ragged(16, 1024, 256)
        cases[f"K1 B=16 N=1024{tag}"] = (
            lambda xq=xq, xkv=xkv, mask=mask, lw=lw: glk.fused_attention_propagation(xq, xkv, mask, lw, heads))
        for kind in glk.FEATURE_KINDS:
            proj = None if kind == "linear" else sample_orthogonal_random_matrix(gen, 128, 64)
            cases[f"K6 {kind} B=16 N=1024{tag}"] = (
                lambda xq=xq, xkv=xkv, mask=mask, lw=lw, kind=kind, proj=proj: glk.fused_attention_propagation(
                    xq, xkv, mask, lw, heads, False, kind, proj))

        w = glk.MessageWeights(*[r(dim, dim, scale=dim**-0.5) if i % 2 == 0 else r(dim) for i in range(8)])
        mq, mkv, mg = r(12, 1024, dim).to(dt), r(12, 1024, dim).to(dt), r(12, 1024, dim).to(dt)
        mmask = ragged(12, 1024, 512)
        _, attn, lse = glk.message_forward(mq, mkv, mmask, w, heads, dt)
        cases[f"K4 B=12 N=1024{tag}"] = lambda mq=mq, mkv=mkv, m=mmask, w=w, dt=dt: glk.message_forward(
            mq, mkv, m, w, heads, dt)
        cases[f"K5 B=12 N=1024{tag}"] = lambda mq=mq, mkv=mkv, m=mmask, w=w, g=mg, a=attn, l=lse, dt=dt: (
            glk.message_backward(mq, mkv, m, w, g, a, l, heads, dt))
        w1, b1 = r(d2, d2, scale=d2**-0.5), r(d2)
        cases[f"K8 B=12 N=1024{tag}"] = lambda mq=mq, mkv=mkv, m=mmask, w=w, w1=w1, b1=b1, dt=dt: (
            glk.train_half_forward(mq, mkv, m, w, w1, b1, heads, False, dt))

    cases.update(k6_d128_cases(gen))
    # K5 bf16 at D=128 (4 heads of width 32: the SIFT width of the pretraining fixture)
    dim32 = 128
    w = glk.MessageWeights(*[r(dim32, dim32, scale=dim32**-0.5) if i % 2 == 0 else r(dim32) for i in range(8)])
    mq, mkv, mg = (r(12, 1024, dim32).bfloat16() for _ in range(3))
    mmask = ragged(12, 1024, 512)
    _, attn, lse = glk.message_forward(mq, mkv, mmask, w, heads, torch.bfloat16)
    cases["K5 B=12 N=1024 D=128"] = lambda: glk.message_backward(mq, mkv, mmask, w, mg, attn, lse, heads, torch.bfloat16)

    F = torch.nn.functional
    # (batch, n, head width, type, tag): K9 and K10 in bf16 at both shapes
    # and dh=32, and in f32 at B=12 (K11 bf16 at both shapes)
    for batch, n, dh, dt, tag in ((12, 1024, 64, torch.bfloat16, ""), (4, 2048, 64, torch.bfloat16, ""),
                                  (12, 1024, 32, torch.bfloat16, " dh=32"), (12, 1024, 64, torch.float32, " f32")):
        def heads_of():
            return r(batch, n, heads * dh).to(dt).view(batch, n, heads, dh).transpose(1, 2)

        q, k, v, g = heads_of(), heads_of(), heads_of(), heads_of()
        amask = ragged(batch, n, n // 2)
        out, alse = ak.attention_forward(q, k, v, amask)
        cases[f"K9 B={batch} N={n}{tag}"] = lambda q=q, k=k, v=v, m=amask: ak.attention_forward(q, k, v, m)
        if not tag:
            cases[f"K11 B={batch} N={n}"] = lambda q=q, k=k, v=v, m=amask: ak.attention_lse_forward(q, k, v, m)
        cases[f"K10 B={batch} N={n}{tag}"] = (
            lambda q=q, k=k, v=v, m=amask, g=g, o=out, l=alse: ak.attention_backward(q, k, v, m, g, o, l))
        lq, lk, lv = (t.detach().clone().requires_grad_() for t in (q, k, v))
        sdpa = lambda q=lq, k=lk, v=lv, m=amask[:, None, None, :]: F.scaled_dot_product_attention(q, k, v, attn_mask=m)

        def sdpa_both(sdpa=sdpa, g=g, ts=(lq, lk, lv)):
            with torch.enable_grad():
                for t in ts:
                    t.grad = None
                sdpa().backward(g)

        cases[f"library SDPA B={batch} N={n}{tag}"] = sdpa
        cases[f"library SDPA forward+backward B={batch} N={n}{tag}"] = sdpa_both
    cases.update(k1_part_cases(gen))
    cases.update(k7_cases(gen))
    cases.update(sinkhorn_cases(gen))
    return cases


def layer_weights(gen, dim, dt):
    """Random K1 / K6 layer weights at width ``dim`` in compute type ``dt``."""
    from openglue_tpu_torch.ops.kernels import gnn_layer_kernel as glk

    r = lambda *shape, scale=1.0: torch.randn(*shape, generator=gen, device="cuda") * scale
    d2 = 2 * dim
    return glk.PropagationWeights(
        r(dim, dim, scale=dim**-0.5).to(dt), r(dim), r(dim, dim, scale=dim**-0.5).to(dt), r(dim),
        r(dim, dim, scale=dim**-0.5).to(dt), r(dim), r(dim, dim, scale=dim**-0.5).to(dt), r(dim),
        r(d2, d2, scale=d2**-0.5).to(dt), r(d2), 1.0 + 0.1 * r(d2), 0.1 * r(d2),
        r(dim, d2, scale=d2**-0.5).to(dt), r(dim),
    )


def k6_inputs(gen, kind, dt, batch=16, n=1024, dim=256, heads=4):
    """K6's arguments at chip_smoke.py's shape (a ragged key mask with valid
    counts in [N/4, N]; F = 2 dh for the FAVOR kinds, dh for linear)."""
    from openglue_tpu_torch.ops.attention import sample_orthogonal_random_matrix

    dev, dh = torch.device("cuda"), dim // heads
    xq = torch.randn(batch, n, dim, generator=gen, device=dev).to(dt)
    xkv = torch.randn(batch, n, dim, generator=gen, device=dev).to(dt)
    counts = torch.randint(n // 4, n + 1, (batch,), generator=gen, device=dev)
    mask = torch.arange(n, device=dev)[None] < counts[:, None]
    proj = None if kind == "linear" else sample_orthogonal_random_matrix(gen, 2 * dh, dh)
    return xq, xkv, mask, layer_weights(gen, dim, dt), heads, False, kind, proj


def k6_d128_cases(gen):
    """K6 bf16 at D=128 (4 heads of width 32, F = 64 for the FAVOR kinds)."""
    from openglue_tpu_torch.ops.kernels import gnn_layer_kernel as glk

    cases = {}
    for kind in glk.FEATURE_KINDS:
        args = k6_inputs(gen, kind, torch.bfloat16, dim=128)
        cases[f"K6 {kind} B=16 N=1024 D=128"] = lambda args=args: glk.fused_attention_propagation(*args)
    return cases


# K7's modes as (static scales, int8 attention), as chip_smoke.py's INT8_MODES
K7_MODES = {"int8": (False, False), "int8_static": (True, False), "int8_attn": (False, True),
            "int8_static_attn": (True, True)}
# K7's six s8 products at D=256: (name, n_out / D, k / D)
K7_PRODUCTS = (("q", 1, 1), ("k", 1, 1), ("v", 1, 1), ("out", 1, 1), ("ffn1", 2, 2), ("ffn2", 1, 2))


def k7_inputs(gen, mode, batch=16, n=1024, dim=256, heads=4):
    """K7's arguments at chip_smoke.py's shape: bf16 x, a ragged key mask
    (valid counts in [N/4, N]), int8 weights quantized from random f32 ones
    and, for the static modes, scales calibrated as ``int8_layer_phase``
    calibrates them (the plain version's absmax x 1.1 / 127)."""
    from openglue_tpu_torch.ops.kernels import gnn_layer_int8 as gli8

    dev = torch.device("cuda")
    static, quant_attention = K7_MODES[mode]
    qw = gli8.quantize_propagation_weights(layer_weights(gen, dim, torch.float32))
    xq = torch.randn(batch, n, dim, generator=gen, device=dev).bfloat16()
    xkv = torch.randn(batch, n, dim, generator=gen, device=dev).bfloat16()
    counts = torch.randint(n // 4, n + 1, (batch,), generator=gen, device=dev)
    mask = torch.arange(n, device=dev)[None] < counts[:, None]
    scales = None
    if static:
        absmax = gli8.reference_activation_absmax(xq, xkv, mask, qw, heads, quant_attention=quant_attention)
        scales = absmax * (1.1 / 127.0) + 1e-12
    return (xq, xkv, mask, qw, heads), dict(act_scales=scales, quant_attention=quant_attention)


def k7_cases(gen, rows=16 * 1024, dim=256):
    """K7's four modes at B=16 N=M=1024 D=256, int8 and int8_static_attn at
    D=128, and ``torch._int_mm`` (s8 x s8 -> s32, the bare product with no
    dequantization or epilogue) on each of K7's six products at B=16
    N=1024, the library yardstick of its GEMM share (the port never calls
    it)."""
    from openglue_tpu_torch.ops.kernels import gnn_layer_int8 as gli8

    cases = {}
    for mode, d in [(m, 256) for m in K7_MODES] + [("int8", 128), ("int8_static_attn", 128)]:
        args, kw = k7_inputs(gen, mode, dim=d)
        tag = "" if d == 256 else f" D={d}"
        cases[f"K7 {mode} B=16 N=1024{tag}"] = lambda args=args, kw=kw: gli8.fused_attention_propagation_int8(
            *args, **kw)
    dev = torch.device("cuda")
    for name, n_mul, k_mul in K7_PRODUCTS:
        n_out, k = n_mul * dim, k_mul * dim
        a = torch.randint(-127, 128, (rows, k), generator=gen, device=dev, dtype=torch.int8)
        w = torch.randint(-127, 128, (n_out, k), generator=gen, device=dev, dtype=torch.int8)
        cases[f"library _int_mm K7 {name} {rows}x{n_out}x{k}"] = lambda a=a, w=w: torch._int_mm(a, w.t())
    return cases


def sinkhorn_cases(gen):
    """K2 at chip_smoke.py's serving and training shapes (f32 K B=16, B=1 and
    B=12 N=1024, bf16 K B=4 N=2048), K2s at its bf16 shapes (B=1 and B=4
    N=4352, B=1 N=8192), at the shapes of its instances that keep eight
    column vectors a thread (bf16 K B=1 N=16000, f32 K B=1 N=8192) and with
    f32 K at B=1 N=4352 (four vectors), and K3 at the training shape (B=12
    N=1024 T=20), on
    padded, masked OT matrices, through the wrappers' public functions
    (``sinkhorn_scale``, ``sinkhorn_adjoint``)."""
    from openglue_tpu_torch.ops.kernels import sinkhorn_kernel as sk

    dev = torch.device("cuda")

    def ot(batch, n):
        scores = torch.randn(batch, n, n, generator=gen, device=dev) * 4
        mask0 = torch.rand(batch, n, generator=gen, device=dev) > 0.1
        mask1 = torch.rand(batch, n, generator=gen, device=dev) > 0.1
        rows, cp = n + 1, sk._round_up(n + 1, sk.COL_ALIGN)
        M = sk.build_padded_otp_matrix(scores, torch.tensor(1.0, device=dev), 1.0, mask0, mask1, rows, cp)
        la, lb, _ = sk.otp_marginals(batch, n, n, mask0, mask1, dev)
        return (M, *sk.padded_marginals(la, lb, rows, cp)), sk.valid_pairs(batch, n, n, mask0, mask1, dev)

    cases = {}
    for batch, n in ((16, 1024), (1, 1024), (4, 2048), (12, 1024)):
        (M, la, lb), _ = ot(batch, n)
        kd = sk.k_storage_dtype(n + 1, n + 1)
        cases[f"K2 {str(kd)[6:]} B={batch} N={n}"] = lambda M=M, la=la, lb=lb, kd=kd: sk.sinkhorn_scale(M, la, lb, 20, kd)
    for batch, n, kd in ((1, 4352, torch.bfloat16), (4, 4352, torch.bfloat16), (1, 8192, torch.bfloat16),
                         (1, 16000, torch.bfloat16), (1, 4352, torch.float32), (1, 8192, torch.float32)):
        (M, la, lb), _ = ot(batch, n)
        cases[f"K2s {str(kd)[6:]} B={batch} N={n}"] = lambda M=M, la=la, lb=lb, kd=kd: sk.sinkhorn_scale(
            M, la, lb, 20, kd)
    (M, la, lb), valid = ot(12, 1024)
    g = torch.zeros_like(M)
    g[:, :, :1025] = torch.randn(12, 1025, 1025, generator=gen, device=dev) * valid
    args = (M, la, lb, M.amax(dim=2), g.sum(2), g.sum(1), 20)
    cases["K3 B=12 N=1024 T=20"] = lambda: sk.sinkhorn_adjoint(*args)
    return cases


# K1's five bf16 GEMMs at D=256: (name, n_out / D, k / D, epilogue)
K1_GEMMS = (("kv", 2, 1, "bias"), ("q", 1, 1, "bias"), ("out+concat", 1, 1, "concat"),
            ("ffn1", 2, 2, "relu_affine"), ("ffn2", 1, 2, "residual"))


def k1_part_cases(gen, batch=16, n=1024, dim=256, heads=4):
    """K1's attention and its five GEMMs alone at the serving shape (bf16),
    each beside one PyTorch call for the same function: the attention on
    K1's layout (q a [B, N, D] buffer, k and v the column blocks of one
    [B, M, 2D] buffer) with a ragged key mask, beside
    ``scaled_dot_product_attention`` on the same views and mask; each GEMM
    beside ``F.linear``. None of the GEMMs where the checkout has no
    gemm_kernel module."""
    from openglue_tpu_torch.ops.kernels import attention_kernel as ak

    F, dev, dt, dh = torch.nn.functional, torch.device("cuda"), torch.bfloat16, dim // heads
    r = lambda *shape, scale=1.0: torch.randn(*shape, generator=gen, device=dev) * scale
    q = r(batch, n, dim).to(dt).view(batch, n, heads, dh).transpose(1, 2)
    kv = r(batch, n, 2 * dim).to(dt)
    k = kv[..., :dim].view(batch, n, heads, dh).transpose(1, 2)
    v = kv[..., dim:].view(batch, n, heads, dh).transpose(1, 2)
    counts = torch.randint(n // 4, n + 1, (batch,), generator=gen, device=dev)
    mask = torch.arange(n, device=dev)[None] < counts[:, None]
    m4 = mask[:, None, None, :]
    cases = {
        f"K1 attention B={batch} N={n}": lambda: ak.attention_forward(q, k, v, mask, False),
        f"library SDPA K1 attention B={batch} N={n}": lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=m4),
    }
    try:
        from openglue_tpu_torch.ops.kernels import gemm_kernel as gk
    except ImportError:
        return cases
    rows = batch * n
    for name, n_mul, k_mul, epilogue in K1_GEMMS:
        n_out, kk = n_mul * dim, k_mul * dim
        a, w, b = r(rows, kk).to(dt), r(n_out, kk, scale=kk**-0.5).to(dt), r(n_out)
        x, sc, sh = r(rows, n_out).to(dt), 1.0 + 0.1 * r(n_out), 0.1 * r(n_out)
        kw = dict(a=a, w=w, bias=b, epilogue=epilogue, x=x, scale=sc, shift=sh)
        cases[f"gemm_bf16 K1 {name} {rows}x{n_out}x{kk}"] = lambda kw=kw: gk.gemm(**kw)
        cases[f"library F.linear K1 {name}"] = lambda a=a, w=w, b=b.to(dt): F.linear(a, w, b)
    return cases


def host_us(fn, calls: int = 100) -> float:
    """The host's time to issue one call of ``fn``, in microseconds: ``calls``
    calls queued while the card is held busy (``torch.cuda._sleep``), so that
    no call waits for the card."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(400_000_000)
    start = time.perf_counter()
    for _ in range(calls):
        fn()
    seconds = time.perf_counter() - start
    torch.cuda.synchronize()
    return seconds / calls * 1e6


def host_cases(gen):
    """K1 bf16 at B=1 N=1024 (one request's layer) and K1's attention alone at
    B=1: the host's time per call, where the tensor maps are encoded."""
    from openglue_tpu_torch.ops.kernels import attention_kernel as ak
    from openglue_tpu_torch.ops.kernels import gnn_layer_kernel as glk

    dev, dim, heads, dt = torch.device("cuda"), 256, 4, torch.bfloat16
    r = lambda *shape, scale=1.0: torch.randn(*shape, generator=gen, device=dev) * scale
    d2 = 2 * dim
    lw = glk.PropagationWeights(
        r(dim, dim, scale=dim**-0.5).to(dt), r(dim), r(dim, dim, scale=dim**-0.5).to(dt), r(dim),
        r(dim, dim, scale=dim**-0.5).to(dt), r(dim), r(dim, dim, scale=dim**-0.5).to(dt), r(dim),
        r(d2, d2, scale=d2**-0.5).to(dt), r(d2), 1.0 + 0.1 * r(d2), 0.1 * r(d2),
        r(dim, d2, scale=d2**-0.5).to(dt), r(dim),
    )
    xq, xkv = r(1, 1024, dim).to(dt), r(1, 1024, dim).to(dt)
    mask = torch.arange(1024, device=dev)[None] < 700
    q, k, v = (r(1, 1024, dim).to(dt).view(1, 1024, heads, 64).transpose(1, 2) for _ in range(3))
    return {
        "K1 B=1 N=1024 host us per call": host_us(lambda: glk.fused_attention_propagation(xq, xkv, mask, lw, heads)),
        "K9 B=1 N=1024 host us per call": host_us(lambda: ak.attention_forward(q, k, v, mask)),
    }


def serve_cases(repo: Path, gen):
    """(name, pairs, seconds, busy ms) of the flagship matcher (``chip_smoke.py``'s
    config, random weights from seed 0) on a B=16 and a B=1 request at
    N=1024: the median host time of 5 runs and the device busy time of one."""
    import chip_smoke as cs
    from openglue_tpu_torch.cli.common import superglue_config_from
    from openglue_tpu_torch.data.synthetic import SyntheticHomographyPairs
    from openglue_tpu_torch.models.matching import decode_from_output
    from openglue_tpu_torch.models.superglue import SuperGlue
    from openglue_tpu_torch.train.step import superglue_inputs

    cfg = superglue_config_from({"superglue": cs.SUPERGLUE_SECTION}, cs.DESCRIPTOR_DIM, cs.SIDE_INFO_DIM)
    model = SuperGlue(cfg, device="cuda", generator=torch.Generator().manual_seed(0)).eval()
    counts = lambda b: torch.randint(512, 1025, (b,), generator=gen, device="cuda").tolist()
    out = {}
    for name, batch in (("serve B=16 N=1024", 16), ("serve B=1 N=1024", 1)):
        pairs = cs.make_request(SyntheticHomographyPairs, gen, batch, 1024, counts(batch), counts(batch))
        inputs = superglue_inputs(pairs)
        run = lambda: cs.serve(model, decode_from_output, inputs)
        for _ in range(3):
            run()
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            start = time.perf_counter()
            run()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - start)
        busy, _ = cs.device_profile(run)
        ms = statistics.median(times) * 1e3
        out[name] = {"ms": ms, "pairs_per_s": batch / ms * 1e3, "busy_ms": busy, "runs_ms": [t * 1e3 for t in times]}
    return out


def gemm_cases(gen):
    """The f32 GEMMs alone at the message step's shapes (none where the
    checkout has no gemm_kernel module)."""
    try:
        from openglue_tpu_torch.ops.kernels import gemm_kernel as gk
    except ImportError:
        return {}
    dev, rows, dim = torch.device("cuda"), 12 * 1024, 256

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    a, a2 = r(rows, dim), r(rows, 2 * dim)
    wkv, bkv, w, b = r(2 * dim, dim, scale=dim**-0.5), r(2 * dim), r(dim, dim, scale=dim**-0.5), r(dim)
    wt, wt2 = r(dim, dim, scale=dim**-0.5), r(2 * dim, dim, scale=dim**-0.5)
    xs, ys = [r(rows, dim) for _ in range(4)], [r(rows, dim) for _ in range(4)]
    return {
        "gemm_f32 kv 12288x512x256": lambda: gk.gemm(a, wkv[:dim], bkv[:dim], w2=wkv[dim:], bias2=bkv[dim:],
                                                     split=dim),
        "gemm_f32 q/out 12288x256x256": lambda: gk.gemm(a, w, b),
        "gemm_f32 kn 12288x256x256": lambda: gk.gemm(a, wt, None, kn=True),
        "gemm_f32 kn dx_kv 12288x256x512": lambda: gk.gemm(a2, wt2[:dim], None, kn=True, w2=wt2[dim:], k_split=dim),
        "tn_gemm_f32 4x256x256 over 12288": lambda: gk.tn_gemm(xs, ys),
    }


def kernel_profile(fn, calls: int = 10):
    """{kernel: {ms_per_call, launches_per_call}} of ``fn``'s device work,
    from torch.profiler over ``calls`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = {}
    for event in prof.key_averages():
        ms = getattr(event, "self_device_time_total", 0.0) / 1e3
        if ms <= 0 or event.key.startswith(("Memcpy", "Memset")):
            continue
        name = event.key.replace("void ", "").replace("(anonymous namespace)::", "").split("(")[0]
        rows[name] = {"ms_per_call": ms / calls, "launches_per_call": event.count / calls}
    return rows


def profiles(gen):
    """Device ms per call by kernel of one f32 message layer (K4 + K5 at B=12
    N=1024 D=256), which splits it into its GEMM, attention and reduction
    launches, and of K10 bf16 and K5 bf16 (B=12 N=1024, D=256), which split
    the bf16 attention backward into its two passes and what surrounds them."""
    from openglue_tpu_torch.ops.kernels import attention_kernel as ak
    from openglue_tpu_torch.ops.kernels import gnn_layer_kernel as glk

    dev, dim, heads = torch.device("cuda"), 256, 4
    r = lambda *shape, scale=1.0: torch.randn(*shape, generator=gen, device=dev) * scale
    mask = torch.arange(1024, device=dev)[None] < torch.randint(512, 1025, (12,), generator=gen, device=dev)[:, None]
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        w = glk.MessageWeights(*[r(dim, dim, scale=dim**-0.5) if i % 2 == 0 else r(dim) for i in range(8)])
        mq, mkv, mg = (r(12, 1024, dim).to(dt) for _ in range(3))
        _, attn, lse = glk.message_forward(mq, mkv, mask, w, heads, dt)

        def bwd():
            return glk.message_backward(mq, mkv, mask, w, mg, attn, lse, heads, dt)

        if dt == torch.float32:
            out["f32 message layer"] = kernel_profile(lambda: (glk.message_forward(mq, mkv, mask, w, heads, dt), bwd()))
        else:
            out["K5 bf16"] = kernel_profile(bwd)
    q, k, v, g = (r(12, 1024, dim).bfloat16().view(12, 1024, heads, 64).transpose(1, 2) for _ in range(4))
    o, lse = ak.attention_forward(q, k, v, mask)
    out["K10 bf16"] = kernel_profile(lambda: ak.attention_backward(q, k, v, mask, g, o, lse))
    # K6 launch by launch (its GEMMs and its attention part) at B=16 N=1024 D=256, F=128 for FAVOR
    for kind in glk.FEATURE_KINDS:
        for dt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            args = k6_inputs(gen, kind, dt)
            out[f"K6 {kind} {tag}"] = kernel_profile(lambda args=args: glk.fused_attention_propagation(*args))
    # K7 launch by launch in each mode (B=16 N=1024 D=256, bf16 x)
    from openglue_tpu_torch.ops.kernels import gnn_layer_int8 as gli8

    for mode in K7_MODES:
        args, kw = k7_inputs(gen, mode)
        out[f"K7 {mode}"] = kernel_profile(lambda args=args, kw=kw: gli8.fused_attention_propagation_int8(*args, **kw))
    return out


def ptxas_usage(repo: Path, sources=None):
    """{source: {kernel: (registers, spill store bytes, spill load bytes)}}
    for the attention kernels and the dense GEMMs, from ``nvcc -Xptxas -v``,
    of ``sources`` (default PTXAS_SOURCES)."""
    from openglue_tpu_torch.ops import kernels

    nvcc, cxxfilt = kernels._nvcc(), shutil.which("c++filt")
    csrc, flags = repo / "openglue_tpu_torch" / "ops" / "csrc", [f for f in kernels.NVCC_FLAGS if f != "-shared"]
    scratch = tempfile.mkdtemp(dir=repo / "build")
    procs = {name: subprocess.Popen([nvcc, *flags, "-Xptxas", "-v", "-cubin", "-o", f"{scratch}/{name}.cubin",
                                     str(csrc / f"{name}.cu")],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for name in (sources or PTXAS_SOURCES) if (csrc / f"{name}.cu").exists()}
    usage = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        fn, found = None, {}
        for line in out.splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", line)
            if m:
                fn = m.group(1)
                if cxxfilt:
                    fn = subprocess.run([cxxfilt], input=fn, capture_output=True, text=True).stdout.strip()
                continue
            if fn is None or not any(kname in fn for kname in PTXAS_KERNELS):
                continue
            short = re.sub(r"\(.*", "", fn.replace("(anonymous namespace)::", ""))
            entry = found.setdefault(short, [None, None, None])
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                entry[1], entry[2] = int(m.group(1)), int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                entry[0] = int(m.group(1))
        usage[name] = found if proc.returncode == 0 else {"nvcc failed": out[-2000:]}
    shutil.rmtree(scratch)
    return usage


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repo", type=Path, required=True, help="root of the checkout to time")
    parser.add_argument("--label", default=None)
    parser.add_argument("--rounds", type=int, default=7)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--only", nargs="*", default=None, help="keep the cases whose names hold one of these")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA card is available", file=sys.stderr)
        return 1
    repo = args.repo.resolve()
    sys.path.insert(0, str(repo))
    from openglue_tpu_torch.ops import kernels

    kernels.build_all()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    torch.backends.cuda.matmul.allow_tf32 = False
    keep = (lambda name: True) if args.only is None else (lambda name: any(o in name for o in args.only))
    with torch.no_grad():
        cases = {**kernel_cases(gen), **gemm_cases(gen)}
        device_rounds_ms = own_profiling().device_rounds_ms
        times = {name: device_rounds_ms(fn, args.rounds) for name, fn in cases.items() if keep(name)}
        profile = {name: rows for name, rows in profiles(gen).items() if keep(name)}
        host = host_cases(gen) if args.only is None else {}
    serving = {}
    if args.only is None:
        with torch.inference_mode():
            serving = serve_cases(repo, gen)
    print(json.dumps({
        "label": args.label or str(repo), "card": card_line(),
        "ms": {name: statistics.median(t) for name, t in times.items()},
        "profiles": profile, "serve": serving, "host_us": host,
        "rounds_ms": times,
        "ptxas": ptxas_usage(repo, None if args.only is None else ("gnn_layer_int8", "sinkhorn")),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
