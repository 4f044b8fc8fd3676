"""The port's CUDA kernels (the eval layer for softmax, for the feature kinds
and in int8, the Sinkhorn forward and adjoint, the message forward and
backward, the attention forward and backward on heads, with and without the
LSE's cotangent, the train-mode layer half, the dense GEMMs of the layer
kernels on their own, and the Hopper (wgmma and TMA) bf16 GEMM at each of
its tiles and bf16 attention at each of its instances) against their plain PyTorch
versions on a card, and the ring schedule's block merge against attention over
the whole key set.

This file imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda

Without a card every test skips (the decision is made inside each test).
"""

import pytest
import torch

from openglue_tpu_torch.ops.attention import sample_orthogonal_random_matrix
from openglue_tpu_torch.ops.kernels import attention_kernel as ak
from openglue_tpu_torch.ops.kernels import gemm_kernel as gk
from openglue_tpu_torch.ops.kernels import gnn_layer_int8 as gli8
from openglue_tpu_torch.ops.kernels import gnn_layer_kernel as glk
from openglue_tpu_torch.ops.kernels import sinkhorn_kernel as sk
from openglue_tpu_torch.parallel import ring


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _layer_case(dev, dtype, counts=(200, 0), dim=256, seed=1):
    """Weights, x_q [2, 300, D], x_kv [2, 257, D] and a key mask of ``counts``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    d2 = 2 * dim

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    w = glk.PropagationWeights(
        r(dim, dim, scale=dim**-0.5).to(dtype), r(dim), r(dim, dim, scale=dim**-0.5).to(dtype), r(dim),
        r(dim, dim, scale=dim**-0.5).to(dtype), r(dim), r(dim, dim, scale=dim**-0.5).to(dtype), r(dim),
        r(d2, d2, scale=d2**-0.5).to(dtype), r(d2), 1.0 + 0.1 * r(d2), 0.1 * r(d2),
        r(dim, d2, scale=d2**-0.5).to(dtype), r(dim),
    )
    x_q = r(2, 300, dim).to(dtype)
    x_kv = r(2, 257, dim).to(dtype)
    mask = torch.arange(257, device=dev)[None] < torch.tensor(counts, device=dev)[:, None]
    return w, x_q, x_kv, mask


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("use_offset", [False, True])
def test_layer_kernel_matches_plain(dtype, use_offset):
    dev = _cuda()
    w, x_q, x_kv, mask = _layer_case(dev, dtype)
    before = glk.counter.count
    with torch.no_grad():
        out = glk.fused_attention_propagation(x_q, x_kv, mask, w, 4, use_offset)
        ref = glk.layer_plain(x_q, x_kv, mask, w, 4, use_offset)
    torch.cuda.synchronize()
    assert glk.counter.count == before + 1
    # f32: summation order only; bf16: two ulps of the largest output
    # (rounding flips from the online softmax and the accumulation order)
    atol = 1e-4 if dtype == torch.float32 else 2.0**-7 * ref.float().abs().max().item()
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)


def _projection(dev, kind, num_features=128):
    if kind == "linear":
        return None
    return sample_orthogonal_random_matrix(torch.Generator().manual_seed(7), num_features, 64, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,num_features,use_offset", [
    ("linear", 64, False), ("favor_relu", 128, True), ("favor_softmax", 128, False),
    ("favor_softmax", 48, True), ("favor_softmax", 16, False), ("favor_relu", 256, False),
])
def test_feature_layer_kernel_matches_plain(dtype, kind, num_features, use_offset):
    dev = _cuda()
    w, x_q, x_kv, mask = _layer_case(dev, dtype, counts=(200, 257))
    proj = _projection(dev, kind, num_features)
    before = glk.feature_counter.count, glk.counter.count
    with torch.no_grad():
        out = glk.fused_attention_propagation(x_q, x_kv, mask, w, 4, use_offset, kind, proj)
        again = glk.fused_attention_propagation(x_q, x_kv, mask, w, 4, use_offset, kind, proj)
        ref = glk.layer_plain(x_q, x_kv, mask, w, 4, use_offset, kind, proj)
    torch.cuda.synchronize()
    assert (glk.feature_counter.count, glk.counter.count) == (before[0] + 2, before[1])
    assert torch.equal(out, again)  # a fixed summation order: equal bits on two runs
    # f32: summation order only; bf16: two ulps of the largest output
    # (rounding flips of q, v, the features and the aggregate's operands)
    atol = 1e-4 if dtype == torch.float32 else 2.0**-7 * ref.float().abs().max().item()
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["linear", "favor_relu", "favor_softmax"])
def test_feature_layer_kernel_fully_masked_element_is_nan(kind):
    dev = _cuda()
    w, x_q, x_kv, mask = _layer_case(dev, torch.float32, counts=(257, 0))
    with torch.no_grad():
        out = glk.fused_attention_propagation(x_q, x_kv, mask, w, 4, False, kind, _projection(dev, kind))
    assert torch.isfinite(out[0]).all() and torch.isnan(out[1]).all()


def _feature_case(dev, dtype, batch, n, m, dim, counts, seed=3):
    """Weights, x_q [batch, n, D], x_kv [batch, m, D] and a key mask of ``counts``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    d2 = 2 * dim

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    w = glk.PropagationWeights(
        r(dim, dim, scale=dim**-0.5).to(dtype), r(dim), r(dim, dim, scale=dim**-0.5).to(dtype), r(dim),
        r(dim, dim, scale=dim**-0.5).to(dtype), r(dim), r(dim, dim, scale=dim**-0.5).to(dtype), r(dim),
        r(d2, d2, scale=d2**-0.5).to(dtype), r(d2), 1.0 + 0.1 * r(d2), 0.1 * r(d2),
        r(dim, d2, scale=d2**-0.5).to(dtype), r(dim),
    )
    mask = torch.arange(m, device=dev)[None] < torch.tensor(counts, device=dev)[:, None]
    return w, r(batch, n, dim).to(dtype), r(batch, m, dim).to(dtype), mask


def _feature_atol(dtype, ref):
    # f32: summation order only; bf16: two ulps of the largest output
    # (rounding flips of q, v, the features and the aggregate's operands)
    return 1e-4 if dtype == torch.float32 else 2.0**-7 * ref.float().abs().max().item()


# (kind, head width, F, batch, N, M, valid counts): every head width, F from 16
# to 256, one key, a ragged 700, 1024 and 2048 keys, N != M, and an element
# with no valid key beside one with all of them
FEATURE_SHAPES = [
    ("linear", 64, 64, 2, 300, 1024, (1024, 517)),
    ("linear", 32, 32, 2, 1024, 700, (700, 0)),
    ("favor_relu", 64, 128, 2, 1024, 2048, (2048, 1300)),
    ("favor_relu", 32, 16, 1, 700, 1, (1,)),
    ("favor_relu", 64, 256, 2, 128, 700, (350, 700)),
    ("favor_softmax", 64, 128, 2, 1024, 1024, (1024, 301)),
    ("favor_softmax", 32, 64, 3, 2048, 700, (700, 0, 64)),
    ("favor_softmax", 64, 16, 1, 1, 1024, (1000,)),
    ("favor_softmax", 32, 256, 2, 300, 2048, (2048, 1)),
    ("favor_relu", 32, 48, 2, 333, 1025, (1025, 64)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,dh,num_features,batch,n,m,counts", FEATURE_SHAPES)
def test_feature_layer_kernel_matches_plain_at_every_shape(dtype, kind, dh, num_features, batch, n, m, counts):
    """K6 against its plain version at the shapes its plan branches on, two
    runs bit-equal, an element with no valid key NaN, the others finite."""
    _check_feature_layer(_cuda(), dtype, kind, dh, num_features, batch, n, m, counts)


def _check_feature_layer(dev, dtype, kind, dh, num_features, batch, n, m, counts):
    w, x_q, x_kv, mask = _feature_case(dev, dtype, batch, n, m, 4 * dh, counts)
    proj = None
    if kind != "linear":
        proj = sample_orthogonal_random_matrix(torch.Generator().manual_seed(7), num_features, dh, device=dev)
    with torch.no_grad():
        out = glk.fused_attention_propagation(x_q, x_kv, mask, w, 4, True, kind, proj)
        again = glk.fused_attention_propagation(x_q, x_kv, mask, w, 4, True, kind, proj)
        ref = glk.layer_plain(x_q, x_kv, mask, w, 4, True, kind, proj)
    torch.cuda.synchronize()
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(out.view(bits), again.view(bits))  # a fixed summation order: equal bits, NaN included
    dead = torch.tensor([c == 0 for c in counts], device=dev)
    assert out[dead].isnan().all() and ref[dead].isnan().all()
    live, live_ref = out[~dead].float(), ref[~dead].float()
    assert torch.isfinite(live).all()
    torch.testing.assert_close(live, live_ref, atol=_feature_atol(dtype, live_ref), rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,num_features", [(torch.bfloat16, 256), (torch.float32, 128)])
def test_favor_softmax_stages_its_keys_again_where_they_do_not_stay(dtype, num_features):
    """FAVOR-softmax at B=16 N=M=1024 with heads of width 64 where a CTA has
    no room to keep its keys from the first sweep (bf16 F=256, f32 F=128):
    the second sweep stages and converts them again. Against the plain
    version, two runs bit-equal, a fully masked element NaN."""
    dev = _cuda()
    plan, sms = glk.kernel_feature_plan(16, 4, 1024, 1024, num_features, 64, dtype == torch.bfloat16, "favor_softmax")
    assert plan.resident == 0
    assert plan == glk.feature_plan(16, 4, 1024, 1024, num_features, 64, dtype == torch.bfloat16, "favor_softmax", sms)
    counts = (1024, 0, 1, 64, 65, 300, 511, 512, 513, 700, 777, 900, 1000, 1023, 1024, 128)
    _check_feature_layer(dev, dtype, "favor_softmax", 64, num_features, 16, 1024, 1024, counts)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_favor_softmax_key_stabilizer_ignores_masked_keys(dtype):
    """The largest ph of the key set sits on masked keys (their x_kv scaled
    by 8): the stabilizer is the max over the valid keys only, and a wrong
    one would drown every valid key's exp under the 1e-8 eps."""
    dev = _cuda()
    dh, num_features, m = 64, 128, 700
    w, x_q, x_kv, mask = _feature_case(dev, dtype, 2, 500, m, 4 * dh, (400, 650))
    x_kv = torch.where(mask[..., None], x_kv, 8 * x_kv).contiguous()
    proj = sample_orthogonal_random_matrix(torch.Generator().manual_seed(7), num_features, dh, device=dev)
    k = glk._dense_f32(x_kv, w.wk, w.bk).view(2, m, 4, dh).transpose(1, 2)
    ph = torch.matmul((k * dh**-0.25).to(dtype).float(), proj.to(dtype).float().t()).amax(-1)  # [B, H, M]
    valid = mask[:, None, :]
    assert (ph.masked_fill(valid, -1e9).amax(-1) > ph.masked_fill(~valid, -1e9).amax(-1) + 20).all()
    with torch.no_grad():
        out = glk.fused_attention_propagation(x_q, x_kv, mask, w, 4, False, "favor_softmax", proj)
        ref = glk.layer_plain(x_q, x_kv, mask, w, 4, False, "favor_softmax", proj)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), atol=_feature_atol(dtype, ref), rtol=0)


@pytest.mark.cuda
def test_feature_kernel_plan_matches_its_python_mirror():
    """The C plan of K6's attention part (og_gnn_layer_features_plan) equals
    glk.feature_plan at the serving shapes and at the card tests' shapes."""
    _cuda()
    shapes = [(16, 4, 1024, 1024, 128, 64), (16, 4, 1024, 1024, 64, 64), (1, 4, 1024, 700, 128, 64),
              (4, 4, 2048, 2048, 64, 32), (1, 4, 4352, 4352, 128, 64), (2, 4, 300, 1024, 256, 64),
              (1, 4, 700, 1, 16, 32), (3, 4, 2048, 700, 64, 32)]
    for batch, heads, n, m, num_features, dh in shapes:
        for is_bf16 in (True, False):
            for kind in glk.FEATURE_KINDS:
                f = dh if kind == "linear" else num_features
                plan, sms = glk.kernel_feature_plan(batch, heads, n, m, f, dh, is_bf16, kind)
                assert plan == glk.feature_plan(batch, heads, n, m, f, dh, is_bf16, kind, sms), (
                    batch, heads, n, m, f, dh, is_bf16, kind)


@pytest.mark.cuda
def test_new_layer_kernels_take_no_mask_and_two_heads():
    """kv_mask=None, D=128 (two heads), one batch element, short unaligned sets."""
    dev = _cuda()
    w, x_q, x_kv, _ = _layer_case(dev, torch.float32, dim=128)
    x_q, x_kv = x_q[:1, :70].contiguous(), x_kv[:1, :33].contiguous()
    for kind in ("linear", "favor_softmax"):
        proj = _projection(dev, kind, 64)
        with torch.no_grad():
            out = glk.fused_attention_propagation(x_q, x_kv, None, w, 2, False, kind, proj)
            ref = glk.layer_plain(x_q, x_kv, None, w, 2, False, kind, proj)
        torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
    qw = gli8.quantize_propagation_weights(w)
    for quant_attention in (False, True):
        with torch.no_grad():
            out = gli8.fused_attention_propagation_int8(x_q, x_kv, None, qw, 2, quant_attention=quant_attention)
            ref = gli8.layer_int8_plain(x_q, x_kv, None, qw, 2, quant_attention=quant_attention)
        rel = ((out - ref).norm() / ref.norm()).item()
        assert rel < (1e-3 if quant_attention else 0.015), rel


MODES = {"int8": (False, False), "int8_static": (True, False), "int8_attn": (False, True),
         "int8_static_attn": (True, True)}


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("use_offset", [False, True])
def test_int8_layer_kernel_matches_plain(x_dtype, mode, use_offset):
    dev = _cuda()
    static, quant_attention = MODES[mode]
    w, x_q, x_kv, mask = _layer_case(dev, torch.float32, counts=(200, 0))
    x_q, x_kv = x_q.to(x_dtype), x_kv.to(x_dtype)
    qw = gli8.quantize_propagation_weights(w)
    scales = None
    if static:
        absmax = gli8.reference_activation_absmax(x_q, x_kv, mask, qw, 4, use_offset, quant_attention)
        scales = absmax * (1.1 / 127.0) + 1e-12
    kwargs = dict(act_scales=scales, quant_attention=quant_attention)
    before = gli8.counter.count
    with torch.no_grad():
        out = gli8.fused_attention_propagation_int8(x_q, x_kv, mask, qw, 4, use_offset, **kwargs)
        again = gli8.fused_attention_propagation_int8(x_q, x_kv, mask, qw, 4, use_offset, **kwargs)
        ref = gli8.layer_int8_plain(x_q, x_kv, mask, qw, 4, use_offset, **kwargs)
    torch.cuda.synchronize()
    assert gli8.counter.count == before + 2 and out.dtype == x_dtype
    assert torch.equal(out, again)
    # the integer products and their dequantization are exact; what differs is
    # the attention's f32 summation order (and bf16 rounding flips of P),
    # which flips single int8 roundings downstream: compared in norm, with
    # the JAX package's bar between its kernel and its oracle as the ceiling.
    # With int8 attention only the softmax denominator's summation order is
    # left, and most entries have equal bits (an H100 read 96.7% at the least;
    # one flipped int8 value changes its whole row downstream)
    rel = ((out.float() - ref.float()).norm() / ref.float().norm()).item()
    assert rel < (1e-3 if quant_attention else 0.015), rel
    if quant_attention:
        assert (out == ref).float().mean().item() > 0.9
    # most entries see no flip at all
    close = (out.float() - ref.float()).abs() <= 2.0**-7 * ref.float().abs().max()
    assert close.float().mean().item() > 0.99


@pytest.mark.cuda
def test_int8_layer_kernel_refuses_what_it_does_not_take():
    dev = _cuda()
    w, x_q, x_kv, mask = _layer_case(dev, torch.float32)
    qw = gli8.quantize_propagation_weights(w)
    with pytest.raises(ValueError, match="bf16 or int8"):
        gli8.fused_attention_propagation_int8(x_q, x_kv, mask, qw, 4, attn_dtype=torch.float32)
    with pytest.raises(ValueError, match="8 calibrated activation sites"):
        gli8.fused_attention_propagation_int8(
            x_q, x_kv, mask, qw, 4, act_scales=torch.full((5,), 0.05, device=dev), quant_attention=True)


@pytest.mark.cuda
@pytest.mark.parametrize("k_dtype", [torch.float32, torch.bfloat16])
def test_sinkhorn_kernel_matches_plain(k_dtype):
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(0)
    batch, m, n = 3, 300, 277
    scores = torch.randn(batch, m, n, generator=gen, device=dev) * 3
    mask0 = torch.rand(batch, m, generator=gen, device=dev) > 0.2
    mask1 = torch.rand(batch, n, generator=gen, device=dev) > 0.2
    rows, cp = m + 1, sk._round_up(n + 1, sk.COL_ALIGN)
    dust = torch.tensor(1.0, device=dev)
    M_pad = sk.build_padded_otp_matrix(scores, dust, 1.0, mask0, mask1, rows, cp)
    la, lb, _ = sk.otp_marginals(batch, m, n, mask0, mask1, dev)
    la, lb = sk.padded_marginals(la, lb, rows, cp)
    before = sk.counter.count
    u = sk.sinkhorn_scale(M_pad, la, lb, 20, k_dtype)
    assert sk.counter.count == before + 1
    ref = sk.sinkhorn_scale_plain(M_pad, la, lb, 20, k_dtype)
    torch.cuda.synchronize()
    live = la > -1e8  # masked rows sit near -1e9, where one f32 ulp is 64
    # the same f32 recursion and storage rounding; summation order differs
    torch.testing.assert_close(u[live], ref[live], atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_kernels_raise_instead_of_falling_back():
    dev = _cuda()
    M_pad = torch.zeros(1, 9, 12, device=dev)  # 12 columns: not a multiple of 8
    la, lb = torch.zeros(1, 9, device=dev), torch.zeros(1, 12, device=dev)
    with pytest.raises(ValueError):
        sk.sinkhorn_scale(M_pad, la, lb, 3, torch.float32)


def _message_case(dev, dtype, batch=2, n=300, m=257, dim=256, counts=(200, 0), seed=2):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    w = glk.MessageWeights(*[r(dim, dim, scale=dim**-0.5) if i % 2 == 0 else r(dim) for i in range(8)])
    x_q, x_kv = r(batch, n, dim).to(dtype), r(batch, m, dim).to(dtype)
    mask = torch.arange(m, device=dev)[None] < torch.tensor(counts, device=dev)[:, None]
    g = r(batch, n, dim).to(dtype)
    return x_q, x_kv, mask, w, g


def _close(got, ref, dtype, what, scale=None, f32_tol=1e-5):
    """f32: summation order only, ``f32_tol`` of the largest entry; bf16:
    single rounding flips carried by the products, 2^-6 of the largest
    entry."""
    ref, got = ref.float(), got.float()
    scale = max(ref.abs().max().item(), scale or 0.0)
    atol = (f32_tol if dtype == torch.float32 else 2.0**-6) * scale + 1e-6
    torch.testing.assert_close(got, ref, atol=atol, rtol=0, msg=lambda m: f"{what}: {m}")


# f32 gradients, kernel against the plain version on the card: summation
# order only, 1e-5 of the largest entry
GRAD_F32_TOL = 1e-5
# f32 gradients, the card against the plain version on the CPU, whose
# matmuls sum in another order: an H100 measured 1.12e-5 of the largest dWq
# entry (the sums over rows cancel through dS = P o (dP - rowsum(dP o P)));
# the bar is about 4x that
CPU_F32_TOL = 5e-5


def _close_weight_grads(got, ref, dtype, f32_tol=GRAD_F32_TOL):
    """Weight and bias gradients in MessageWeights order. A bias gradient sums
    the same rows as its weight's, and dbk is zero up to cancellation (the
    softmax ignores a shift of the logits), so a bias is held at its
    weight's scale."""
    for i, name in enumerate(glk.MessageWeights._fields):
        assert got[i].dtype == torch.float32
        pair = ref[i - 1].abs().max().item() if i % 2 else None
        _close(got[i], ref[i], dtype, name, scale=pair, f32_tol=f32_tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dim", [128, 256])
def test_message_kernels_match_plain(dtype, dim):
    dev = _cuda()
    x_q, x_kv, mask, w, g = _message_case(dev, dtype, dim=dim)
    heads = dim // 64
    before = glk.message_counter.count, glk.message_bwd_counter.count
    out = glk.message_forward(x_q, x_kv, mask, w, heads, dtype)
    ref = glk.message_forward_plain(x_q, x_kv, mask, w, heads, dtype)
    grads = glk.message_backward(x_q, x_kv, mask, w, g, out[1], out[2], heads, dtype)
    ref_grads = glk.message_backward_plain(x_q, x_kv, mask, w, g, ref[1], ref[2], heads, dtype)
    torch.cuda.synchronize()
    assert (glk.message_counter.count, glk.message_bwd_counter.count) == (before[0] + 1, before[1] + 1)
    for name, a, b in zip(("msg", "attn", "lse"), out, ref):
        _close(a, b, dtype, name)
    for name, a, b in zip(("dx_q", "dx_kv"), grads[:2], ref_grads[:2]):
        assert a.dtype == dtype
        _close(a, b, dtype, name, f32_tol=GRAD_F32_TOL)
    _close_weight_grads(grads[2], ref_grads[2], dtype)


@pytest.mark.cuda
def test_message_kernels_are_deterministic():
    dev = _cuda()
    x_q, x_kv, mask, w, g = _message_case(dev, torch.bfloat16, counts=(257, 120))
    out = glk.message_forward(x_q, x_kv, mask, w, 4, torch.bfloat16)
    first = glk.message_backward(x_q, x_kv, mask, w, g, out[1], out[2], 4, torch.bfloat16)
    again = glk.message_backward(x_q, x_kv, mask, w, g, out[1], out[2], 4, torch.bfloat16)
    for a, b in zip([*first[:2], *first[2]], [*again[:2], *again[2]]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_fused_attention_message_autograd_on_card():
    """Self attention through the autograd Function: both input gradients are
    returned and added."""
    dev = _cuda()
    x, _, mask, w, _ = _message_case(dev, torch.float32, n=130, m=130, dim=128, counts=(130, 90))
    params = [t.clone().requires_grad_() for t in w]
    xs = x.clone().requires_grad_()
    glk.fused_attention_message(xs, xs, mask, glk.MessageWeights(*params), 2).square().sum().backward()
    xc, pc = x.cpu().requires_grad_(), [t.detach().cpu().requires_grad_() for t in w]
    glk.fused_attention_message(xc, xc, mask.cpu(), glk.MessageWeights(*pc), 2).square().sum().backward()
    _close(xs.grad.cpu(), xc.grad, torch.float32, "dx", f32_tol=CPU_F32_TOL)
    _close_weight_grads([p.grad.cpu() for p in params], [p.grad for p in pc], torch.float32, CPU_F32_TOL)


@pytest.mark.cuda
def test_sinkhorn_adjoint_kernel_matches_plain():
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(3)
    batch, m, n, iters = 3, 300, 277, 20
    scores = torch.randn(batch, m, n, generator=gen, device=dev) * 3
    mask0 = torch.rand(batch, m, generator=gen, device=dev) > 0.2
    mask1 = torch.rand(batch, n, generator=gen, device=dev) > 0.2
    rows, cp = m + 1, sk._round_up(n + 1, sk.COL_ALIGN)
    M_pad = sk.build_padded_otp_matrix(scores, torch.tensor(1.0, device=dev), 1.0, mask0, mask1, rows, cp)
    la, lb, _ = sk.otp_marginals(batch, m, n, mask0, mask1, dev)
    la, lb = sk.padded_marginals(la, lb, rows, cp)
    g_pad = torch.zeros(batch, rows, cp, device=dev)
    g_pad[:, :, : n + 1] = torch.randn(batch, rows, n + 1, generator=gen, device=dev) * sk.valid_pairs(
        batch, m, n, mask0, mask1, dev)
    rmax = M_pad.amax(dim=2)
    args = (M_pad, la, lb, rmax, g_pad.sum(2), g_pad.sum(1), iters)
    before = sk.adjoint_counter.count
    P, Q = sk.sinkhorn_adjoint(*args)
    assert sk.adjoint_counter.count == before + 1
    P_ref, Q_ref = sk.sinkhorn_adjoint_plain(*args)
    torch.cuda.synchronize()
    # the same f32 recursion; matvec summation order differs. Compare the
    # factors' product on the live entries, which is what the gradient uses
    live = sk.valid_pairs(batch, m, n, mask0, mask1, dev)
    prod = torch.bmm(P.transpose(1, 2), Q)[:, :, : n + 1]
    prod_ref = torch.bmm(P_ref.transpose(1, 2), Q_ref)[:, :, : n + 1]
    scale = prod_ref[live].abs().max().item()
    torch.testing.assert_close(prod[live], prod_ref[live], atol=1e-4 * scale, rtol=0)


@pytest.mark.cuda
def test_sinkhorn_gradient_through_kernels_matches_plain():
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(4)
    scores = (torch.randn(2, 200, 180, generator=gen, device=dev) * 2).requires_grad_()
    dust = torch.tensor(0.7, device=dev, requires_grad=True)
    mask0 = torch.arange(200, device=dev)[None] < torch.tensor([200, 150], device=dev)[:, None]
    mask1 = torch.arange(180, device=dev)[None] < torch.tensor([100, 180], device=dev)[:, None]
    valid = sk.valid_pairs(2, 200, 180, mask0, mask1, dev)
    before = sk.counter.count, sk.adjoint_counter.count
    out = sk.log_optimal_transport(scores, dust, 20, mask0=mask0, mask1=mask1)
    torch.where(valid, out, 0.0).square().sum().backward()
    assert (sk.counter.count, sk.adjoint_counter.count) == (before[0] + 1, before[1] + 1)
    dref, ddref = sk.log_optimal_transport_vjp(
        scores.detach().cpu(), dust.detach().cpu(), torch.where(valid, 2 * out, 0.0).detach().cpu(),
        20, 1.0, mask0.cpu(), mask1.cpu())
    scale = dref.abs().max().item()
    torch.testing.assert_close(scores.grad.cpu(), dref, atol=1e-4 * scale, rtol=0)
    torch.testing.assert_close(dust.grad.cpu(), ddref, atol=1e-4 * abs(ddref.item()), rtol=0)


@pytest.mark.cuda
def test_adjoint_kernel_raises_beyond_its_column_limit():
    dev = _cuda()
    rows, cols = 9, sk.ADJOINT_MAX_COLS + 8
    M_pad = torch.zeros(1, rows, cols, device=dev)
    vec_r, vec_c = torch.zeros(1, rows, device=dev), torch.zeros(1, cols, device=dev)
    with pytest.raises(ValueError, match="at most"):
        sk.sinkhorn_adjoint(M_pad, vec_r, vec_c, vec_r, vec_r, vec_c, 3)


# ----------------------------------------------------------- the on-chip Sinkhorn at every branch of its plan


def _ot_case(dev, batch, m, n, seed, masked=()):
    """Padded M, la, lb and the masks of a random OT problem; the elements in
    ``masked`` have every keypoint masked."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    scores = torch.randn(batch, m, n, generator=gen, device=dev) * 3
    mask0 = torch.rand(batch, m, generator=gen, device=dev) > 0.2
    mask1 = torch.rand(batch, n, generator=gen, device=dev) > 0.2
    for b in masked:
        mask0[b] = False
        mask1[b] = False
    rows, cp = m + 1, sk._round_up(n + 1, sk.COL_ALIGN)
    M_pad = sk.build_padded_otp_matrix(scores, torch.tensor(1.0, device=dev), 1.0, mask0, mask1, rows, cp)
    la, lb, _ = sk.otp_marginals(batch, m, n, mask0, mask1, dev)
    la, lb = sk.padded_marginals(la, lb, rows, cp)
    return M_pad, la, lb, mask0, mask1


# (batch, m, n, K's storage, masked elements): an element over several
# clusters; more than one wave; fewer rows than CTAs; a stripe at a CTA's
# shared-memory budget and one row past it; a fully masked element; bf16 K at
# the fused kernel's 4096 columns
PLAN_SHAPES = [
    (1, 2048, 2048, torch.bfloat16, ()),
    (20, 1024, 1024, torch.float32, ()),
    (1, 8, 300, torch.float32, ()),
    (2, 863, 1031, torch.float32, ()),
    (2, 864, 1031, torch.float32, ()),
    (3, 300, 277, torch.float32, (1,)),
    (1, 1023, 4095, torch.bfloat16, ()),
]


@pytest.mark.cuda
@pytest.mark.parametrize("batch,m,n,k_dtype,masked", PLAN_SHAPES)
def test_on_chip_sinkhorn_matches_plain_at_every_branch_of_its_plan(batch, m, n, k_dtype, masked):
    dev = _cuda()
    M_pad, la, lb, _, _ = _ot_case(dev, batch, m, n, 20, masked)
    plan, caps, sms = sk.kernel_plan(batch, *M_pad.shape[1:], k_dtype)
    assert plan == sk.launch_plan(batch, *M_pad.shape[1:], k_dtype, sms, caps)  # the mirror is the C plan
    assert plan.spill_rows == 0
    before = sk.counter.count
    u = sk.sinkhorn_scale(M_pad, la, lb, 20, k_dtype)
    again = sk.sinkhorn_scale(M_pad, la, lb, 20, k_dtype)
    ref = sk.sinkhorn_scale_plain(M_pad, la, lb, 20, k_dtype)
    torch.cuda.synchronize()
    assert sk.counter.count == before + 2
    assert torch.equal(u, again)  # fixed summation order
    live = la > -1e8
    # the same f32 recursion and storage rounding; summation order differs
    torch.testing.assert_close(u[live], ref[live], atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_on_chip_sinkhorn_spills_rows_past_the_cards_shared_memory():
    """A bf16 K larger than the card's shared memory (one element of 4000 x
    4096, 32.8 MB): the rows past each CTA's shared memory go to the
    workspace, and the result still matches the plain version, bit-equal
    across runs."""
    dev = _cuda()
    M_pad, la, lb, _, _ = _ot_case(dev, 1, 3999, 4095, 24)
    plan, caps, sms = sk.kernel_plan(1, *M_pad.shape[1:], torch.bfloat16)
    assert plan == sk.launch_plan(1, *M_pad.shape[1:], torch.bfloat16, sms, caps)
    assert plan.spill_rows > 0
    u = sk.sinkhorn_scale(M_pad, la, lb, 20, torch.bfloat16)
    again = sk.sinkhorn_scale(M_pad, la, lb, 20, torch.bfloat16)
    ref = sk.sinkhorn_scale_plain(M_pad, la, lb, 20, torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(u, again)
    live = la > -1e8
    torch.testing.assert_close(u[live], ref[live], atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,m,n,masked", [
    (1, 1536, 1535, ()),  # an element over several clusters
    (20, 1024, 1024, ()),  # more than one wave
    (1, 8, 300, ()),  # fewer rows than CTAs
    (2, 864, 1031, ()),  # one row past a CTA's shared-memory budget
    (3, 300, 277, (1,)),  # a fully masked element
])
def test_on_chip_sinkhorn_adjoint_matches_plain_at_every_branch_of_its_plan(batch, m, n, masked):
    dev = _cuda()
    M_pad, la, lb, mask0, mask1 = _ot_case(dev, batch, m, n, 21, masked)
    plan, caps, sms = sk.kernel_plan(batch, *M_pad.shape[1:], torch.float32, adjoint=True)
    assert plan == sk.launch_plan(batch, *M_pad.shape[1:], torch.float32, sms, caps)
    gen = torch.Generator(device=dev).manual_seed(22)
    valid = sk.valid_pairs(batch, m, n, mask0, mask1, dev)
    g_pad = torch.zeros_like(M_pad)
    g_pad[:, :, : n + 1] = torch.randn(batch, m + 1, n + 1, generator=gen, device=dev) * valid
    args = (M_pad, la, lb, M_pad.amax(dim=2), g_pad.sum(2), g_pad.sum(1), 20)
    (P, Q), (P2, Q2) = sk.sinkhorn_adjoint(*args), sk.sinkhorn_adjoint(*args)
    P_ref, Q_ref = sk.sinkhorn_adjoint_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(P, P2) and torch.equal(Q, Q2)
    prod = torch.bmm(P.transpose(1, 2), Q)[:, :, : n + 1]
    prod_ref = torch.bmm(P_ref.transpose(1, 2), Q_ref)[:, :, : n + 1]
    scale = max(prod_ref[valid].abs().max().item(), 1e-30)
    torch.testing.assert_close(prod[valid], prod_ref[valid], atol=1e-4 * scale, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("k_dtype,batch,n", [(torch.float32, 16, 1024), (torch.bfloat16, 4, 2048)])
def test_fused_sinkhorn_keeps_k_off_device_memory(k_dtype, batch, n):
    """The fused forward allocates no [B, R, C] K: its peak allocation stays
    under half of K's bytes."""
    dev = _cuda()
    M_pad, la, lb, _, _ = _ot_case(dev, batch, n, n, 23)
    sk.sinkhorn_scale(M_pad, la, lb, 20, k_dtype)  # builds and plans outside the window
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    sk.sinkhorn_scale(M_pad, la, lb, 20, k_dtype)
    torch.cuda.synchronize()
    k_bytes = M_pad.numel() * torch.empty(0, dtype=k_dtype).element_size()
    assert torch.cuda.max_memory_allocated() - base < k_bytes // 2


# ----------------------------------------------------------- attention on heads


def _attention_case(dev, dtype, batch=3, heads=2, n=300, m=257, counts=(200, 0, 257), seed=5, layout="columns",
                    dh=64):
    """q, g [B, H, N, dh], k, v [B, H, M, dh] and a key mask of ``counts`` (its
    second element masks every key). ``layout``: "columns" views [B, L, H*dh]
    buffers as the multi-head attention does; "heads" is contiguous."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def r(length):
        if layout == "heads":
            return torch.randn(batch, heads, length, dh, generator=gen, device=dev).to(dtype)
        x = torch.randn(batch, length, heads * dh, generator=gen, device=dev).to(dtype)
        return x.view(batch, length, heads, dh).transpose(1, 2)

    q, k, v, g = r(n), r(m), r(m), r(n)
    mask = torch.arange(m, device=dev)[None] < torch.tensor(counts, device=dev)[:, None]
    return q, k, v, g, mask


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["columns", "heads"])
def test_attention_kernels_match_plain(dtype, layout):
    dev = _cuda()
    q, k, v, g, mask = _attention_case(dev, dtype, layout=layout)
    before = ak.counter.count, ak.backward_counter.count
    out, lse = ak.attention_forward(q, k, v, mask)
    ref, ref_lse = ak.attention_forward_plain(q, k, v, mask)
    grads = ak.attention_backward(q, k, v, mask, g, out, lse)
    ref_grads = ak.attention_backward_plain(q, k, v, mask, g)
    torch.cuda.synchronize()
    assert (ak.counter.count, ak.backward_counter.count) == (before[0] + 1, before[1] + 1)
    assert not q.is_contiguous() or layout == "heads"  # read where they lie, no copy
    _close(out, ref, dtype, "out")
    live = mask.any(dim=1)  # with no valid key the LSE sits at -1e9, where one f32 ulp is 64
    _close(lse[live], ref_lse[live], dtype, "lse")
    # the fully masked element is the uniform average over its M keys
    _close(out[1], v[1].float().mean(dim=1, keepdim=True).expand_as(out[1]), dtype, "uniform average")
    for name, a, b in zip(("dq", "dk", "dv"), grads, ref_grads):
        assert a.dtype == dtype and a.shape == b.shape
        _close(a, b, dtype, name, f32_tol=GRAD_F32_TOL)
        _close(a[1], b[1], dtype, name + " (fully masked element)", f32_tol=GRAD_F32_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_backward_kernel_is_deterministic_and_takes_any_size(dtype):
    """Equal bits on two runs, no mask, and N = M = 2048 (a graph the TPU
    backward kernel sends elsewhere)."""
    dev = _cuda()
    q, k, v, g, _ = _attention_case(dev, dtype, batch=1, heads=2, n=2048, m=2048, counts=(2048,))
    out, lse = ak.attention_forward(q, k, v, None)
    first = ak.attention_backward(q, k, v, None, g, out, lse)
    again = ak.attention_backward(q, k, v, None, g, out, lse)
    ref = ak.attention_backward_plain(q, k, v, None, g)
    for name, a, b, c in zip(("dq", "dk", "dv"), first, again, ref):
        assert torch.equal(a, b), name
        _close(a, c, dtype, name, f32_tol=GRAD_F32_TOL)


@pytest.mark.cuda
def test_masked_softmax_attention_autograd_on_card():
    """The autograd Function on the card against the CPU's autograd, through
    the projections' transposed views as the multi-head attention makes
    them."""
    dev = _cuda()
    q, k, v, _, mask = _attention_case(dev, torch.float32, n=130, m=90, counts=(90, 0, 40))
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]  # clone keeps the strides
    assert not leaves[0].is_contiguous()
    before = ak.counter.count, ak.backward_counter.count
    ak.masked_softmax_attention(*leaves, mask).square().sum().backward()
    assert (ak.counter.count, ak.backward_counter.count) == (before[0] + 1, before[1] + 1)
    cpu = [t.detach().cpu().requires_grad_() for t in (q, k, v)]
    ak.masked_softmax_attention(*cpu, mask.cpu()).square().sum().backward()
    for name, a, b in zip(("dq", "dk", "dv"), leaves, cpu):
        _close(a.grad.cpu(), b.grad, torch.float32, name, f32_tol=CPU_F32_TOL)
    with torch.no_grad():  # without a gradient no LSE is written and nothing is saved
        out = ak.masked_softmax_attention(q, k, v, mask)
    _close(out.cpu(), ak.attention_forward_plain(*[t.detach() for t in cpu], mask.cpu())[0], torch.float32, "out")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lse_attention_kernel_matches_plain(dtype):
    """K11, the ring's block attention: out and the LSE against the plain
    version, one element with every key masked (the uniform average over its
    M keys, the LSE at -1e9), counted apart from K9."""
    dev = _cuda()
    q, k, v, _, mask = _attention_case(dev, dtype)
    before = ak.lse_counter.count, ak.counter.count
    out, lse = ak.attention_lse_forward(q, k, v, mask)
    ref, ref_lse = ak.attention_forward_plain(q, k, v, mask)
    torch.cuda.synchronize()
    assert (ak.lse_counter.count, ak.counter.count) == (before[0] + 1, before[1])
    _close(out, ref, dtype, "out")
    live = mask.any(dim=1)
    _close(lse[live], ref_lse[live], dtype, "lse")
    assert bool((lse[~live] < -1e8).all())
    _close(out[1], v[1].float().mean(dim=1, keepdim=True).expand_as(out[1]), dtype, "uniform average")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_backward_kernel_with_lse_cotangent_matches_plain(dtype):
    """K10 with g_lse (the backward of K11): dS = P o (dP - rowsum(dP o P) +
    g_lse) against the plain version; the fully masked element takes dq =
    dk = 0 and dv = P^T g."""
    dev = _cuda()
    q, k, v, g, mask = _attention_case(dev, dtype)
    g_lse = torch.randn(q.shape[:3], generator=torch.Generator(device=dev).manual_seed(11), device=dev)
    out, lse = ak.attention_lse_forward(q, k, v, mask)
    before = ak.backward_counter.count
    grads = ak.attention_backward(q, k, v, mask, g, out, lse, g_lse)
    ref = ak.attention_backward_plain(q, k, v, mask, g, g_lse=g_lse)
    torch.cuda.synchronize()
    assert ak.backward_counter.count == before + 1
    for name, a, b in zip(("dq", "dk", "dv"), grads, ref):
        _close(a, b, dtype, name, f32_tol=GRAD_F32_TOL)
    assert not grads[0][1].any() and not grads[1][1].any() and bool(grads[2][1].abs().sum() > 0)
    without = ak.attention_backward(q, k, v, mask, g, out, lse)
    assert not torch.equal(without[0][0], grads[0][0])  # the LSE's cotangent moved dq


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_block_merge_matches_the_whole_key_set(dtype):
    """The ring's arithmetic on one rank: K11 on 4 key blocks merged by
    ``ring.merge_block``, with the final where, against K9 on the whole key
    set (one element has a fully masked block, one no valid key: 0), and its
    gradient (K10 with a non-zero g_lse per block) against K10 on the whole
    set."""
    dev = _cuda()
    q, k, v, g, mask = _attention_case(dev, dtype, n=256, m=256, counts=(150, 0, 256))
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    acc = torch.zeros_like(leaves[0])
    lse_run = torch.full_like(leaves[0][..., 0], float("-inf"))
    for j in range(4):
        keys = slice(64 * j, 64 * (j + 1))
        out_blk, lse_blk = ak.masked_softmax_attention_with_lse(
            leaves[0], leaves[1][:, :, keys], leaves[2][:, :, keys], mask[:, keys])
        acc, lse_run = ring.merge_block(acc, lse_run, out_blk, lse_blk)
    merged = torch.where(lse_run[..., None] < -1e8, 0.0, acc)
    (merged * g.float()).sum().backward()
    out, lse = ak.attention_forward(q, k, v, mask)
    ref = ak.attention_backward(q, k, v, mask, g, out, lse)
    torch.cuda.synchronize()
    live = mask.any(dim=1)
    _close(merged[live], out[live], dtype, "merged out")
    assert not merged[~live].any()
    for name, a, b in zip(("dq", "dk", "dv"), leaves, ref):
        _close(a.grad[live], b[live], dtype, name, f32_tol=GRAD_F32_TOL)
        assert not a.grad[~live].any()


@pytest.mark.cuda
def test_attention_kernel_refuses_what_it_does_not_take():
    dev = _cuda()
    q, k, v, g, mask = _attention_case(dev, torch.float32)
    ak.attention_forward(q[..., :32], k[..., :32], v[..., :32], mask)  # heads of width 32 run
    with pytest.raises(ValueError, match="heads of width 32 or 64, got head_dim 48"):
        ak.attention_forward(q[..., :48], k[..., :48], v[..., :48], mask)
    t = lambda x: x.transpose(2, 3).contiguous().transpose(2, 3)  # the head axis not contiguous
    with pytest.raises(ValueError, match="last axis is contiguous"):
        ak.attention_forward(t(q), k, v, mask)
    out, lse = ak.attention_forward(q, k, v, mask)
    with pytest.raises(ValueError, match="last axis is contiguous"):
        ak.attention_backward(q, t(k), v, mask, g, out, lse)
    odd = torch.empty(3 * 2 * 257 * 64 + 1, device=dev)[1:].view(3, 2, 257, 64)  # 4 bytes off a 16-byte line
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        ak.attention_forward(q, odd, v, mask)
    with pytest.raises(ValueError, match="types differ"):
        ak.attention_forward(q, k.bfloat16(), v, mask)


# ----------------------------------------------------------- train-mode layer half


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("use_offset", [False, True])
def test_train_half_kernel_matches_plain(dtype, use_offset):
    dev = _cuda()
    x_q, x_kv, mask, w, _ = _message_case(dev, dtype)
    gen = torch.Generator(device=dev).manual_seed(9)
    w1 = torch.randn(512, 512, generator=gen, device=dev) * 512**-0.5
    b1 = torch.randn(512, generator=gen, device=dev) * 0.1
    before = glk.half_counter.count
    out = glk.train_half_forward(x_q, x_kv, mask, w, w1, b1, 4, use_offset, dtype)
    ref = glk.train_half_plain(x_q, x_kv, mask, w, w1, b1, 4, use_offset, dtype)
    torch.cuda.synchronize()
    assert glk.half_counter.count == before + 1
    for name, a, b in zip(("z", "attn", "lse"), out, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        _close(a, b, dtype, name)


@pytest.mark.cuda
@pytest.mark.parametrize("use_offset", [False, True])
def test_fused_train_layer_half_autograd_on_card(use_offset):
    """Self attention through the autograd Function on the card (the train-
    half kernel forward, the torch prologue and the message backward kernel)
    against the same Function on the CPU."""
    dev = _cuda()
    x, _, mask, w, _ = _message_case(dev, torch.float32, n=130, m=130, dim=128, counts=(130, 90))
    gen = torch.Generator(device=dev).manual_seed(10)
    w1 = torch.randn(256, 256, generator=gen, device=dev) * 256**-0.5
    b1 = torch.randn(256, generator=gen, device=dev) * 0.1

    def run(device):
        leaves = [t.detach().to(device).clone().requires_grad_() for t in (x, w1, b1, *w)]
        before = glk.half_counter.count, glk.message_bwd_counter.count
        z = glk.fused_train_layer_half(
            leaves[0], leaves[0], mask.to(device), glk.MessageWeights(*leaves[3:]), leaves[1], leaves[2],
            2, use_offset)
        (z * torch.cos(z)).sum().backward()
        launched = glk.half_counter.count - before[0], glk.message_bwd_counter.count - before[1]
        return [t.grad.cpu() for t in leaves], launched

    card, launched = run(dev)
    cpu, none = run("cpu")
    assert launched == (1, 1) and none == (0, 0)
    for name, a, b in zip(("dx", "dw1", "db1"), card[:3], cpu[:3]):
        _close(a, b, torch.float32, name, f32_tol=CPU_F32_TOL)
    _close_weight_grads(card[3:], cpu[3:], torch.float32, CPU_F32_TOL)


# ----------------------------------------------------------- heads of width 32


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_kernels_take_heads_of_width_32(dtype):
    """K1 and the three K6 kinds at D=128 with 4 heads (dh = 32, the SIFT
    feature configurations), at the bars of the D=256 tests."""
    dev = _cuda()
    w, x_q, x_kv, mask = _layer_case(dev, dtype, counts=(200, 257), dim=128)
    atol = lambda ref: 1e-4 if dtype == torch.float32 else 2.0**-7 * ref.float().abs().max().item()
    for kind in ("softmax", *glk.FEATURE_KINDS):
        proj = None
        if kind.startswith("favor"):
            proj = sample_orthogonal_random_matrix(torch.Generator().manual_seed(7), 64, 32, device=dev)
        before = glk.counter.count, glk.feature_counter.count
        with torch.no_grad():
            out = glk.fused_attention_propagation(x_q, x_kv, mask, w, 4, True, kind, proj)
            ref = glk.layer_plain(x_q, x_kv, mask, w, 4, True, kind, proj)
        torch.cuda.synchronize()
        launched = (glk.counter.count - before[0], glk.feature_counter.count - before[1])
        assert launched == ((1, 0) if kind == "softmax" else (0, 1)), kind
        torch.testing.assert_close(out.float(), ref.float(), atol=atol(ref), rtol=0, msg=lambda m: f"{kind}: {m}")


def _int8_case(dev, mode, batch, n, m, dim=256, counts=None, seed=5):
    """K7's arguments at a shape: random weights quantized per channel, bf16
    x, a key mask of valid ``counts`` (default: all keys), and for the static
    modes scales calibrated as chip_smoke.py calibrates them."""
    static, quant_attention = MODES[mode]
    gen = torch.Generator(device=dev).manual_seed(seed)
    w, _, _, _ = _layer_case(dev, torch.float32, dim=dim, seed=seed)
    qw = gli8.quantize_propagation_weights(w)
    x_q = torch.randn(batch, n, dim, generator=gen, device=dev).bfloat16()
    x_kv = torch.randn(batch, m, dim, generator=gen, device=dev).bfloat16()
    counts = torch.tensor(counts if counts is not None else [m] * batch, device=dev)
    mask = torch.arange(m, device=dev)[None] < counts[:, None]
    scales = None
    if static:
        absmax = gli8.reference_activation_absmax(x_q, x_kv, mask, qw, 4, quant_attention=quant_attention)
        scales = absmax * (1.1 / 127.0) + 1e-12
    return (x_q, x_kv, mask, qw, 4), dict(act_scales=scales, quant_attention=quant_attention)


def _int8_agrees(out, ref, quant_attention):
    """test_int8_layer_kernel_matches_plain's bars: the relative norm, and
    most entries within two ulps of the largest output."""
    rel = ((out.float() - ref.float()).norm() / ref.float().norm()).item()
    assert rel < (1e-3 if quant_attention else 0.015), rel
    close = (out.float() - ref.float()).abs() <= 2.0**-7 * ref.float().abs().max()
    assert close.float().mean().item() > 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("batch,n,m,counts", [
    (3, 100, 77, (77, 40, 0)),      # rows not a multiple of 64, M not of 32, one element all masked
    (2, 129, 33, (33, 1)),          # a 64-row tile across two elements, one valid key
    (1, 1024, 1024, None),          # a single pair at the serving length
])
def test_int8_layer_kernel_takes_ragged_shapes(mode, batch, n, m, counts):
    """Row counts that are not a multiple of the 64-row tile, key counts that
    are not a multiple of V^T's 32-key blocks (its padding is written 0), an
    element with every key masked, and B=1 N=M=1024: the kernel against its
    plain version at the D=256 test's bars, two runs bit-equal."""
    dev = _cuda()
    args, kw = _int8_case(dev, mode, batch, n, m, counts=counts)
    with torch.no_grad():
        out = gli8.fused_attention_propagation_int8(*args, **kw)
        again = gli8.fused_attention_propagation_int8(*args, **kw)
        ref = gli8.layer_int8_plain(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert torch.isfinite(out.float()).all()
    _int8_agrees(out, ref, kw["quant_attention"])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("dim", [256, 128])
def test_int8_layer_plan_and_launches_match_the_python_mirror(mode, dim):
    """The C plan and workspace equal their Python mirrors at the serving and
    test shapes; one layer makes the plan's launches (6, or 7 and one memset
    with dynamic int8 attention), counted by the C code."""
    dev = _cuda()
    static, quant_attention = MODES[mode]
    for batch, n, m in ((16, 1024, 1024), (1, 1024, 1024), (3, 100, 77), (4, 2048, 2048), (2, 300, 257)):
        plan, sms = gli8.kernel_int8_plan(batch, n, m, dim, 4, quant_attention, static)
        assert plan == gli8.int8_plan(batch, n, m, dim, 4, quant_attention, static, sms), (batch, n, m)
        assert max(plan[6:]) <= gli8.SMEM_CAP
        size = gli8.kernel_workspace_bytes(batch, n, m, dim, 4, quant_attention, static)
        assert size == gli8.workspace_bytes(batch, n, m, dim, quant_attention, static), (batch, n, m)
    args, kw = _int8_case(dev, mode, 2, 300, 257, dim=dim)
    with torch.no_grad():
        gli8.fused_attention_propagation_int8(*args, **kw)  # built and warm
        torch.cuda.synchronize()
        gli8.launch_counter.reset()
        gli8.memset_counter.reset()
        gli8.fused_attention_propagation_int8(*args, **kw)
    torch.cuda.synchronize()
    plan, _ = gli8.kernel_int8_plan(2, 300, 257, dim, 4, quant_attention, static)
    assert (gli8.launch_counter.count, gli8.memset_counter.count) == (plan.launches, plan.memsets)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [64, 128])
@pytest.mark.parametrize("n", [64, 128, 256])
def test_s8_wgmma_descriptors_match_int_mm(k, n):
    """One 64 x n x k s8 product by the layer's s8 wgmma on TMA tiles, with
    its swizzled descriptors advanced 32 bytes per k-step (128-byte swizzle at
    k = 128, 64-byte at k = 64), bit-equal to torch._int_mm."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(k + n)
    a = torch.randint(-127, 128, (64, k), generator=gen, device=dev, dtype=torch.int8)
    b = torch.randint(-127, 128, (n, k), generator=gen, device=dev, dtype=torch.int8)
    out = gli8.s8_wgmma_probe(a, b)
    torch.cuda.synchronize()
    assert torch.equal(out, torch._int_mm(a, b.t()))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["int8", "int8_static_attn"])
def test_int8_layer_kernel_takes_heads_of_width_32(mode):
    dev = _cuda()
    static, quant_attention = MODES[mode]
    w, x_q, x_kv, mask = _layer_case(dev, torch.float32, counts=(200, 0), dim=128)
    qw = gli8.quantize_propagation_weights(w)
    scales = None
    if static:
        absmax = gli8.reference_activation_absmax(x_q, x_kv, mask, qw, 4, False, quant_attention)
        scales = absmax * (1.1 / 127.0) + 1e-12
    kwargs = dict(act_scales=scales, quant_attention=quant_attention)
    before = gli8.counter.count
    with torch.no_grad():
        out = gli8.fused_attention_propagation_int8(x_q, x_kv, mask, qw, 4, **kwargs)
        ref = gli8.layer_int8_plain(x_q, x_kv, mask, qw, 4, **kwargs)
    torch.cuda.synchronize()
    assert gli8.counter.count == before + 1
    rel = ((out.float() - ref.float()).norm() / ref.float().norm()).item()  # the D=256 test's bars
    assert rel < (1e-3 if quant_attention else 0.015), rel


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_message_and_half_kernels_take_heads_of_width_32(dtype):
    """K4, K5 and K8 at D=128 with 4 heads, at the bars of the D=256 tests."""
    dev = _cuda()
    x_q, x_kv, mask, w, g = _message_case(dev, dtype, dim=128)
    before = glk.message_counter.count, glk.message_bwd_counter.count, glk.half_counter.count
    out = glk.message_forward(x_q, x_kv, mask, w, 4, dtype)
    ref = glk.message_forward_plain(x_q, x_kv, mask, w, 4, dtype)
    grads = glk.message_backward(x_q, x_kv, mask, w, g, out[1], out[2], 4, dtype)
    ref_grads = glk.message_backward_plain(x_q, x_kv, mask, w, g, ref[1], ref[2], 4, dtype)
    gen = torch.Generator(device=dev).manual_seed(9)
    w1 = torch.randn(256, 256, generator=gen, device=dev) * 256**-0.5
    b1 = torch.randn(256, generator=gen, device=dev) * 0.1
    half = glk.train_half_forward(x_q, x_kv, mask, w, w1, b1, 4, True, dtype)
    half_ref = glk.train_half_plain(x_q, x_kv, mask, w, w1, b1, 4, True, dtype)
    torch.cuda.synchronize()
    launched = (glk.message_counter.count - before[0], glk.message_bwd_counter.count - before[1],
                glk.half_counter.count - before[2])
    assert launched == (1, 1, 1)
    for name, a, b in zip(("msg", "attn", "lse"), out, ref):
        _close(a, b, dtype, name)
    for name, a, b in zip(("dx_q", "dx_kv"), grads[:2], ref_grads[:2]):
        _close(a, b, dtype, name, f32_tol=GRAD_F32_TOL)
    _close_weight_grads(grads[2], ref_grads[2], dtype)
    for name, a, b in zip(("z", "attn", "lse"), half, half_ref):
        _close(a, b, dtype, "half " + name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernels_take_heads_of_width_32(dtype):
    """K9, K10 (with and without the LSE's cotangent) and K11 at dh = 32, a
    fully masked element included, at the bars of the dh = 64 tests."""
    dev = _cuda()
    q, k, v, g, mask = _attention_case(dev, dtype, heads=4, dh=32)
    g_lse = torch.randn(q.shape[:3], generator=torch.Generator(device=dev).manual_seed(11), device=dev)
    before = ak.counter.count, ak.backward_counter.count, ak.lse_counter.count
    out, lse = ak.attention_forward(q, k, v, mask)
    ref, ref_lse = ak.attention_forward_plain(q, k, v, mask)
    lse_out, lse_lse = ak.attention_lse_forward(q, k, v, mask)
    grads = ak.attention_backward(q, k, v, mask, g, out, lse)
    ref_grads = ak.attention_backward_plain(q, k, v, mask, g)
    grads_lse = ak.attention_backward(q, k, v, mask, g, out, lse, g_lse)
    ref_grads_lse = ak.attention_backward_plain(q, k, v, mask, g, g_lse=g_lse)
    torch.cuda.synchronize()
    assert (ak.counter.count - before[0], ak.backward_counter.count - before[1],
            ak.lse_counter.count - before[2]) == (1, 2, 1)
    live = mask.any(dim=1)
    _close(out, ref, dtype, "out")
    _close(lse_out, ref, dtype, "K11 out")
    _close(lse[live], ref_lse[live], dtype, "lse")
    _close(lse_lse[live], ref_lse[live], dtype, "K11 lse")
    for name, a, b in zip(("dq", "dk", "dv"), grads, ref_grads):
        _close(a, b, dtype, name, f32_tol=GRAD_F32_TOL)
    for name, a, b in zip(("dq", "dk", "dv"), grads_lse, ref_grads_lse):
        _close(a, b, dtype, name + " with g_lse", f32_tol=GRAD_F32_TOL)


# ----------------------------------------------------------- the Sinkhorn past the fused kernels' columns


@pytest.mark.cuda
@pytest.mark.parametrize("k_dtype,m,n", [(torch.bfloat16, 130, 4400), (torch.float32, 40, 1700)])
def test_streaming_sinkhorn_kernel_matches_plain(k_dtype, m, n):
    """Past 4096 columns with bf16 K, and past 1536 with f32 K, the forward
    runs the streaming kernel (counted apart from the fused one)."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(12)
    batch = 2
    scores = torch.randn(batch, m, n, generator=gen, device=dev) * 3
    mask0 = torch.rand(batch, m, generator=gen, device=dev) > 0.2
    mask1 = torch.rand(batch, n, generator=gen, device=dev) > 0.2
    rows, cp = m + 1, sk._round_up(n + 1, sk.COL_ALIGN)
    assert cp > sk.FUSED_MAX_COLS[k_dtype]
    M_pad = sk.build_padded_otp_matrix(scores, torch.tensor(1.0, device=dev), 1.0, mask0, mask1, rows, cp)
    la, lb, _ = sk.otp_marginals(batch, m, n, mask0, mask1, dev)
    la, lb = sk.padded_marginals(la, lb, rows, cp)
    before = sk.counter.count, sk.stream_counter.count
    u = sk.sinkhorn_scale(M_pad, la, lb, 20, k_dtype)
    again = sk.sinkhorn_scale(M_pad, la, lb, 20, k_dtype)
    ref = sk.sinkhorn_scale_plain(M_pad, la, lb, 20, k_dtype)
    torch.cuda.synchronize()
    assert (sk.counter.count - before[0], sk.stream_counter.count - before[1]) == (0, 2)
    assert torch.equal(u, again)  # fixed summation order
    live = la > -1e8
    # the fused kernel's bar: the same f32 recursion and storage rounding
    torch.testing.assert_close(u[live], ref[live], atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_training_at_2048_keypoints_and_heads_of_width_32_matches_plain(monkeypatch):
    """A use_pallas training step at the pretraining fixture's shape, cut to
    two stages: B=2, N=2048, D=128 with 4 heads (dh = 32), bf16 chain, the
    message route. It needs both kernels' repairs: K4/K5 at dh = 32, and the
    Sinkhorn backward past the adjoint kernel's columns, which takes the
    autograd route. Held against the same step through the plain versions."""
    from openglue_tpu_torch.cli.common import loss_config_from, superglue_config_from
    from openglue_tpu_torch.data.synthetic import SyntheticHomographyPairs
    from openglue_tpu_torch.models.superglue import SuperGlue
    from openglue_tpu_torch.train.state import create_train_state
    from openglue_tpu_torch.train.step import make_train_step

    dev = _cuda()
    section = {
        "laf_to_sideinfo_method": "none", "positional_encoding": {"hidden_layers_sizes": [32, 64, 128]},
        "attention_gnn": {"num_stages": 2, "num_heads": 4, "attention": "softmax", "use_offset": False},
        "dustbin_score_init": 1.0, "otp": {"num_iters": 20, "reg": 1.0}, "residual": True,
        "use_pallas": True, "chain_dtype": "bfloat16",
    }
    cfg = superglue_config_from({"superglue": section}, 128, 0)
    step = make_train_step(loss_config_from({"train": {"gt_positive_threshold": 3, "gt_negative_threshold": 3}}))
    gen = torch.Generator(device=dev).manual_seed(13)
    batch = SyntheticHomographyPairs(num_keypoints=2048, descriptor_dim=128).sample(gen, 2)

    def run(plain):
        model = SuperGlue(cfg, device=dev, generator=torch.Generator().manual_seed(1))
        state = create_train_state(model)
        with monkeypatch.context() as m:
            if plain:
                m.setattr(glk, "message_forward", glk.message_forward_plain)
                m.setattr(glk, "message_backward", glk.message_backward_plain)
                m.setattr(sk, "sinkhorn_scale", sk.sinkhorn_scale_plain)
            before = (glk.message_counter.count, glk.message_bwd_counter.count, sk.counter.count,
                      sk.adjoint_counter.count, sk.autograd_counter.count)
            metrics = step(state, batch)
            after = (glk.message_counter.count, glk.message_bwd_counter.count, sk.counter.count,
                     sk.adjoint_counter.count, sk.autograd_counter.count)
        grads = torch.cat([p.grad.double().flatten() for p in model.parameters() if p.grad is not None])
        return metrics, grads, tuple(a - b for a, b in zip(after, before))

    got, g_got, launched = run(False)
    ref, g_ref, plain_launched = run(True)
    torch.cuda.synchronize()
    layers = 2 * 2 * 2
    assert launched == (layers, layers, 1, 0, 1)  # K4, K5, K2, no K3, one autograd-route backward
    assert plain_launched == (0, 0, 0, 0, 1)
    # the bars of chip_smoke.py's training step against its plain step
    assert abs(got["total_loss"].item() - ref["total_loss"].item()) <= 1e-3
    assert abs(got["grad_norm"].item() / ref["grad_norm"].item() - 1) <= 0.01
    cos = (g_got @ g_ref / (g_got.norm() * g_ref.norm())).item()
    assert cos >= 0.999, cos


# ------------------------------------------------------------ dense GEMMs

# the launch rule takes 128 x 128 tiles where they give every SM two (12,325
# rows at n_out 512 on 132 SMs), else 64 x 64 tiles
GEMM_ROWS, GEMM_N, GEMM_K = (1, 37, 300, 4113, 12325), (64, 128, 512), (32, 256, 512)


def _gemm_case(dev, dtype, rows, n_out, k, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s, scale=1.0: torch.randn(*s, generator=gen, device=dev) * scale
    return dict(a=r(rows, k).to(dtype), w=r(n_out, k, scale=k**-0.5).to(dtype), b=r(n_out),
                x=r(rows, n_out).to(dtype), scale=1.0 + 0.1 * r(n_out), shift=0.1 * r(n_out))


def _gemm_close(out, ref, dtype, what):
    # f32 (3xTF32): the split drops lo.lo, 2^-22 of each product, and the sums
    # run in another order: 1e-5 of the largest entry, the layer kernels' bar;
    # bf16: two ulps of the largest entry (one rounding of the output flipped)
    scale = ref.float().abs().max().item()
    tol = 1e-5 * scale if dtype == torch.float32 else 2.0**-7 * scale
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= tol, f"{what}: max error {err} above {tol}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("epilogue", gk.EPILOGUES)
def test_gemm_kernel_matches_plain(dtype, epilogue):
    """Every epilogue at rows {1, 37, 300, 4113, 12325} x n_out {64, 128,
    512} x k {32, 256, 512}, through both f32 tile shapes; each f32 call
    counts one gemm_f32 launch, a bf16 call none."""
    dev = _cuda()
    for rows in GEMM_ROWS:
        for n_out in GEMM_N:
            for k in GEMM_K:
                c = _gemm_case(dev, dtype, rows, n_out, k)
                use_offset = epilogue == "concat" and rows % 2 == 1
                kw = dict(x=c["x"], scale=c["scale"], shift=c["shift"], use_offset=use_offset)
                ref = gk.gemm_plain(c["a"], c["w"], c["b"], epilogue, **kw)
                before = gk.counter.count
                out = gk.gemm(c["a"], c["w"], c["b"], epilogue, **kw)
                torch.cuda.synchronize()
                assert gk.counter.count == before + (dtype == torch.float32)
                assert out.dtype == ref.dtype and out.shape == ref.shape
                _gemm_close(out, ref, dtype, f"{epilogue} rows={rows} n_out={n_out} k={k}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemm_kernel_kn_and_stacked_weights_match_plain(dtype):
    """The kn form (a . w for w [k, n_out]) with and without k_split, and the
    stacked weight of the k+v projection (split, bias2), through both f32
    tile shapes."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(3)
    r = lambda *s, scale=1.0: torch.randn(*s, generator=gen, device=dev) * scale
    for rows in GEMM_ROWS:
        for n_out, k in ((256, 256), (256, 512), (128, 32), (512, 256)):
            a = r(rows, k).to(dtype)
            w = r(k, n_out, scale=k**-0.5).to(dtype)
            half = k // 2
            wk, wv = r(n_out // 2, k, scale=k**-0.5).to(dtype), r(n_out // 2, k, scale=k**-0.5).to(dtype)
            bk, bv = r(n_out // 2), r(n_out // 2)
            cases = {
                "kn": (dict(a=a, w=w, bias=None, kn=True), {}),
                "kn k_split": (dict(a=a, w=w[:half].contiguous(), bias=None, kn=True, w2=w[half:].contiguous(),
                                    k_split=half), {}),
                "split": (dict(a=a, w=wk, bias=bk, w2=wv, bias2=bv, split=n_out // 2), {}),
            }
            for name, (kw, _) in cases.items():
                ref = gk.gemm_plain(**kw)
                out = gk.gemm(**kw)
                torch.cuda.synchronize()
                _gemm_close(out, ref, dtype, f"{name} rows={rows} n_out={n_out} k={k}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemm_kernel_keeps_nan_and_is_deterministic(dtype):
    """A NaN row of a comes out NaN through both ReLU epilogues and no other
    row does; two runs give equal bits. Both f32 tile shapes: 300 rows at
    n_out 128 take 64 x 64 tiles, 12,325 rows at n_out 512 128 x 128."""
    dev = _cuda()
    for rows, n_out in ((300, 128), (12325, 512)):
        c = _gemm_case(dev, dtype, rows, n_out, 256, seed=5)
        c["a"][17, 40] = float("nan")
        others = torch.arange(rows, device=dev) != 17
        for epilogue in ("relu", "relu_affine"):
            out = gk.gemm(c["a"], c["w"], c["b"], epilogue, scale=c["scale"], shift=c["shift"])
            again = gk.gemm(c["a"], c["w"], c["b"], epilogue, scale=c["scale"], shift=c["shift"])
            torch.cuda.synchronize()
            assert torch.isnan(out[17]).all() and torch.isfinite(out[others]).all(), (rows, epilogue)
            assert torch.equal(out[others], again[others]), (rows, epilogue)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tn_gemm_kernel_matches_plain_and_is_deterministic(dtype):
    """The weight-gradient GEMM with one to four problems of different row
    counts (1 to 13,000 rows: one to 26 row chunks), through both f32 tile
    shapes (the plan takes 128 x 128 for the first and the last case on 132
    SMs, 64 x 64 for the others); two runs give equal bits."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(7)
    r = lambda *s: torch.randn(*s, generator=gen, device=dev).to(dtype)
    for p, q, rows in ((256, 256, (12288, 12288, 12288, 12288)), (128, 128, (4096, 300, 1, 4113)),
                       (64, 128, (37,)), (256, 512, (13000, 700))):
        xs = [r(n, p) for n in rows]
        ys = [r(n, q) for n in rows]
        refs = gk.tn_gemm_plain(xs, ys)
        before = gk.tn_counter.count
        outs = gk.tn_gemm(xs, ys)
        again = gk.tn_gemm(xs, ys)
        torch.cuda.synchronize()
        assert gk.tn_counter.count == before + 2 * (dtype == torch.float32)
        for i, (o, o2, ref) in enumerate(zip(outs, again, refs)):
            assert torch.equal(o, o2)
            # f32 out either way: 1e-5 of the largest entry in f32; bf16
            # operands summed in another f32 order, 1e-5 too
            scale = ref.abs().max().item()
            err = (o - ref).abs().max().item()
            assert err <= 1e-5 * scale, f"tn P={p} Q={q} rows={rows[i]}: {err} above {1e-5 * scale}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_kernels_count_the_gemms_they_launch(dtype):
    """The C code counts each GEMM and bf16 attention where it launches it: an
    f32 K1 layer launches 5 gemm_f32, K6 6, K4 3, K5 5 and one tn_gemm_f32,
    K8 4, and no gemm_bf16; a bf16 layer as many gemm_bf16 and no f32 GEMM
    (and K1, K4, K8 one bf16 attention, K5 none: its attention passes are the
    backward's). Counts are (gemm_f32, gemm_bf16, tn_gemm_f32)."""
    dev = _cuda()
    counts = lambda: (gk.counter.count, gk.bf16_counter.count, gk.tn_counter.count)
    f32 = dtype == torch.float32
    gemms = lambda n, tn=0: (n * f32, n * (not f32), tn)
    attention = ak.bf16_counter.count

    def launched(fn):
        before = counts()
        fn()
        torch.cuda.synchronize()
        return tuple(a - b for a, b in zip(counts(), before))

    w, x_q, x_kv, mask = _layer_case(dev, dtype, counts=(200, 257))
    with torch.no_grad():
        assert launched(lambda: glk.fused_attention_propagation(x_q, x_kv, mask, w, 4, False)) == gemms(5)
        assert launched(lambda: glk.fused_attention_propagation(x_q, x_kv, mask, w, 4, False, "linear")) == gemms(6)
    x_q, x_kv, mask, mw, g = _message_case(dev, dtype)
    out = []
    assert launched(lambda: out.extend(glk.message_forward(x_q, x_kv, mask, mw, 4, dtype))) == gemms(3)
    assert launched(lambda: glk.message_backward(x_q, x_kv, mask, mw, g, out[1], out[2], 4, dtype)) == gemms(5, f32)
    w1 = torch.randn(512, 512, device=dev) * 512**-0.5
    b1 = torch.zeros(512, device=dev)
    assert launched(lambda: glk.train_half_forward(x_q, x_kv, mask, mw, w1, b1, 4, False, dtype)) == gemms(4)
    assert ak.bf16_counter.count - attention == 3 * (not f32)  # K1, K4, K8


@pytest.mark.cuda
def test_gemm_kernel_refuses_what_it_does_not_take():
    dev = _cuda()
    a, w = torch.randn(37, 96, device=dev), torch.randn(96, 96, device=dev)
    with pytest.raises(ValueError, match="n_out % 64"):
        gk.gemm(a, w)
    with pytest.raises(ValueError, match="kn form takes the bias epilogue only"):
        gk.gemm(a, torch.randn(96, 64, device=dev), epilogue="relu", kn=True)
    with pytest.raises(ValueError, match="multiples of 64"):
        gk.tn_gemm([torch.randn(37, 96, device=dev)], [torch.randn(37, 64, device=dev)])


# ----------------------------------------------------------- the Hopper bf16 kernels

HOPPER_GEMM_ROWS = (1, 63, 1000, 1024, 16384 + 17)


@pytest.mark.cuda
@pytest.mark.parametrize("epilogue", gk.EPILOGUES)
def test_hopper_bf16_gemm_matches_plain_at_every_tile(epilogue):
    """The bf16 GEMM (wgmma on TMA tiles) with each epilogue at rows {1, 63,
    1000, 1024, 16401}, for n_out x k in {256 x 256, 512 x 160 (k a multiple
    of 32 only)}, with the stacked weight (split) and, for the bias epilogue,
    the kn form with and without k_split (a cut of 256, and of 48 and 8 inside
    a k-tile); two runs bit-equal; each call counts one gemm_bf16 launch. The
    launch rule takes every tile on the way: on 132 SMs, 64 x 256 at 16,401
    rows and n_out 512, 64 x 128 at 16,401 rows and n_out 256, 64 x 64 at
    1,024 rows and fewer."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(11)
    r = lambda *s, scale=1.0: torch.randn(*s, generator=gen, device=dev) * scale
    for rows in HOPPER_GEMM_ROWS:
        cases = {}
        for n_out, k in ((256, 256), (512, 160)):
            c = _gemm_case(dev, torch.bfloat16, rows, n_out, k, seed=rows)
            cases[f"{n_out}x{k}"] = dict(a=c["a"], w=c["w"], bias=c["b"], epilogue=epilogue, x=c["x"],
                                         scale=c["scale"], shift=c["shift"], use_offset=rows % 2 == 1)
            w2, b2 = r(n_out // 2, k, scale=k**-0.5).bfloat16(), r(n_out // 2)
            cases[f"{n_out}x{k} split"] = dict(cases[f"{n_out}x{k}"], w=c["w"][: n_out // 2].contiguous(),
                                               bias=c["b"][: n_out // 2].contiguous(), w2=w2, bias2=b2,
                                               split=n_out // 2)
        if epilogue == "bias":
            a, wk = r(rows, 512).bfloat16(), r(512, 256, scale=512**-0.5).bfloat16()
            cases["kn"] = dict(a=a, w=wk, bias=None, kn=True)
            for cut in (256, 48, 8):
                cases[f"kn k_split {cut}"] = dict(a=a, w=wk[:cut].contiguous(), bias=None, kn=True,
                                                  w2=wk[cut:].contiguous(), k_split=cut)
        for name, kw in cases.items():
            ref = gk.gemm_plain(**kw)
            n_out = ref.shape[1] // (2 if epilogue == "concat" else 1)
            before = gk.bf16_counter.count
            out, again = gk.gemm(**kw), gk.gemm(**kw)
            torch.cuda.synchronize()
            assert gk.bf16_counter.count == before + 2
            assert torch.equal(out, again), (name, rows)
            assert out.dtype == ref.dtype and out.shape == ref.shape
            _gemm_close(out, ref, torch.bfloat16, f"{epilogue} {name} rows={rows} n_out={n_out}")


@pytest.mark.cuda
def test_hopper_bf16_gemm_refuses_cuts_off_its_boxes():
    dev = _cuda()
    a, w = torch.randn(100, 128, device=dev).bfloat16(), torch.randn(128, 128, device=dev).bfloat16()
    with pytest.raises(ValueError, match="multiples of 8"):
        gk.gemm(a, w[:4].contiguous(), None, kn=True, w2=w[4:].contiguous(), k_split=4)
    off = torch.randn(128 * 128 + 4, device=dev).bfloat16()[4:].view(128, 128)  # 8 bytes past a boundary
    with pytest.raises(ValueError, match="16-byte boundaries"):
        gk.gemm(a, off)
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        gk.gemm(torch.randn(100, 136, device=dev).bfloat16()[:, 4:], w)


def _hopper_attention_case(dev, dh, n, m, layout, seed):
    """bf16 q [3, 4, n, dh], k and v [3, 4, m, dh] in ``layout``: "heads" (the
    transposed views of [B, L, H*dh] projections, K9/K11) or "columns" (k and
    v the column blocks of one [B, M, 2D] buffer, as K1, K4 and K8 pass
    them); a ragged key mask with one fully masked element (index 1)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    batch, heads = 3, 4
    dim = heads * dh
    r = lambda *s: torch.randn(*s, generator=gen, device=dev).bfloat16()
    split = lambda x, length: x.view(batch, length, heads, dh).transpose(1, 2)
    q = split(r(batch, n, dim), n)
    if layout == "heads":
        k, v = split(r(batch, m, dim), m), split(r(batch, m, dim), m)
    else:
        kv = r(batch, m, 2 * dim)
        k, v = split(kv[..., :dim], m), split(kv[..., dim:], m)
    counts = torch.randint(max(1, m // 2), m + 1, (batch,), generator=gen, device=dev)
    counts[1] = 0
    return q, k, v, torch.arange(m, device=dev)[None] < counts[:, None]


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("layout", ["heads", "columns"])
def test_hopper_bf16_attention_matches_plain(dh, layout):
    """The bf16 attention (wgmma, TMA ring, two consumer warpgroups) with M
    below one key tile (77), not a multiple of 128 (200) and over several
    tiles (1000), ragged N (1, 100, 300), one element with every key masked
    (the uniform average over its M keys), with and without the mask, with
    and without the LSE; two runs bit-equal. (Its f32-out instance runs
    inside the int8 layer, test_int8_layer_kernel_matches_plain.)"""
    dev = _cuda()
    for n, m in ((1, 77), (100, 200), (300, 1000), (129, 128)):
        q, k, v, mask = _hopper_attention_case(dev, dh, n, m, layout, seed=n + m)
        live = mask.any(dim=1)
        for kv_mask in (mask, None):
            before = ak.bf16_counter.count
            out, lse = ak.attention_forward(q, k, v, kv_mask, True)
            again, lse_again = ak.attention_forward(q, k, v, kv_mask, True)
            bare, none = ak.attention_forward(q, k, v, kv_mask, False)
            ref, ref_lse = ak.attention_forward_plain(q, k, v, kv_mask, True)
            torch.cuda.synchronize()
            what = f"dh={dh} {layout} n={n} m={m} mask={kv_mask is not None}"
            assert ak.bf16_counter.count == before + 3, what
            assert none is None and out.dtype == torch.bfloat16, what
            assert torch.equal(out, again) and torch.equal(lse, lse_again) and torch.equal(out, bare), what
            # one or two bf16 ulps of the largest output (P rounds against the running max)
            tol = 2.0**-7 * ref.float().abs().max().item()
            assert (out.float() - ref.float()).abs().max().item() <= tol, what
            rows = live if kv_mask is not None else torch.ones_like(live)
            assert (lse - ref_lse)[rows].abs().max().item() <= 1e-4, what
            if kv_mask is not None:  # every key masked: the average of the M keys
                mean = v[1].float().mean(dim=1, keepdim=True).expand_as(out[1])
                assert (out[1].float() - mean).abs().max().item() <= tol, what
                assert bool((lse[1] < -1e8).all()), what


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("layout", ["heads", "columns"])
def test_hopper_bf16_attention_backward_matches_plain(dh, layout):
    """The bf16 attention backward (K10; its two passes, wgmma on TMA tiles,
    are K5's bf16 attention too) with M below one key tile (77), at one tile
    (128), not a multiple of 128 (200, 777) and over several tiles (1000),
    ragged N (1, 100, 300, 129, 1000), one element with every key masked,
    with and without the mask, with and without the LSE's cotangent: K10's
    bars of 2^-6 of the largest entry, two runs bit-equal, two launches of
    the passes per call."""
    dev = _cuda()
    for n, m in ((1, 77), (100, 200), (300, 1000), (129, 128), (1000, 777)):
        q, k, v, mask = _hopper_attention_case(dev, dh, n, m, layout, seed=n + m)
        gen = torch.Generator(device=dev).manual_seed(n)
        g = torch.randn(3, n, 4 * dh, generator=gen, device=dev).bfloat16().view(3, n, 4, dh).transpose(1, 2)
        g_lse = torch.randn(q.shape[:3], generator=gen, device=dev)
        for kv_mask in (mask, None):
            out, lse = ak.attention_forward(q, k, v, kv_mask)
            for cot in (None, g_lse):
                before = ak.bf16_backward_counter.count
                grads = ak.attention_backward(q, k, v, kv_mask, g, out, lse, cot)
                again = ak.attention_backward(q, k, v, kv_mask, g, out, lse, cot)
                ref = ak.attention_backward_plain(q, k, v, kv_mask, g, g_lse=cot)
                torch.cuda.synchronize()
                what = f"dh={dh} {layout} n={n} m={m} mask={kv_mask is not None} g_lse={cot is not None}"
                assert ak.bf16_backward_counter.count == before + 4, what
                for name, a, b, c in zip(("dq", "dk", "dv"), grads, again, ref):
                    assert a.dtype == torch.bfloat16 and torch.equal(a, b), f"{what} {name}"
                    _close(a, c, torch.bfloat16, f"{what} {name}")
                if kv_mask is not None and cot is not None:  # every key masked: dq = dk = 0
                    assert not grads[0][1].any() and not grads[1][1].any(), what


# ---------------------------------------------------------------- serving entry


def _serving_pair(tmp_path):
    """A fixture image and a copy warped by a mild homography, grayscale."""
    import cv2
    import numpy as np

    from openglue_tpu_torch.data.fixture import generate_image_fixture

    generate_image_fixture(tmp_path, num_images=1, image_size=(640, 512), seed=2)
    image = cv2.imread(str(tmp_path / "img0000.jpg"), cv2.IMREAD_GRAYSCALE)
    H = np.array([[0.96, -0.06, 12.0], [0.06, 0.96, -8.0], [1e-5, -5e-6, 1.0]])
    return image, cv2.warpPerspective(image, H, (640, 512))


def _serving_matcher(**superglue):
    """The flagship matcher section at the SIFT width (D=128, heads of width
    32), seeded random weights, 512 keypoints a side."""
    from openglue_tpu_torch.cli.inference import OpenGlueMatcher
    from openglue_tpu_torch.core.config import Config

    section = {"positional_encoding": {"hidden_layers_sizes": [32, 64, 128]},
               "attention_gnn": {"num_stages": 9, "num_heads": 4, "attention": "softmax"},
               "otp": {"num_iters": 20}, "residual": True, "use_pallas": True, "chain_dtype": "bfloat16",
               **superglue}
    features = {"name": "OPENCV_SIFT", "descriptor_dim": 128, "parameters": {"max_keypoints": 512}}
    return OpenGlueMatcher(Config({"superglue": section, "inference": {"match_threshold": 0.0}}),
                           Config(features), target_size=(480, 360), device="cuda")


@pytest.mark.cuda
def test_matcher_serves_through_the_kernels_as_its_plain_path(tmp_path, monkeypatch):
    """``match_images`` on the card, 36 K1 + 1 K2 launches, against the same
    matcher with the kernels' plain versions: log-P within 0.05 nats and the
    decode agreeing on at least 99% of the keypoints (chip_smoke.py's
    ``compare`` bars)."""
    import numpy as np

    _cuda()
    image0, image1 = _serving_pair(tmp_path)
    matcher = _serving_matcher()
    assert all(matcher.extract(image)[3].all() for image in (image0, image1))  # 512 valid keypoints a side
    before = (glk.counter.count, sk.counter.count)
    out = matcher.match_images(image0, image1)
    assert (glk.counter.count - before[0], sk.counter.count - before[1]) == (36, 1)
    monkeypatch.setattr(glk, "fused_attention_propagation", glk.layer_plain)
    monkeypatch.setattr(sk, "sinkhorn_scale", sk.sinkhorn_scale_plain)
    ref = matcher.match_images(image0, image1)
    assert out["scores"].shape == ref["scores"].shape == (513, 513)
    assert np.abs(out["scores"] - ref["scores"]).max() <= 0.05

    def matches0(result):
        m = np.full(512, -1)
        m[result["indices0"]] = result["indices1"]
        return m

    assert (matches0(out) == matches0(ref)).mean() >= 0.99 and len(out["indices0"]) >= 50


@pytest.mark.cuda
def test_int8_static_matcher_calibrates_on_its_first_pair_then_serves(tmp_path):
    """The warm-up refuses an uncalibrated int8_static matcher; the first pair
    calibrates it, then every pair serves through K7 (36 launches of 6
    kernels) and no K1, the same pair bit for bit."""
    _cuda()
    image0, image1 = _serving_pair(tmp_path)
    matcher = _serving_matcher(quantize="int8_static")
    with pytest.raises(RuntimeError, match="uncalibrated"):
        matcher.precompile(512)
    first = matcher.match_images(image0, image1)
    assert matcher.model.int8_calibration.calibrated
    matcher.precompile(512)
    before = (glk.counter.count, gli8.counter.count, gli8.launch_counter.count)
    second = matcher.match_images(image0, image1)
    assert (glk.counter.count - before[0], gli8.counter.count - before[1],
            gli8.launch_counter.count - before[2]) == (0, 36, 216)
    assert (second["scores"] == first["scores"]).all()


# the device extractors (their convolutions and gathers are PyTorch ops, run
# with TF32 off inside each module): each on the card against the same
# module with the same weights on the CPU in f32, at the bars of
# features/agreement.py
EXTRACTOR_CONFIGS = {
    "SuperPointNet": dict(max_keypoints=1024, descriptor_dim=256, nms_kernel=9, remove_borders_size=4,
                          keypoint_threshold=0.005),
    "SuperPointNetBn": dict(max_keypoints=1024, descriptor_dim=256, nms_kernel=9, remove_borders_size=4,
                            keypoint_threshold=0.005),
    "SIFT": dict(max_keypoints=1024, nms_diameter=9, rootsift=True),
    "GFTTAffNetHardNet": dict(max_keypoints=1024, descriptor_dim=128, nms_diameter=9),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(EXTRACTOR_CONFIGS))
def test_device_extractor_on_the_card_matches_its_cpu_run(name, tmp_path):
    import copy

    from openglue_tpu_torch.cli.extract_features import build_device_extractor, extract_on_device
    from openglue_tpu_torch.features.agreement import agreement, textured, within_bars

    _cuda()
    image, _ = _serving_pair(tmp_path)
    model = build_device_extractor({"name": name, "parameters": EXTRACTOR_CONFIGS[name]}, None, "cuda")
    torch.backends.cudnn.allow_tf32 = True  # the module turns TF32 off itself, whatever the caller set
    try:
        got = extract_on_device(model, image, "cuda")
    finally:
        torch.backends.cudnn.allow_tf32 = False
    ref = extract_on_device(copy.deepcopy(model).cpu(), image, "cpu")
    patch_size = getattr(model.config, "patch_size", None)
    readings = agreement(got, ref, held=None if patch_size is None else textured(image, ref[0], patch_size))
    assert within_bars(readings, descriptor_max=name != "SIFT"), readings
    assert readings["n_ref"] >= 200


@pytest.mark.cuda
def test_dog_affnet_hardnet_on_the_card_matches_its_cpu_run(tmp_path):
    from openglue_tpu_torch.features.agreement import agreement, textured, within_bars
    from openglue_tpu_torch.features.dog_affnet_hardnet import DoGAffNetHardNet

    _cuda()
    image, _ = _serving_pair(tmp_path)
    card = DoGAffNetHardNet(max_keypoints=1024, device="cuda")
    cpu = DoGAffNetHardNet(max_keypoints=1024, device="cpu")
    cpu.load_weights(card.affnet.state_dict(), card.orinet.state_dict(), card.hardnet.state_dict())
    ref = cpu.detect_and_compute(image)
    readings = agreement(card.detect_and_compute(image), ref, held=textured(image, ref[0], card.patch_size))
    assert within_bars(readings), readings
    assert readings["n_ref"] >= 200
