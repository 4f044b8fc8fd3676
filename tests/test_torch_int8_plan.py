"""The int8 layer kernel (K7, ``ops/csrc/gnn_layer_int8.cu``) on the CPU: its
launch plan on the Python mirror (``gnn_layer_int8.int8_plan``) and its
workspace (``workspace_bytes``) at the shapes the wrapper accepts; the key
permutation of V^T that lets P.V take P from the s32 accumulator as wgmma's
register A operand; and the kernel's fused quantizations emulated in plain
torch (the row absmax of [x_q - msg, msg] and of h1 formed from the two
consumers' halves, the quotient's fast path), bit-equal to the plain version
and held against the JAX oracle. The card tests hold the mirror against the
C plan (``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from openglue_tpu.ops.pallas import gnn_layer_int8 as jax_gli8
from openglue_tpu_torch.ops.kernels import gnn_layer_int8 as gli8
from test_torch_gnn_layer_kernel import _jax_weights, _torch_weights, _weights

MODES = {  # quantize mode -> (static, quant_attention)
    "int8": (False, False), "int8_static": (True, False),
    "int8_attn": (False, True), "int8_static_attn": (True, True),
}
SHAPES = [(16, 1024, 1024), (1, 1024, 1024), (3, 100, 77), (2, 129, 33), (4, 2048, 2048), (1, 1, 1),
          (2, 300, 257), (1, 4352, 4352)]


@pytest.mark.parametrize("mode,launches,memsets", [("int8", 6, 0), ("int8_static", 6, 0), ("int8_attn", 7, 1),
                                                   ("int8_static_attn", 6, 0)])
@pytest.mark.parametrize("dim", [128, 256])
def test_launches_per_layer_by_mode(mode, launches, memsets, dim):
    """kv, q, the attention, out, ffn1, ffn2; dynamic int8 attention adds the
    absmax memset and one launch that quantizes q, k and V^T."""
    static, quant_attention = MODES[mode]
    for batch, n, m in SHAPES:
        plan = gli8.int8_plan(batch, n, m, dim, 4, quant_attention, static)
        assert (plan.launches, plan.memsets) == (launches, memsets)


@pytest.mark.parametrize("batch,n,m,kv_ctas,q_ctas,attention_ctas", [
    (16, 1024, 1024, 132, 132, 132),  # 256 row tiles each side: persistent, one CTA per SM
    (1, 1024, 1024, 16, 16, 32),      # a single pair: 16 tiles, 8 query tiles x 4 heads
    (3, 100, 77, 4, 5, 12),           # ragged rows: 231 and 300 rows
    (2, 129, 33, 2, 5, 16),
])
@pytest.mark.parametrize("dim", [128, 256])
def test_tiles_and_ctas(batch, n, m, kv_ctas, q_ctas, attention_ctas, dim):
    """64-row GEMM tiles on min(tiles, SMs) persistent CTAs; attention CTAs
    over 128-query tiles of one (element, head)."""
    for mode, (static, quant_attention) in MODES.items():
        plan = gli8.int8_plan(batch, n, m, dim, 4, quant_attention, static)
        assert plan.tile_rows == 64
        assert (plan.kv_ctas, plan.q_ctas, plan.attention_ctas) == (kv_ctas, q_ctas, attention_ctas), mode


@pytest.mark.parametrize("dim", [128, 256])
@pytest.mark.parametrize("mode", list(MODES))
def test_every_launch_fits_the_card_and_the_weights_stay_on_chip(dim, mode):
    """Every launch within the 227 KB a block may take; every GEMM keeps its
    weight in shared memory for its whole run but ffn1 at D=256 (512 KB of
    weight: streamed in 64-byte k-tiles)."""
    static, quant_attention = MODES[mode]
    plan = gli8.int8_plan(16, 1024, 1024, dim, 4, quant_attention, static)
    assert max(plan[6:]) <= gli8.SMEM_CAP
    for name, cols, k, _ in gli8.GEMMS:
        resident = cols * dim * k * dim <= gli8.RESIDENT_BYTES
        assert resident == (dim == 128 or name != "ffn1"), name
    assert plan.smem_ffn1 == gli8.gemm_smem_bytes("h18", 2 * dim, 2 * dim, False)


def _parent_workspace(batch, n, m, dim, quant_attention):
    """The layout before the wgmma design: s8 and f32 copies of every
    quantized activation, with the f32 cat [rows, 2D] and h1 [rows, 2D]."""
    rq, rk, mp = batch * n, batch * m, -(-m // 64) * 64
    blocks = [rk * dim, rk * 4, rq * dim, rq * 4]
    if quant_attention:
        blocks += [rq * dim * 4, rk * dim * 4, rk * dim * 4, 3 * batch * 4, rq * dim, rk * dim, batch * mp * dim]
    else:
        blocks += [rq * dim * 2, rk * dim * 2, rk * dim * 2]
    blocks += [rq * dim * 4, rq * dim, rq * 4, rq * 2 * dim * 4, rq * 2 * dim, rq * 4, rq * 2 * dim * 4,
               rq * 2 * dim, rq * 4]
    return sum(-(-b // 256) * 256 for b in blocks)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("dim", [128, 256])
def test_workspace_holds_no_f32_cat_or_h1(mode, dim):
    """The workspace drops the f32 cat and h1 (and the s8 copy of the
    attention output, quantized on load); with static int8 attention also the
    f32 q, k and v."""
    static, quant_attention = MODES[mode]
    for batch, n, m in SHAPES:
        rq, rk = batch * n, batch * m
        size = gli8.workspace_bytes(batch, n, m, dim, quant_attention, static)
        dropped = 2 * rq * 2 * dim * 4 + rq * dim
        if quant_attention and static:
            dropped += rq * dim * 4 + 2 * rk * dim * 4
        assert size <= _parent_workspace(batch, n, m, dim, quant_attention) - dropped + 8 * 256
        # what is left: the attention output, cat8 and h18 with their scales, and the attention operands
        need = rq * dim * 4 + 2 * rq * 2 * dim + 2 * rq * 4
        need += (rk * 2 * dim * 2 + rq * dim * 2) if not quant_attention else (rq * dim + rk * dim)
        assert need <= size <= need + 16 * 256 + (gli8.keys_padded(m) * dim * batch + rk * 2 * dim * 4 + rq * dim * 4
                                                  + 3 * batch * 4 if quant_attention else 0)


def test_vt_permutation_maps_the_accumulator_to_the_register_operand():
    """In each block of 32 keys, the thread t of an m64nNk32 accumulator holds
    the keys 2t, 2t + 1, 8 + 2t, 9 + 2t of each half of 16 (entries 4j + e:
    column 8j + 2t + (e & 1)); the kernel packs them in that order as the
    bytes of its register A operand, whose k index is 16 (r >> 1) + 4t + i for
    register r, byte i. V^T keeps key m at vt_pos(m), so its k index holds
    the same key."""
    for t in range(4):
        for r in range(4):
            for i in range(4):
                key = 16 * (r >> 1) + 8 * (i >> 1) + 2 * t + (i & 1)
                assert gli8.vt_pos(key) == 16 * (r >> 1) + 4 * t + i
    for base in (0, 32, 4320):
        positions = sorted(gli8.vt_pos(base + m) for m in range(32))
        assert positions == list(range(base, base + 32))  # a permutation inside the block


@pytest.mark.parametrize("m", [32, 77, 1024])
def test_permuted_v_leaves_the_s32_product_unchanged(m):
    """The kernel's P.V with both operands in the permuted key order: V^T
    [dh, Mp] written at vt_pos (0 past M), P's fragment holding at k index
    vt_pos(key) the probability of key; the s32 product equals p8 . v8."""
    rng = np.random.default_rng(m)
    dh, queries, mp = 64, 16, -(-m // 64) * 64
    p8 = rng.integers(0, 128, (queries, m)).astype(np.int64)
    v8 = rng.integers(-127, 128, (m, dh)).astype(np.int64)
    vt = np.zeros((dh, mp), dtype=np.int64)
    fragment = np.zeros((queries, mp), dtype=np.int64)
    pos = np.array([gli8.vt_pos(k) for k in range(m)])
    vt[:, pos] = v8.T
    fragment[:, pos] = p8
    np.testing.assert_array_equal(fragment @ vt.T, p8 @ v8)


def _quotient_fast(x, s):
    """The kernel's rint(x / s) (quant_div): x * (1 / s) rounded with the add
    of 1.5 * 2^23, unless it lies within 3.2e-5 of a half, where the IEEE
    quotient decides; clipped to +-127."""
    magic = torch.tensor(12582912.0, dtype=torch.float32)
    t = x * (torch.tensor(1.0, dtype=torch.float32) / s)
    near_half = (t - ((t + magic) - magic)).abs() > 0.49996
    q = torch.where(near_half, torch.round(x / s), torch.round(t))
    return torch.clamp(q, -127, 127)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quotient_fast_path_is_bit_equal_to_the_division(seed):
    """clip(rint(x / s)) by the fast path equals the correctly rounded
    quotient's for dynamic row scales (|x / s| <= 127), with values planted
    on and next to every half."""
    rng = np.random.default_rng(seed)
    rows = rng.standard_normal((512, 256)).astype(np.float32) * rng.exponential(3.0, (512, 1)).astype(np.float32)
    x = torch.from_numpy(rows)
    s = gli8._absmax_scale(x.abs().amax(dim=1, keepdim=True))
    halves = torch.arange(-127, 127, dtype=torch.float32) + 0.5
    planted = (halves[None, :] * s[:64]).reshape(64, -1)[:, :256]
    for delta in (-1, 0, 1):  # the planted halves and their neighbours one ulp either side
        x[:64, :planted.shape[1]] = torch.nextafter(planted, planted + delta) if delta else planted
        want = torch.clamp(torch.round(x / s), -127, 127)
        assert torch.equal(_quotient_fast(x, s), want)


def _attention_output(x_q, x_kv, mask, w, heads, act_scales, quant_attention):
    """The attention output of layer_int8_plain, by its own steps."""
    batch, n, dim = x_q.shape
    m, dh = x_kv.shape[1], dim // heads

    def quant_rows(x, site):
        if act_scales is not None:
            sx = act_scales[site].float()
            return torch.clamp(torch.round(x * (1.0 / sx)), -127, 127), sx
        sx = gli8._absmax_scale(x.abs().amax(dim=-1, keepdim=True))
        return torch.clamp(torch.round(x / sx), -127, 127), sx

    def quant_tensor(x, site):
        sx = (act_scales[site].float().reshape(1, 1, 1) if act_scales is not None
              else gli8._absmax_scale(x.abs().amax(dim=(1, 2), keepdim=True)))
        return torch.clamp(torch.round(x * (1.0 / sx)), -127, 127), sx

    def qdense(xi, sx, wi8, sw, bias):
        return gli8._int_matmul(xi, wi8.t()) * (sx * sw) + bias

    def split(t, length):
        return t.reshape(batch, length, heads, dh).transpose(1, 2)

    kv_i8, s_kv = quant_rows(x_kv.float(), 0)
    xq_i8, s_xq = quant_rows(x_q.float(), 1)
    kf, vf = qdense(kv_i8, s_kv, w.wk, w.sk, w.bk), qdense(kv_i8, s_kv, w.wv, w.sv, w.bv)
    qf = qdense(xq_i8, s_xq, w.wq, w.sq, w.bq)
    mask_add = ((1.0 - mask.float()) * gli8.NEG_INF)[:, None, None, :]
    if quant_attention:
        (k_i8, s_ka), (v_i8, s_va), (q_i8, s_qa) = quant_tensor(kf, 5), quant_tensor(vf, 6), quant_tensor(qf, 7)
        logits = gli8._int_matmul(split(q_i8, n), split(k_i8, m).transpose(-1, -2)) * (
            s_qa * s_ka * dh**-0.5)[:, None] + mask_add
        p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
        o = gli8._int_matmul(torch.round(p * 127.0), split(v_i8, m)) * (s_va * (1.0 / 127.0))[:, None]
        o = o / p.sum(dim=-1, keepdim=True)
    else:
        q, k, v = qf.bfloat16(), kf.bfloat16(), vf.bfloat16()
        logits = torch.matmul(split(q, n).float(), split(k, m).float().transpose(-1, -2)) * dh**-0.5 + mask_add
        p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
        o = torch.matmul(p.bfloat16().float(), split(v, m).float()) / p.sum(dim=-1, keepdim=True)
    return o.transpose(1, 2).reshape(batch, n, dim)


def _chain(x_q, attn, w, use_offset, act_scales, piecewise):
    """msg, cat, h1 and out from the attention output, with cat's and h1's
    dynamic quantization by the whole row (the plain version's) or as the
    kernel forms it (piecewise): each row's absmax from the two consumers'
    halves (x_q - msg or x_q and msg, each split at D / 2; h1 split at D)
    and the quotient's fast path."""
    def quant(x, site, pieces):
        if act_scales is not None:
            s = act_scales[site].float()
            return torch.clamp(torch.round(x * (1.0 / s)), -127, 127), s
        if not piecewise or pieces == 1:
            s = gli8._absmax_scale(x.abs().amax(dim=-1, keepdim=True))
            return (torch.clamp(torch.round(x / s), -127, 127) if not piecewise else _quotient_fast(x, s)), s
        parts = [part.abs().amax(dim=-1, keepdim=True) for part in torch.tensor_split(x, pieces, dim=-1)]
        s = gli8._absmax_scale(torch.stack(parts).amax(dim=0))
        return _quotient_fast(x, s), s

    def qdense(xi, sx, wi8, sw, bias):
        return gli8._int_matmul(xi, wi8.t()) * (sx * sw) + bias

    xq = x_q.float()
    msg = qdense(*quant(attn, 2, 1), w.wo, w.so, w.bo)
    cat = torch.cat([xq - msg if use_offset else xq, msg], dim=-1)
    h1 = torch.relu(qdense(*quant(cat, 3, 4), w.w1, w.s1, w.b1)) * w.a1 + w.c1
    upd = qdense(*quant(h1, 4, 2), w.w2, w.s2, w.b2)
    return (xq + upd).to(x_q.dtype)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("use_offset", [False, True])
def test_fused_quantization_is_bit_equal_to_the_plain_version_and_near_the_jax_oracle(mode, use_offset):
    """cat8 from the row absmax of [x_q - msg, msg] formed from the two
    consumers' halves of each part, h18 from the two 256-column halves of h1
    (D = 256), with the quotient's fast path: the layer's output bit-equal to
    layer_int8_plain's, and within the JAX package's bar (0.015 in norm) of
    its oracle xla_reference_layer_int8."""
    static, quant_attention = MODES[mode]
    rng = np.random.default_rng(3 + use_offset)
    dim, heads, n, m, counts = 256, 4, 40, 33, (33, 20)
    x_q = rng.standard_normal((2, n, dim)).astype(np.float32)
    x_kv = rng.standard_normal((2, m, dim)).astype(np.float32)
    mask = np.arange(m)[None] < np.asarray(counts)[:, None]
    w = _weights(dim, 5)
    jqw = jax_gli8.quantize_propagation_weights(_jax_weights(w, jnp.float32))
    tqw = gli8.quantize_propagation_weights(_torch_weights(w, torch.float32))
    tx_q, tx_kv, tmask = torch.from_numpy(x_q), torch.from_numpy(x_kv), torch.from_numpy(mask)
    scales = None
    if static:
        absmax = gli8.reference_activation_absmax(tx_q, tx_kv, tmask, tqw, heads, use_offset, quant_attention)
        scales = absmax * (1.1 / 127.0) + 1e-12
    plain = gli8.layer_int8_plain(tx_q, tx_kv, tmask, tqw, heads, use_offset, act_scales=scales,
                                  quant_attention=quant_attention)
    attn = _attention_output(tx_q, tx_kv, tmask, tqw, heads, scales, quant_attention)
    assert torch.equal(_chain(tx_q, attn, tqw, use_offset, scales, piecewise=False), plain)
    fused = _chain(tx_q, attn, tqw, use_offset, scales, piecewise=True)
    assert torch.equal(fused, plain)
    oracle = jax_gli8.xla_reference_layer_int8(
        jnp.asarray(x_q), jnp.asarray(x_kv), jnp.asarray(mask), jqw, heads, use_offset,
        act_scales=None if scales is None else jnp.asarray(scales.numpy()), quant_attention=quant_attention,
    )
    oracle = np.asarray(oracle)
    assert np.linalg.norm(fused.numpy() - oracle) / np.linalg.norm(oracle) < 0.015
