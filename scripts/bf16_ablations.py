"""What bounds the bf16 GEMM and the bf16 attention: each kernel timed again
with one part of its work taken out, on a CUDA card; the bf16 GEMM at each
of its tiles; and K6's FAVOR-softmax with its keys staged again in its
second sweep.

    python3 scripts/bf16_ablations.py --repo DIR [--only NAME ...]

For each variant below the script copies DIR's ``openglue_tpu_torch`` under
DIR/build/ablations/<name>, edits one line of a kernel source there (an exact
text replacement that must match once, so a source that moved on fails
loudly instead of timing the wrong thing), builds the attention, GEMM and
layer libraries of the copy, each in a process of its own, and prints one
JSON line per variant, in device ms (``chip_smoke.device_ms``).

An ablation takes one part of a kernel's work out. A line of the forward
and the GEMM has K1's attention alone (B=16 and B=12, N=M=1024, H=4, dh=64,
ragged masks), K1's five bf16 GEMMs alone at B=16 and their sum, and the K1
bf16 layer; a line of the backward (``backward: ...``, both bf16 passes
edited at once) has K10 bf16 at B=12 N=1024, B=4 N=2048 and B=12 with heads
of width 32, and K5 bf16 at B=12 N=1024, D=256 and D=128. Each kind's
unedited copy comes first. The outputs of an ablated kernel are wrong
by design; only the unedited copy is checked against the plain versions. A
part whose removal leaves the time where it was is not what bounds the
kernel; one whose removal cuts the time is, in that share.

A tile variant makes the bf16 launch rule (``gemm.cuh``'s
``bf16_tile_rule``) return one tile wherever n_out allows it (elsewhere the
rule decides). Its line has K1's five GEMMs at 16,384 rows (B=16), 12,288
(B=12), 4,096 (the pretraining fixture's B=2 N=2048, D=128) and 1,024
(B=1): the measurements the rule is set from. The unedited rule's line
comes first. Every tile variant is checked against the plain version.

The K6 variant (``k6: ...``) makes the feature kernel's launch plan
(``gnn_layer_features.cu``'s ``make_feature_plan``) never keep FAVOR-softmax's
keys resident in shared memory between its two key sweeps, so that the second
sweep stages and converts them again, as it does where they do not fit. Its
line, and the unedited copy's before it, has the K6 FAVOR-softmax layer at
B=16 N=M=1024, D=256 (F=128) and D=128 (F=64), in bf16 and in f32, with
ragged key masks, and each
case's plan (``resident`` 1 or 0, read from the C code). Both copies are
checked against the plain version: the variant computes the same function.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ATTENTION = "openglue_tpu_torch/ops/csrc/attention.cuh"
ATTN_BWD = "openglue_tpu_torch/ops/csrc/attention_backward.cuh"
GEMM = "openglue_tpu_torch/ops/csrc/gemm.cuh"
MESSAGE_BWD = "openglue_tpu_torch/ops/csrc/message_backward.cu"
FEATURES = "openglue_tpu_torch/ops/csrc/gnn_layer_features.cu"

# pass B: dS^T formed before dV's products are issued, both issued together
DS_FIRST = ("""      // dV += T(P^T) g, issued before dS^T is formed
      uint32_t pf[kBwBq / 16][4], sf[kBwBq / 16][4];
      pack_fragments<kBwBq>(pf, s);
      fence_regs(dv);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBwBq / 16; ++kk)
        wgmma_pv<DH>(dv, pf[kk], smem_desc(g_addr + 16 * kk * S::row_bytes, 8192, S::sbo, S::row_bytes));
      wgmma_commit();
      wgmma_wait<1>();  // dP^T (dV's products may still run)
      fence_regs(dp);
      if (qt + 1 == qtiles && lane == 0) mbar_arrive(&r_empty[buf]);  // this tile's K and V are read
#pragma unroll
      for (int j = 0; j < kBwBq / 8; ++j) {
        const float2 d2 = *reinterpret_cast<const float2*>(di + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          dp[i] = ds_keep * s[i] * (dp[i] - (e & 1 ? d2.y : d2.x));
        }
      }
      // dK += T(dS^T) Q
      pack_fragments<kBwBq>(sf, dp);
      fence_regs(dk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBwBq / 16; ++kk)
        wgmma_pv<DH>(dk, sf[kk], smem_desc(q_addr + 16 * kk * S::row_bytes, 8192, S::sbo, S::row_bytes));
      wgmma_commit();
""", """      wgmma_wait<0>();  // dP^T
      fence_regs(dp);
      if (qt + 1 == qtiles && lane == 0) mbar_arrive(&r_empty[buf]);  // this tile's K and V are read
#pragma unroll
      for (int j = 0; j < kBwBq / 8; ++j) {
        const float2 d2 = *reinterpret_cast<const float2*>(di + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          dp[i] = ds_keep * s[i] * (dp[i] - (e & 1 ? d2.y : d2.x));
        }
      }
      // dV += T(P^T) g and dK += T(dS^T) Q
      uint32_t pf[kBwBq / 16][4], sf[kBwBq / 16][4];
      pack_fragments<kBwBq>(pf, s);
      pack_fragments<kBwBq>(sf, dp);
      fence_regs(dv);
      fence_regs(dk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBwBq / 16; ++kk) {
        wgmma_pv<DH>(dv, pf[kk], smem_desc(g_addr + 16 * kk * S::row_bytes, 8192, S::sbo, S::row_bytes));
        wgmma_pv<DH>(dk, sf[kk], smem_desc(q_addr + 16 * kk * S::row_bytes, 8192, S::sbo, S::row_bytes));
      }
      wgmma_commit();
""")
# pass A: dQ's products waited for after the next tile's S, their fragments kept
DQ_LATER = [
    ("""    zero(dq);
    for (int it = 0; it < sweeps; ++it) {
      const bool second = !kSweep || it >= ktiles;  // the sweep that forms dS and dQ
""",
     """    zero(dq);
    uint32_t f[kBwAk / 16][4];  // dS's fragments, kept until their dQ products complete
    int held = -1;              // the stage whose dQ products are in flight
    for (int it = 0; it < sweeps; ++it) {
      const bool second = !kSweep || it >= ktiles;  // the sweep that forms dS and dQ
"""),
    ("""      wgmma_wait<1>();  // P from S while dP's products run
      fence_regs(s);
      const float* ma = madd + stage * kBwAk;
""",
     """      wgmma_wait<1>();  // the last tile's dQ and this tile's S; P while dP's products run
      fence_regs(s);
      if (held >= 0) {
        fence_frags(f);
        fence_regs(dq);
        if (lane == 0) mbar_arrive(&empty[held]);
        held = -1;
      }
      const float* ma = madd + stage * kBwAk;
"""),
    ("""      if (second) {  // dQ += T(dS) K
        uint32_t f[kBwAk / 16][4];
        pack_fragments<kBwAk>(f, s);
        fence_regs(dq);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBwAk / 16; ++kk)
          wgmma_pv<DH>(dq, f[kk], smem_desc(k_addr + 16 * kk * S::row_bytes, 8192, S::sbo, S::row_bytes));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
      }
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == kBwAStages) stage = 0, phase ^= 1;
""",
     """      if (second) {  // dQ += T(dS) K, waited for under the next tile's S
        pack_fragments<kBwAk>(f, s);
        fence_regs(dq);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBwAk / 16; ++kk)
          wgmma_pv<DH>(dq, f[kk], smem_desc(k_addr + 16 * kk * S::row_bytes, 8192, S::sbo, S::row_bytes));
        wgmma_commit();
        held = stage;
      } else if (lane == 0) {
        mbar_arrive(&empty[stage]);
      }
      if (++stage == kBwAStages) stage = 0, phase ^= 1;
"""),
    ("""    if (++buf == 2) buf = 0, bphase ^= 1;

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = n0 + 64 * cw + 16 * warp + g + 8 * hh;""",
     """    wgmma_wait<0>();
    fence_frags(f);
    fence_regs(dq);
    if (lane == 0) mbar_arrive(&empty[held]);
    if (++buf == 2) buf = 0, bphase ^= 1;

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = n0 + 64 * cw + 16 * warp + g + 8 * hh;"""),
    ("""template <int N>
__device__ __forceinline__ void zero(float (&x)[N]) {""",
     """// keeps the compiler from reusing the registers of A fragments that a wgmma
// in flight still reads
template <int K>
__device__ __forceinline__ void fence_frags(uint32_t (&f)[K][4]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(f[k][i])::"memory");
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N]) {"""),
]

# both passes: the consumers take turns issuing S and dP (named barriers 1
# and 2), as the forward's do
TURNS = [
    ("  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {\n    const int n0 = tile % qblocks * kBwRows,",
     "  if (cw == 1) named_arrive(1, 256);\n"
     "  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {\n"
     "    const bool last_tile = tile + static_cast<int>(gridDim.x) >= tiles;\n"
     "    const int n0 = tile % qblocks * kBwRows,"),
    ("  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {\n    const int m0 = tile % kblocks * kBwRows,",
     "  if (cw == 1) named_arrive(1, 256);\n"
     "  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {\n"
     "    const bool last_tile = tile + static_cast<int>(gridDim.x) >= tiles;\n"
     "    const int m0 = tile % kblocks * kBwRows,"),
    ("      wgmma_fence();\n      issue_head_product<kBwAk, DH>(s, q_addr, k_addr);\n      wgmma_commit();\n"
     "      issue_head_product<kBwAk, DH>(dp, g_addr, v_addr);\n      wgmma_commit();\n",
     "      named_sync(1 + cw, 256);\n"
     "      wgmma_fence();\n      issue_head_product<kBwAk, DH>(s, q_addr, k_addr);\n      wgmma_commit();\n"
     "      issue_head_product<kBwAk, DH>(dp, g_addr, v_addr);\n      wgmma_commit();\n"
     "      if (cw == 0 || !last_tile || it + 1 < sweeps) named_arrive(2 - cw, 256);\n"),
    ("      wgmma_fence();\n      issue_head_product<kBwBq, DH>(s, k_addr, q_addr);\n      wgmma_commit();\n"
     "      issue_head_product<kBwBq, DH>(dp, v_addr, g_addr);\n      wgmma_commit();\n",
     "      named_sync(1 + cw, 256);\n"
     "      wgmma_fence();\n      issue_head_product<kBwBq, DH>(s, k_addr, q_addr);\n      wgmma_commit();\n"
     "      issue_head_product<kBwBq, DH>(dp, v_addr, g_addr);\n      wgmma_commit();\n"
     "      if (cw == 0 || !last_tile || qt + 1 < qtiles) named_arrive(2 - cw, 256);\n"),
]
# name: (the shapes it is timed at, [(source, text, replacement), ...])
ABLATIONS = {
    "attention: no exp (the scores' exp2 becomes a subtraction)": ("k1", [(
        ATTENTION, "const float pe = exp2_approx(s[i] - row_max[(i >> 1) & 1]);",
        "const float pe = s[i] - row_max[(i >> 1) & 1];")]),
    "attention: no S products": ("k1", [(
        ATTENTION, "    wgmma_ss_n128<0>(s, smem_desc(q + 32 * kk",
        "    if (kk < 0) wgmma_ss_n128<0>(s, smem_desc(q + 32 * kk")]),
    "attention: no P V products": ("k1", [(
        ATTENTION, "        wgmma_pv<DH>(o, p[kk],", "        if (kk < 0) wgmma_pv<DH>(o, p[kk],")]),
    "attention: no turns (the consumers issue S whenever ready)": ("k1", [(
        ATTENTION, "      named_sync(1 + cw, 256);\n", "      if (cw < 0) named_sync(1 + cw, 256);\n")]),
    "attention: no mask (the producer writes 0)": ("k1", [(
        ATTENTION, "next[j] = mask_add(mask, b, M, k0 + kHk + lane + 32 * j) * kLog2e;", "next[j] = 0.f;")]),
    "attention: ring of 2 stages": ("k1", [(ATTENTION, "kHStages = 3,", "kHStages = 2,")]),
    "attention: ring of 4 stages": ("k1", [(ATTENTION, "kHStages = 3,", "kHStages = 4,")]),
    "gemm: no epilogue (nothing stored)": ("k1", [(
        GEMM, "if (m0 + r < p.rows) epilogue8<EPI>(", "if (m0 + r < 0) epilogue8<EPI>(")]),
    "gemm: no products": ("k1", [(
        GEMM, "        wgmma_ss<BN, KN ? 1 : 0>(acc,", "        if (kk < 0) wgmma_ss<BN, KN ? 1 : 0>(acc,")]),
    "gemm: no weight loads (A's bytes only)": ("k1", [
        (GEMM, "        for (int j = 0; j < BN / 64; ++j)\n", "        for (int j = 0; j < 0; ++j)\n"),
        (GEMM, "mbar_arrive_tx(&full[stage], G::stage_bytes);", "mbar_arrive_tx(&full[stage], G::a_bytes);")]),
    # the bf16 attention backward (K10, and K5's attention): both passes at once
    "backward: no exps (the exp2 becomes its argument)": ("bwd", [
        (ATTN_BWD, "exp2_approx(fmaf(s[4 * j + e], lscale, (e & 1", "(fmaf(s[4 * j + e], lscale, (e & 1"),
        (ATTN_BWD, "exp2_approx(fmaf(s[4 * j + e], lscale, madd[", "(fmaf(s[4 * j + e], lscale, madd[")]),
    "backward: no S products": ("bwd", [
        (ATTN_BWD, "      issue_head_product<kBwAk, DH>(s, q_addr, k_addr);",
         "      if (it < 0) issue_head_product<kBwAk, DH>(s, q_addr, k_addr);"),
        (ATTN_BWD, "      issue_head_product<kBwBq, DH>(s, k_addr, q_addr);",
         "      if (qt < 0) issue_head_product<kBwBq, DH>(s, k_addr, q_addr);")]),
    "backward: no dP products": ("bwd", [
        (ATTN_BWD, "      issue_head_product<kBwAk, DH>(dp, g_addr, v_addr);",
         "      if (it < 0) issue_head_product<kBwAk, DH>(dp, g_addr, v_addr);"),
        (ATTN_BWD, "      issue_head_product<kBwBq, DH>(dp, v_addr, g_addr);",
         "      if (qt < 0) issue_head_product<kBwBq, DH>(dp, v_addr, g_addr);")]),
    "backward: no dQ, dK, dV products": ("bwd", [
        (ATTN_BWD, "          wgmma_pv<DH>(dq, f[kk],", "          if (kk < 0) wgmma_pv<DH>(dq, f[kk],"),
        (ATTN_BWD, "        wgmma_pv<DH>(dv, pf[kk],", "        if (kk < 0) wgmma_pv<DH>(dv, pf[kk],"),
        (ATTN_BWD, "        wgmma_pv<DH>(dk, sf[kk],", "        if (kk < 0) wgmma_pv<DH>(dk, sf[kk],")]),
    "backward: no sweep (K5 takes di from attn, as f32 does)": ("bwd", [
        (MESSAGE_BWD, "attention_backward_passes<T, sizeof(T) == 2>(", "attention_backward_passes<T, false>(")]),
    "backward: pass A ring of 2 stages": ("bwd", [(ATTN_BWD, "kBwAStages = 3,", "kBwAStages = 2,")]),
    "backward: pass B ring of 2 stages": ("bwd", [(ATTN_BWD, "kBwBStages = 4,", "kBwBStages = 2,")]),
    "backward: pass B query tiles of 64": ("bwd", [(ATTN_BWD, "kBwBq = 128,", "kBwBq = 64,")]),
    # three designs measured against the kept one (PERF.md)
    "backward: the consumers take turns issuing S and dP": ("bwd", [(ATTN_BWD, *e) for e in TURNS]),
    "backward: pass B forms dS^T before issuing dV's products": ("bwd", [(ATTN_BWD, *DS_FIRST)]),
    "backward: pass A waits for dQ's products under the next tile's S": ("bwd", [(ATTN_BWD, *e) for e in DQ_LATER]),
}
# K6: FAVOR-softmax's keys are never kept resident (same function)
K6_VARIANTS = {
    "k6: FAVOR-softmax keys staged in both sweeps": [(FEATURES, "    if (R.total <= kSmemCap) {",
                                                      "    if (R.total < 0) {")],
}
# the bf16 GEMM's tiles: the launch rule returns one tile's width first
RULE = "  const int sms = sm_count(), blocks = (rows + 63) / 64;\n"
TILES = {
    f"tile 64x{bn}": (GEMM, RULE, (f"  if (n_out % {bn} == 0) return {bn};\n" if bn > 64 else "  return 64;\n") + RULE)
    for bn in (256, 128, 64)
}

WORKER = r'''
import json, sys, torch
sys.path.insert(0, sys.argv[2])  # chip_smoke.py of the checkout
sys.path.insert(0, sys.argv[1])  # the edited package, ahead of the checkout's
import chip_smoke as cs
from openglue_tpu_torch.ops import kernels
kernels.SOURCES = {"bwd": ("attention", "attention_backward", "message_forward", "message_backward"),
                   "k6": ("gemm", "gnn_layer_features")}.get(sys.argv[4], ("attention", "gemm", "gnn_layer"))
kernels.build_all()
from openglue_tpu_torch.ops.kernels import attention_kernel as ak, gemm_kernel as gk, gnn_layer_kernel as glk
check = sys.argv[3] == "check"
gen = torch.Generator(device="cuda").manual_seed(0)
r = lambda *s: torch.randn(*s, generator=gen, device="cuda")
out = {}
K1_GEMMS = (("kv", 2, 1, "bias"), ("q", 1, 1, "bias"), ("out+concat", 1, 1, "concat"),
            ("ffn1", 2, 2, "relu_affine"), ("ffn2", 1, 2, "residual"))


def gemms(rows, dim, tag=""):
    for name, n_mul, k_mul, epi in K1_GEMMS:
        n_out, kk = n_mul * dim, k_mul * dim
        a, w, bias = r(rows, kk).bfloat16(), (r(n_out, kk) * kk**-0.5).bfloat16(), r(n_out)
        kw = dict(a=a, w=w, bias=bias, epilogue=epi, x=r(rows, n_out).bfloat16(), scale=1 + 0.1 * r(n_out),
                  shift=0.1 * r(n_out))
        if check:
            o, ref = gk.gemm(**kw), gk.gemm_plain(**kw)
            assert (o.float() - ref.float()).abs().max() <= 2.0**-7 * ref.float().abs().max()
        out[f"gemm {name}{tag}"] = cs.device_ms(lambda: gk.gemm(**kw))


with torch.no_grad():
    if sys.argv[4] == "bwd":  # K10 bf16 at chip_smoke.py's shapes, then K5 bf16 at D=256 and D=128
        for b, n, dh in ((12, 1024, 64), (4, 2048, 64), (12, 1024, 32)):
            q, k, v, g = (r(b, n, 4 * dh).bfloat16().view(b, n, 4, dh).transpose(1, 2) for _ in range(4))
            mask = torch.arange(n, device="cuda")[None] < torch.randint(n // 2, n + 1, (b,), generator=gen,
                                                                        device="cuda")[:, None]
            o, lse = ak.attention_forward(q, k, v, mask)
            if check:
                got, ref = ak.attention_backward(q, k, v, mask, g, o, lse), ak.attention_backward_plain(q, k, v, mask, g)
                for x, y in zip(got, ref):
                    assert (x.float() - y.float()).abs().max() <= 2.0**-6 * y.float().abs().max()
            out[f"K10 B={b} N={n} dh={dh}"] = cs.device_ms(lambda: ak.attention_backward(q, k, v, mask, g, o, lse))
        for dim in (256, 128):
            w = glk.MessageWeights(*[r(dim, dim) * dim**-0.5 if i % 2 == 0 else r(dim) for i in range(8)])
            xq, xkv, g = (r(12, 1024, dim).bfloat16() for _ in range(3))
            mask = torch.arange(1024, device="cuda")[None] < torch.randint(512, 1025, (12,), generator=gen,
                                                                           device="cuda")[:, None]
            _, attn, lse = glk.message_forward(xq, xkv, mask, w, 4, torch.bfloat16)
            out[f"K5 B=12 D={dim}"] = cs.device_ms(
                lambda: glk.message_backward(xq, xkv, mask, w, g, attn, lse, 4, torch.bfloat16))
        print(json.dumps(out))
        sys.exit(0)
    if sys.argv[4] == "k6":  # the FAVOR-softmax layer at B=16 N=M=1024, D=256 (F=128) and D=128 (F=64)
        from openglue_tpu_torch.ops.attention import sample_orthogonal_random_matrix
        for dtype, dim in ((torch.bfloat16, 256), (torch.float32, 256), (torch.bfloat16, 128), (torch.float32, 128)):
            tag, is_bf16, dh = f"{str(dtype)[6:]} D={dim}", dtype == torch.bfloat16, dim // 4
            w = cs.layer_weights(glk, dtype, gen, dim)
            xq, xkv, mask = cs.layer_inputs(dtype, gen, 16, 1024, dim)
            proj = sample_orthogonal_random_matrix(gen, 2 * dh, dh)
            run = lambda: glk.fused_attention_propagation(xq, xkv, mask, w, 4, False, "favor_softmax", proj)
            if check:
                o, ref = run(), glk.layer_plain(xq, xkv, mask, w, 4, False, "favor_softmax", proj)
                tol = 2.0**-7 * ref.float().abs().max() if is_bf16 else 1e-3
                assert (o.float() - ref.float()).abs().max() <= tol
            out[f"K6 favor_softmax {tag} resident"] = glk.kernel_feature_plan(16, 4, 1024, 1024, 2 * dh, dh, is_bf16,
                                                                              "favor_softmax")[0].resident
            out[f"K6 favor_softmax {tag}"] = cs.device_ms(run)
        print(json.dumps(out))
        sys.exit(0)
    if sys.argv[4] == "tiles":
        for rows, dim in ((16384, 256), (12288, 256), (4096, 128), (1024, 256)):
            gemms(rows, dim, f" {rows}x{dim}")
        print(json.dumps(out))
        sys.exit(0)
    for b in (16, 12):
        q = r(b, 1024, 256).bfloat16().view(b, 1024, 4, 64).transpose(1, 2)
        kv = r(b, 1024, 512).bfloat16()
        k, v = (kv[..., i:i + 256].view(b, 1024, 4, 64).transpose(1, 2) for i in (0, 256))
        counts = torch.randint(256, 1025, (b,), generator=gen, device="cuda")
        mask = torch.arange(1024, device="cuda")[None] < counts[:, None]
        if check:
            o, ref = ak.attention_forward(q, k, v, mask, False)[0], ak.attention_forward_plain(q, k, v, mask, False)[0]
            assert (o.float() - ref.float()).abs().max() <= 2.0**-7 * ref.float().abs().max()
        out[f"attention B={b}"] = cs.device_ms(lambda: ak.attention_forward(q, k, v, mask, False))
    gemms(16384, 256)
    out["gemm sum"] = sum(t for n, t in out.items() if n.startswith("gemm"))
    w = cs.layer_weights(glk, torch.bfloat16, gen, 256)
    xq, xkv, mask = cs.layer_inputs(torch.bfloat16, gen, 16, 1024, 256)
    out["K1 layer B=16"] = cs.device_ms(lambda: glk.fused_attention_propagation(xq, xkv, mask, w, 4))
print(json.dumps(out))
'''


def variant(repo: Path, name: str, edits) -> Path:
    """A copy of repo's package under build/ablations with ``edits`` made."""
    root = repo / "build" / "ablations" / "".join(c if c.isalnum() else "_" for c in name)[:48]
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(repo / "openglue_tpu_torch", root / "openglue_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for source, text, replacement in edits:
        path = root / source
        code = path.read_text()
        if code.count(text) != 1:
            raise SystemExit(f"{name}: the text to replace is not in {source} exactly once: {text!r}")
        path.write_text(code.replace(text, replacement))
    return root


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repo", type=Path, required=True, help="root of the checkout")
    parser.add_argument("--only", nargs="*", default=None,
                        help="ablation and tile names to run (default: all; each kind's unedited copy runs first)")
    args = parser.parse_args()
    repo = args.repo.resolve()
    wanted = lambda name: args.only is None or name in args.only
    runs = []
    for kind, first in (("k1", "unedited"), ("bwd", "unedited backward")):
        if any(wanted(name) and shapes == kind for name, (shapes, _) in ABLATIONS.items()):
            runs += [(first, [], kind, "check")]
            runs += [(name, edits, kind, "time") for name, (shapes, edits) in ABLATIONS.items()
                     if wanted(name) and shapes == kind]
    if any(wanted(name) for name in K6_VARIANTS):
        runs += [("unedited k6", [], "k6", "check")]
        runs += [(name, edits, "k6", "check") for name, edits in K6_VARIANTS.items() if wanted(name)]
    if any(wanted(name) for name in TILES):
        runs += [("the launch rule", [], "tiles", "check")]
        runs += [(name, [edit], "tiles", "check") for name, edit in TILES.items() if wanted(name)]
    for name, edits, shapes, check in runs:
        root = variant(repo, name, edits)
        done = subprocess.run([sys.executable, "-c", WORKER, str(root), str(repo), check, shapes],
                              capture_output=True, text=True, timeout=600)
        if done.returncode != 0:
            print(json.dumps({"variant": name, "failed": done.stderr[-2000:]}), flush=True)
            return 1
        times = json.loads(done.stdout.strip().splitlines()[-1])
        print(json.dumps({"variant": name, "ms": {k: round(v, 4) for k, v in times.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
