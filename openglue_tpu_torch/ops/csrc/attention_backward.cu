// Masked softmax attention backward on [B, H, N, dh] views (dh = 32 or 64)
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel openglue_tpu/ops/pallas/attention_kernel.py::
// _attention_bwd_kernel, reached through _backward from the custom VJP of
// masked_softmax_attention. From q, k, v, the cotangent g of the output, the
// forward's output o and its per-row LSE it computes, per head, in the
// operands' type T with f32 accumulation and the TPU kernel's rounding points:
//   P  = exp(q k^T * dh^-0.5 + mask - lse)                      (f32, one exp)
//   dP = g v^T;  dS = P o (dP - rowsum(dP o P))                 (f32)
//   dV = T(P)^T g;  dK = T(dS)^T q * scale;  dQ = T(dS) k * scale
// with dq, dk, dv written in T.
//
// It is also the backward of the LSE-emitting forward (kernel #12,
// _attention_kernel_lse, which the ring schedule of openglue_tpu/parallel/
// ring.py runs per key block): there the JAX package differentiates
// ops/attention.py::softmax_attention_with_lse in XLA, and the cotangent
// g_lse of the LSE, non-zero once blocks are merged, enters as
// dS = P o (dP - rowsum(dP o P) + g_lse), one subtraction from the row term in
// pass A; a fully masked element then takes dS = 0, as XLA's `where` gives.
//
// What bounds it on the H100: per head 5 N x M x dh products (S, dP, dV, dQ,
// dK), 10 N M D FLOP per batch element: at the training shape (B=12, H=4,
// N=M=1024) 3.2e10 FLOP against 50 MB (bf16), so the operations bound it:
// about 33 us at the bf16 tensor-core rate; in f32, whose products run as
// 3xTF32, 0.20 ms at 495/3 TFLOP/s of f32-accurate product (0.48 ms at the
// f32 FMA rate).
//
// Design: the TPU kernel takes one grid step per (batch, head) with P and dP
// [N, M] in VMEM, and its caller sends graphs that do not fit to an XLA
// backward. A CTA cannot hold [N, M]; the two tiled passes of
// attention_backward.cuh need no such block, so any N and M run here. The
// row sums rowsum(dP o P) equal rowsum(g o o) and are taken from the saved
// output in pass A's prologue, P comes from the saved LSE, and S and dP are
// recomputed in each pass (7 N x M x dh products per head against the TPU
// kernel's 5). Every sum stays inside one CTA: no atomics, equal bits on two
// runs. Operands are read through their strides, as in the forward. bf16:
// both passes are wgmma on TMA tiles, a producer warp and two consumer
// warpgroups per CTA, persistent over 128-row blocks, P and dS fed to their
// products from registers (attention_backward.cuh); f32: 3xTF32 mma.sync.

#include "attention_backward.cuh"

namespace {

HeadLayout layout(const long long* s) { return {s[0], s[1], s[2]}; }

template <typename T>
int backward(int B, int H, int N, int M, int dh, const void* const* in, const void* mask,
             const void* dead, const float* lse, const float* g_lse, int zero_dead_ds, float* di,
             void* const* out, const long long* st, cudaStream_t s) {
  AttnBwdArgs<T> a;
  a.q = static_cast<const T*>(in[0]); a.k = static_cast<const T*>(in[1]);
  a.v = static_cast<const T*>(in[2]); a.g = static_cast<const T*>(in[3]);
  a.out = static_cast<const T*>(in[4]);
  a.lq = layout(st); a.lk = layout(st + 3); a.lv = layout(st + 6); a.lg = layout(st + 9);
  a.lo = layout(st + 12);
  a.mask = static_cast<const uint8_t*>(mask);
  a.dead = static_cast<const uint8_t*>(dead);
  a.lse = lse; a.di = di; a.N = N; a.M = M;
  a.g_lse = g_lse; a.zero_dead_ds = zero_dead_ds; a.dead_p_one = 0;
  a.dq = static_cast<T*>(out[0]); a.dq32 = nullptr; a.ldq = layout(st + 15);
  a.dk = static_cast<T*>(out[1]); a.dv = static_cast<T*>(out[2]); a.ldkv = layout(st + 18);
  a.dk32 = nullptr; a.dv32 = nullptr; a.ldkv32 = a.ldkv;
  return attention_backward_passes(a, B, H, dh, s);
}

}  // namespace

// One attention backward. is_bf16 selects the type T of every operand; dh,
// the head width, is 32 or 64.
// inputs: q, k, v, g (the cotangent of out), out; outputs: dq, dk, dv.
// strides: the (batch, head, row) strides in elements of q, k, v, g, out, dq
// and of dk and dv (which share one layout), 21 values; the last axis (dh
// wide) is contiguous. mask: [B, M] uint8 or null; dead: [B] uint8 or null,
// 1 where every key of the element is masked. lse: [B, H, N] f32 from the
// forward; row_sums: [B, H, N] f32 scratch. g_lse: [B, H, N] f32, the
// cotangent of the forward's LSE, or null; with it, a dead element takes
// dS = 0 (the LSE-emitting forward's backward). Returns the CUDA error code of
// the launches (0 on success).
extern "C" int og_attention_backward(int is_bf16, int B, int H, int N, int M, int dh,
                                     const void* const* inputs, const void* mask, const void* dead,
                                     const void* lse, const void* g_lse, void* row_sums,
                                     void* const* outputs, const long long* strides, void* stream) {
  if (B <= 0 || H <= 0 || N <= 0 || M <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* gl = static_cast<const float*>(g_lse);
  const int zero_dead_ds = gl != nullptr;
  float* di = static_cast<float*>(row_sums);
  if (is_bf16) return backward<bf16>(B, H, N, M, dh, inputs, mask, dead, l, gl, zero_dead_ds, di, outputs, strides, s);
  return backward<float>(B, H, N, M, dh, inputs, mask, dead, l, gl, zero_dead_ds, di, outputs, strides, s);
}
