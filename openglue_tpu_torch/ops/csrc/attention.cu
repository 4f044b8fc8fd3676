// Masked softmax attention forward on [B, H, N, dh] views for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel openglue_tpu/ops/pallas/attention_kernel.py::
// _attention_kernel, reached through _forward and masked_softmax_attention
// (the composed multi-head attention with use_pallas). For q [B, H, N, dh] and
// k, v [B, H, M, dh] with dh = 32 or 64 it computes, in the operands' type T with
// f32 accumulation,
//   logits = (q . k) * dh^-0.5 + (mask ? 0 : -1e9)                      (f32)
//   out    = T((T(exp(logits - max)) . v) / sum exp(logits - max))
// and, when the caller differentiates, the per-row lse = max + log(sum) that
// the backward kernel (attention_backward.cu) rebuilds the probabilities from.
//
// What bounds it on the H100: at the training shape (B=12, H=4, N=M=1024) it
// is 1.3e10 FLOP against 25 MB (bf16) of q, k, v and out, so the operations
// bound it: about 13 us at the bf16 tensor-core rate. In f32 the products
// run as 3xTF32 (three TF32 products per f32 product, f32 accuracy), about
// 78 us at the TF32 rate (495/3 TFLOP/s of f32-accurate product), against
// 0.19 ms at the f32 FMA rate.
//
// Design: the TPU kernel holds a whole [BQ, M] score block in VMEM and takes
// one exact softmax per row. Here the flash-style kernels of attention.cuh
// stream key tiles through shared memory with an f32 running max and sum. In
// bf16: 128 queries per CTA in two consumer warpgroups that take turns on the
// tensor cores (wgmma), 128-key K/V tiles that a producer warp loads by TMA
// into an mbarrier ring, exp2 on the MUFU overlapped with the products. In
// f32: one CTA per batch element, head and 64-query block, mma.sync TF32 on
// hi/lo splits made once per staged tile (tf32_tiles.cuh). The multi-head
// attention's q, k and v are [B, L, D] projections seen through a transpose:
// the kernel takes every operand by its strides (TMA tensor maps of four
// dimensions in bf16), so it reads them where they lie and writes out the
// same way, without a copy. Keys past M take no weight; a fully masked key
// set averages over the M keys.

#include "attention.cuh"

namespace {

HeadLayout layout(const long long* s) { return {s[0], s[1], s[2]}; }

template <typename T>
int forward(int B, int H, int N, int M, int dh, const void* q, const void* k, const void* v,
            const void* mask, void* out, void* lse, const long long* st, cudaStream_t s) {
  return attention_views<T>(static_cast<const T*>(q), static_cast<const T*>(k),
                            static_cast<const T*>(v), static_cast<const uint8_t*>(mask),
                            static_cast<T*>(out), static_cast<float*>(lse), B, N, M, H, dh, layout(st),
                            layout(st + 3), layout(st + 6), layout(st + 9), s);
}

}  // namespace

// One attention forward. is_bf16 selects the type T of q, k, v and out; dh,
// the head width, is 32 or 64. strides: the (batch, head, row) strides in
// elements of q, k, v and out, 12 values; the last axis (dh wide) is
// contiguous. mask: [B, M] uint8 or null.
// lse: [B, H, N] f32 or null. Returns the CUDA error code of the launch (0 on
// success).
extern "C" int og_attention(int is_bf16, int B, int H, int N, int M, int dh, const void* q, const void* k,
                            const void* v, const void* mask, void* out, void* lse,
                            const long long* strides, void* stream) {
  if (B == 0 || N == 0) return cudaSuccess;
  if (H <= 0 || M <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return forward<bf16>(B, H, N, M, dh, q, k, v, mask, out, lse, strides, s);
  return forward<float>(B, H, N, M, dh, q, k, v, mask, out, lse, strides, s);
}
