// One eval-mode attentional-propagation layer (softmax attention) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel openglue_tpu/ops/pallas/gnn_layer_kernel.py::
// _layer_kernel (softmax kind), reached through fused_attention_propagation. It
// computes, for x_q [B, N, D] and x_kv [B, M, D] with H heads of dh = 32 or 64:
//   q, k, v = T(x W + b)                         (T: the compute type)
//   logits  = (q_h . k_h) * dh^-0.5 + (mask ? 0 : -1e9)        (f32)
//   attn_h  = T((T(exp(logits - max)) . v_h) / sum exp(logits - max))
//   msg     = T(attn Wo + bo);  cat = [x_q, msg] or [T(x_q - msg), msg]
//   h1      = T(relu(cat W1 + b1) * a1 + c1)     (eval BatchNorm folded to a1, c1)
//   out     = T(x_q + (h1 W2 + b2))
// in bf16 (wgmma on TMA tiles, f32 accumulation) or f32 (every product in
// 3xTF32 on the tensor cores: the GEMMs of gemm.cuh and the attention of
// tf32_tiles.cuh), keeping the TPU kernel's rounding points.
//
// What bounds it on the H100: at the serving shape (B=16, N=M=1024, D=256) the
// layer is 3.9e10 FLOP against 64 MB of activations in and out, so the tensor
// cores bound it as a whole (about 39 us at 989 TFLOP/s bf16, 0.23 ms at 165
// TFLOP/s in f32 as 3xTF32). Launch by launch, the five bf16 GEMMs are bound by
// their bytes (143 MB per layer, 43 us) and the attention by its operations
// and its exps (17 us of products, about as long again on the exp unit).
//
// Design: the TPU kernel keeps K/V of the whole key set in VMEM (about 1 MB at
// M=1024, D=256) and runs one exact softmax pass per query block. An SM has 227
// KB, so here the layer is six launches on one stream: the k and v projections
// (one GEMM on stacked weights) and the q projection write to global memory
// (they stay in the 50 MB L2); a flash-style attention kernel streams K/V
// tiles through shared memory with an f32 running max and sum; the out
// projection and both FFN products run in the same GEMM kernel, whose
// epilogue fuses the bias, the concat (with or without the offset), the ReLU
// and folded BatchNorm, and the residual add with the output cast. The
// launches are separate because the projections of all keys must exist
// before any query block attends to them. In bf16 both kernels are Hopper's
// (gemm.cuh, attention.cuh): a producer warp keeps TMA loads in flight in an
// mbarrier ring, consumer warpgroups issue wgmma; both are persistent, the
// GEMM with tiles of 64 x 256 at most that two consumers take in turn, the
// attention with 128 queries per tile in two ping-ponging warpgroups
// (FlashAttention-3's shape).

#include "attention.cuh"
#include "gemm.cuh"

namespace {

template <typename T>
int layer(int B, int N, int M, int D, int H, int use_offset, const void* xq_, const void* xkv_,
          const void* mask_, const void* const* w, const float* const* f, void* ws_,
          void* out_, cudaStream_t s) {
  const T* xq = static_cast<const T*>(xq_);
  const T* xkv = static_cast<const T*>(xkv_);
  const uint8_t* mask = static_cast<const uint8_t*>(mask_);
  const T *wq = static_cast<const T*>(w[0]), *wk = static_cast<const T*>(w[1]),
          *wv = static_cast<const T*>(w[2]), *wo = static_cast<const T*>(w[3]),
          *w1 = static_cast<const T*>(w[4]), *w2 = static_cast<const T*>(w[5]);
  const float *bq = f[0], *bk = f[1], *bv = f[2], *bo = f[3], *b1 = f[4], *a1 = f[5], *c1 = f[6],
              *b2 = f[7];
  const size_t rq = static_cast<size_t>(B) * N, rk = static_cast<size_t>(B) * M;
  // one workspace: q [rq, D], kv [rk, 2D], attn [rq, D], cat [rq, 2D], h1 [rq, 2D]
  T* q = static_cast<T*>(ws_);
  T* kv = q + rq * D;
  T* attn = kv + rk * 2 * D;
  T* cat = attn + rq * D;
  T* h1 = cat + rq * 2 * D;
  T* out = static_cast<T*>(out_);
  const int nq = B * N, nk = B * M;
  cudaError_t err;
  // k and v projections as one GEMM over [wk; wv], then q
  if ((err = gemm<T, kBias>({xkv, D, wk, bk, nk, 2 * D, D, kv, 2 * D, nullptr, 0, nullptr, nullptr, 0, wv, bv, D}, s))) return err;
  if ((err = gemm<T, kBias>({xq, D, wq, bq, nq, D, D, q, D, nullptr, 0, nullptr, nullptr, 0}, s))) return err;
  if ((err = attention<T>(q, kv, kv + D, mask, attn, nullptr, B, N, M, D, H, D, 2 * D, s))) return err;
  // out projection with the concat [x_q, msg] / [x_q - msg, msg]
  if ((err = gemm<T, kConcat>({attn, D, wo, bo, nq, D, D, cat, 2 * D, xq, D, nullptr, nullptr, use_offset}, s))) return err;
  // FFN: dense -> ReLU -> folded BN, then dense + residual
  if ((err = gemm<T, kReluAffine>({cat, 2 * D, w1, b1, nq, 2 * D, 2 * D, h1, 2 * D, nullptr, 0, a1, c1, 0}, s))) return err;
  return gemm<T, kResidual>({h1, 2 * D, w2, b2, nq, D, 2 * D, out, D, xq, D, nullptr, nullptr, 0}, s);
}

}  // namespace

// One layer. is_bf16 selects the compute type T of x and the weights.
// weights (T, [out, in]): wq, wk, wv, wo [D, D], w1 [2D, 2D], w2 [D, 2D].
// f32 vectors: bq, bk, bv, bo [D], b1, a1, c1 [2D], b2 [D]. workspace (T): B*N*6*D + B*M*2*D elements; out (T): [B, N, D].
// mask: [B, M] uint8 or null. D = dh * H with dh 32 or 64.
// Returns the CUDA error code of the launches (0 on success).
extern "C" int og_gnn_layer(int is_bf16, int B, int N, int M, int D, int H, int use_offset,
                            const void* xq, const void* xkv, const void* mask,
                            const void* const* weights, const void* const* vectors,
                            void* workspace, void* out, void* stream) {
  if (B == 0 || N == 0) return cudaSuccess;
  if (!head_width_ok(D, H) || D % 64 != 0 || M <= 0) return cudaErrorInvalidValue;
  const float* const* f = reinterpret_cast<const float* const*>(vectors);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return layer<bf16>(B, N, M, D, H, use_offset, xq, xkv, mask, weights, f, workspace, out, s);
  return layer<float>(B, N, M, D, H, use_offset, xq, xkv, mask, weights, f, workspace, out, s);
}
