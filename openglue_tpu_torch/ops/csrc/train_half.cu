// Train-mode layer half for Hopper (sm_90a): the attention message and the
// FFN's first dense + ReLU.
//
// Replaces the Pallas TPU kernel openglue_tpu/ops/pallas/gnn_layer_kernel.py::
// _train_half_kernel (with save_stats), reached through _train_half_forward
// and fused_train_layer_half. For x_q [B, N, D] and x_kv [B, M, D] with H
// heads of dh = 32 or 64 it computes, in the compute type T with f32 accumulation,
//   q, k, v = T(x W + b)
//   logits  = (q_h . k_h) * dh^-0.5 + (mask ? 0 : -1e9)        (f32)
//   attn_h  = T((T(exp(logits - max)) . v_h) / sum exp(logits - max))
//   lse_h   = max + log(sum exp(logits - max))                 (f32)
//   msg     = T(attn Wo + bo);  cat = [x_q, msg] or [T(x_q - msg), msg]
//   z       = T(relu(cat W1 + b1))
// and returns z (the hidden before the train-mode BatchNorm), attn and lse.
// The backward peels dense + ReLU off the cotangent in torch and ends in the
// message backward kernel (message_backward.cu), which takes attn and lse.
//
// What bounds it on the H100: at the training shape (B=12, N=M=1024, D=256)
// it is 16 N D^2 + 4 N M D = 2.6e10 FLOP per call against about 38 MB (bf16)
// of activations, so the operations bound it: about 26 us at the bf16
// tensor-core rate, 0.16 ms at 165 TFLOP/s in f32 as 3xTF32 (the rate of
// its f32 products: the four GEMMs of gemm.cuh and the attention of
// tf32_tiles.cuh), 0.39 ms at the f32 FMA rate.
//
// Design: the message forward's four launches (message_forward.cu: the k+v
// GEMM over the stacked weights, the q GEMM, the flash-style attention writing
// attn and the LSE) with the out projection's epilogue forming the concat in
// the workspace (msg rounded to T first, as the TPU kernel does), then one
// GEMM over the concat with the bias and a ReLU that keeps NaN. The concat
// stays in L2 between the two launches.

#include "attention.cuh"
#include "gemm.cuh"

namespace {

template <typename T>
struct Buffers {
  T *q, *kv, *cat;
};

template <typename T>
Buffers<T> carve(Carve& ws, int B, int N, int M, int D) {
  Buffers<T> b;
  b.q = ws.take<T>(static_cast<size_t>(B) * N * D);
  b.kv = ws.take<T>(static_cast<size_t>(B) * M * 2 * D);
  b.cat = ws.take<T>(static_cast<size_t>(B) * N * 2 * D);
  return b;
}

template <typename T>
int train_half(int B, int N, int M, int D, int H, int use_offset, const void* xq_, const void* xkv_,
               const void* mask_, const void* const* w, const float* const* f, void* ws_, void* z_,
               void* attn_, float* lse, cudaStream_t s) {
  const T* xq = static_cast<const T*>(xq_);
  const T* xkv = static_cast<const T*>(xkv_);
  const uint8_t* mask = static_cast<const uint8_t*>(mask_);
  const T *wq = static_cast<const T*>(w[0]), *wk = static_cast<const T*>(w[1]),
          *wv = static_cast<const T*>(w[2]), *wo = static_cast<const T*>(w[3]),
          *w1 = static_cast<const T*>(w[4]);
  const float *bq = f[0], *bk = f[1], *bv = f[2], *bo = f[3], *b1 = f[4];
  Carve ws{static_cast<char*>(ws_)};
  const Buffers<T> bf = carve<T>(ws, B, N, M, D);
  T* attn = static_cast<T*>(attn_);
  T* z = static_cast<T*>(z_);
  const int nq = B * N, nk = B * M;
  cudaError_t err;
  if ((err = gemm<T, kBias>({xkv, D, wk, bk, nk, 2 * D, D, bf.kv, 2 * D, nullptr, 0, nullptr, nullptr, 0, wv, bv, D}, s))) return err;
  if ((err = gemm<T, kBias>({xq, D, wq, bq, nq, D, D, bf.q, D, nullptr, 0, nullptr, nullptr, 0}, s))) return err;
  if ((err = attention<T>(bf.q, bf.kv, bf.kv + D, mask, attn, lse, B, N, M, D, H, D, 2 * D, s))) return err;
  // out projection with the concat [x_q, msg] / [x_q - msg, msg], then dense + ReLU
  if ((err = gemm<T, kConcat>({attn, D, wo, bo, nq, D, D, bf.cat, 2 * D, xq, D, nullptr, nullptr, use_offset}, s))) return err;
  return gemm<T, kRelu>({bf.cat, 2 * D, w1, b1, nq, 2 * D, 2 * D, z, 2 * D, nullptr, 0, nullptr, nullptr, 0}, s);
}

}  // namespace

// Bytes of workspace og_train_half needs.
extern "C" size_t og_train_half_workspace(int is_bf16, int B, int N, int M, int D) {
  Carve ws{nullptr};
  if (is_bf16) carve<bf16>(ws, B, N, M, D);
  else carve<float>(ws, B, N, M, D);
  return ws.used;
}

// One layer half. is_bf16 selects the compute type T of x and the weights.
// weights (T, torch layout [out, in]): wq, wk, wv, wo [D, D], w1 [2D, 2D]; f32
// biases bq, bk, bv, bo [D], b1 [2D]. mask: [B, M] uint8 or null. Outputs: z
// (T, [B, N, 2D]), attn (T, [B, N, D]) and lse (f32, [B, H, N]). D = dh * H with dh 32 or 64.
// Returns the CUDA error code of the launches (0 on success).
extern "C" int og_train_half(int is_bf16, int B, int N, int M, int D, int H, int use_offset,
                             const void* xq, const void* xkv, const void* mask,
                             const void* const* weights, const void* const* biases,
                             void* workspace, void* z, void* attn, void* lse, void* stream) {
  if (B == 0 || N == 0) return cudaSuccess;
  if (!head_width_ok(D, H) || M <= 0) return cudaErrorInvalidValue;
  const float* const* f = reinterpret_cast<const float* const*>(biases);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (is_bf16)
    return train_half<bf16>(B, N, M, D, H, use_offset, xq, xkv, mask, weights, f, workspace, z, attn, l, s);
  return train_half<float>(B, N, M, D, H, use_offset, xq, xkv, mask, weights, f, workspace, z, attn, l, s);
}
