// Attention-half forward of a train-mode propagation layer for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel openglue_tpu/ops/pallas/gnn_layer_kernel.py::
// _message_kernel (with save_stats), reached through _message_forward and
// fused_attention_message. For x_q [B, N, D] and x_kv [B, M, D] with H heads
// of dh = 32 or 64 it computes, in the compute type T with f32 accumulation,
//   q, k, v = T(x W + b)
//   logits  = (q_h . k_h) * dh^-0.5 + (mask ? 0 : -1e9)        (f32)
//   attn_h  = T((T(exp(logits - max)) . v_h) / sum exp(logits - max))
//   lse_h   = max + log(sum exp(logits - max))                 (f32)
//   msg     = T(attn Wo + bo)
// and returns msg, attn and lse: the backward (message_backward.cu) rebuilds
// the probabilities from lse with one exp and takes dWo from attn.
//
// What bounds it on the H100: at the training shape (B=12, N=M=1024, D=256)
// it is 1.9e10 FLOP against about 25 MB of activations in and out, so the
// tensor cores bound it (about 20 us at 989 TFLOP/s bf16, 0.12 ms at 165
// TFLOP/s in f32 as 3xTF32).
//
// Design: the first two thirds of the eval layer kernel (gnn_layer.cu), from
// the same device code: the k+v GEMM over the stacked [wk; wv] and the q GEMM
// write to global memory (they stay in L2), the flash-style attention kernel
// writes attn and the per-row LSE, and the out projection is the tiled GEMM
// with a bias epilogue. mma.sync with cp.async double buffering in bf16; in
// f32 every product runs in 3xTF32 on the tensor cores, the three GEMMs
// (8 N D^2 of the 8 N D^2 + 4 N M D FLOP, 0.039 ms of the 0.117 ms bound) from
// a three-stage cp.async ring of raw f32 tiles (gemm.cuh); wgmma and TMA are
// later work.

#include "attention.cuh"
#include "gemm.cuh"

namespace {

template <typename T>
int message_forward(int B, int N, int M, int D, int H, const void* xq_, const void* xkv_,
                    const void* mask_, const void* const* w, const float* const* f, void* ws_,
                    void* msg_, void* attn_, float* lse, cudaStream_t s) {
  const T* xq = static_cast<const T*>(xq_);
  const T* xkv = static_cast<const T*>(xkv_);
  const uint8_t* mask = static_cast<const uint8_t*>(mask_);
  const T *wq = static_cast<const T*>(w[0]), *wk = static_cast<const T*>(w[1]),
          *wv = static_cast<const T*>(w[2]), *wo = static_cast<const T*>(w[3]);
  const float *bq = f[0], *bk = f[1], *bv = f[2], *bo = f[3];
  Carve ws{static_cast<char*>(ws_)};
  T* q = ws.take<T>(static_cast<size_t>(B) * N * D);
  T* kv = ws.take<T>(static_cast<size_t>(B) * M * 2 * D);
  T* attn = static_cast<T*>(attn_);
  T* msg = static_cast<T*>(msg_);
  const int nq = B * N, nk = B * M;
  cudaError_t err;
  if ((err = gemm<T, kBias>({xkv, D, wk, bk, nk, 2 * D, D, kv, 2 * D, nullptr, 0, nullptr, nullptr, 0, wv, bv, D}, s))) return err;
  if ((err = gemm<T, kBias>({xq, D, wq, bq, nq, D, D, q, D, nullptr, 0, nullptr, nullptr, 0}, s))) return err;
  if ((err = attention<T>(q, kv, kv + D, mask, attn, lse, B, N, M, D, H, D, 2 * D, s))) return err;
  return gemm<T, kBias>({attn, D, wo, bo, nq, D, D, msg, D, nullptr, 0, nullptr, nullptr, 0}, s);
}

size_t workspace_bytes(int B, int N, int M, int D, size_t elt) {
  Carve ws{nullptr};
  ws.take<char>(static_cast<size_t>(B) * N * D * elt);
  ws.take<char>(static_cast<size_t>(B) * M * 2 * D * elt);
  return ws.used;
}

}  // namespace

// Bytes of workspace og_message_forward needs.
extern "C" size_t og_message_forward_workspace(int is_bf16, int B, int N, int M, int D) {
  return workspace_bytes(B, N, M, D, is_bf16 ? 2 : 4);
}

// One attention half. is_bf16 selects the compute type T of x and the weights.
// weights (T, torch layout [out, in]): wq, wk, wv, wo [D, D]; f32 biases
// bq, bk, bv, bo [D]. mask: [B, M] uint8 or null. Outputs: msg, attn (T,
// [B, N, D]) and lse (f32, [B, H, N]). D = dh * H with dh 32 or 64.
// Returns the CUDA error code of the launches (0 on success).
extern "C" int og_message_forward(int is_bf16, int B, int N, int M, int D, int H,
                                  const void* xq, const void* xkv, const void* mask,
                                  const void* const* weights, const void* const* biases,
                                  void* workspace, void* msg, void* attn, void* lse,
                                  void* stream) {
  if (B == 0 || N == 0) return cudaSuccess;
  if (!head_width_ok(D, H) || M <= 0) return cudaErrorInvalidValue;
  const float* const* f = reinterpret_cast<const float* const*>(biases);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (is_bf16)
    return message_forward<bf16>(B, N, M, D, H, xq, xkv, mask, weights, f, workspace, msg, attn, l, s);
  return message_forward<float>(B, N, M, D, H, xq, xkv, mask, weights, f, workspace, msg, attn, l, s);
}
