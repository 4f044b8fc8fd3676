// Attention-half backward of a train-mode propagation layer for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel openglue_tpu/ops/pallas/gnn_layer_kernel.py::
// _message_bwd_kernel, reached through _message_backward from the custom VJP
// of fused_attention_message. From the forward's saved attn and per-row LSE
// and the cotangent g of msg it computes, in the compute type T with f32
// accumulation and the TPU kernel's rounding points:
//   q, k, v  = T(x W + b)                       (recomputed)
//   dattn    = T(T(g) Wo)                         dWo = T(g)^T attn, dbo = colsum(g)
//   per head:  P   = exp(q_h k_h^T * dh^-0.5 + mask - lse)      (f32, one exp)
//              dP  = dattn_h v_h^T                              (f32)
//              dS  = P o (dP - rowsum(dP o P))                  (f32)
//              dV  = T(P)^T dattn_h;  dK = T(dS)^T q_h * scale; dQ = T(dS) k_h * scale
//   dx_q  = T(dQ) Wq,  dx_kv = T(dK) Wk + T(dV) Wv
//   dW{q,k,v} = T(d{q,k,v})^T x,  db{q,k,v} = colsum(d{q,k,v})    (f32)
//
// What bounds it on the H100: at the training shape (B=12, N=M=1024, D=256)
// the backward is 5.0e10 FLOP per call against about 40 MB of activations, so
// the tensor cores bound it (about 50 us at 989 TFLOP/s bf16, 0.30 ms at
// 165 TFLOP/s in f32 as 3xTF32). Per element it
// needs 11 N x D x D products (q, k, v recomputed, dattn, dWo, dx_q, dx_kv as
// two, dWq, dWk, dWv: 22 N D^2 FLOP) and per head 5 N x M x dh products (S,
// dP, dV, dQ, dK: 10 N M D FLOP over the heads).
//
// Design. The TPU kernel walks query blocks in order and accumulates dK/dV
// and all eight weight gradients into one output across the grid, which is
// safe only because a TPU grid runs in order. Here nothing races and nothing
// uses float atomics:
// * recompute q and k+v with the forward's GEMMs; dattn = g Wo, dx_q and
//   dx_kv take the weights as stored ([out, in]) through the GEMM's KN mode;
// * attention backward in two passes (attention_backward.cuh). Pass A takes
//   a block of queries (and head): in f32 it takes rowsum(dP o P) from the
//   saved attn as rowsum(dattn o attn); in bf16, where attn is rounded, a
//   first sweep over the key tiles sums it. Then it recomputes P and dP,
//   forms dS and accumulates dQ in registers. Pass B takes a block of keys:
//   it sweeps the query tiles with the saved LSE and pass A's row sums and
//   accumulates dK and dV in registers. S and dP are recomputed
//   in each pass (7 N x M x dh products per head in f32, 9 in bf16, against
//   the TPU kernel's 5); that keeps every sum inside one CTA. In an element
//   with every key masked the TPU kernel's f32 LSE sits at -1e9 and has lost
//   log M, so it rebuilds P = 1 on every key: the passes take that element's
//   P as 1 (`dead_p_one`);
// * dx_q = dQ Wq and dx_kv = [dK | dV] [Wk; Wv], the stacked weight read
//   from its two parts;
// * the weight gradients are one batched split-K GEMM (tn_gemm.cuh: X^T Y
//   over the B*N or B*M rows) into per-split f32 partials, summed in a fixed
//   order by a second kernel; the bias gradients are column sums done the
//   same way.
// bf16 runs wgmma on TMA tiles: the dense GEMMs (gemm.cuh) and both attention
// passes, each a producer warp and two consumer warpgroups, persistent. In
// f32 every product runs in 3xTF32 on the tensor cores: the attention passes
// on hi/lo tiles split once per tile (tf32_tiles.cuh), the five dense GEMMs (gemm.cuh) and
// the weight gradients (tn_gemm.cuh) on raw f32 tiles from a three-stage
// cp.async ring, split per fragment. The dense products are 22 N D^2 of the
// 22 N D^2 + 10 N M D FLOP: a third at this shape.

#include "attention_backward.cuh"
#include "gemm.cuh"
#include "tn_gemm.cuh"

namespace {

// ------------------------------------------------ bias gradients: column sums
struct ColProblem {
  const void* src; int ld; int rows; int is_bf16;
};
struct ColArgs {
  ColProblem p[4];
  int cols, chunk, splits;
  float* partial;  // [problem][split][cols]
};

constexpr int kColThreads = 128;

__global__ void __launch_bounds__(kColThreads) colsum_partial(ColArgs a) {
  const ColProblem pr = a.p[blockIdx.z];
  const int col = blockIdx.x * kColThreads + threadIdx.x;
  if (col >= a.cols) return;
  const int r_begin = blockIdx.y * a.chunk, r_end = min(pr.rows, r_begin + a.chunk);
  float s = 0.f;
  for (int r = r_begin; r < r_end; ++r) {
    const size_t at = static_cast<size_t>(r) * pr.ld + col;
    s += pr.is_bf16 ? to_f(static_cast<const bf16*>(pr.src)[at]) : static_cast<const float*>(pr.src)[at];
  }
  a.partial[(static_cast<size_t>(blockIdx.z) * a.splits + blockIdx.y) * a.cols + col] = s;
}

// ------------------------------------------------ host side
struct Plan {
  TnPlan tn;
  int col_splits, col_chunk;
};

template <typename T>
Plan plan(int B, int N, int M, int D) {
  const int rows = B * (N > M ? N : M);
  Plan p;
  p.tn = tn_plan<T>(rows, D, D, 4);
  p.col_chunk = 128;
  p.col_splits = (rows + p.col_chunk - 1) / p.col_chunk;
  return p;
}

template <typename T>
struct Buffers {
  T *q, *kv, *dA, *dqc, *dkvc;
  float *di, *dq32, *dk32, *dv32, *tn_partial, *col_partial;
};

template <typename T>
Buffers<T> carve(Carve& ws, int B, int N, int M, int D, int H, const Plan& pl) {
  const size_t nq = static_cast<size_t>(B) * N, nk = static_cast<size_t>(B) * M;
  Buffers<T> b;
  b.q = ws.take<T>(nq * D);
  b.kv = ws.take<T>(nk * 2 * D);
  b.dA = ws.take<T>(nq * D);
  b.dqc = ws.take<T>(nq * D);
  b.dkvc = ws.take<T>(nk * 2 * D);
  b.di = ws.take<float>(nq * H);
  b.dq32 = ws.take<float>(nq * D);
  b.dk32 = ws.take<float>(nk * D);
  b.dv32 = ws.take<float>(nk * D);
  b.tn_partial = ws.take<float>(static_cast<size_t>(4) * pl.tn.splits * D * D);
  b.col_partial = ws.take<float>(static_cast<size_t>(4) * pl.col_splits * D);
  return b;
}

template <typename T>
int message_backward(int B, int N, int M, int D, int H, const void* xq_, const void* xkv_,
                     const void* mask_, const void* dead, const void* g_, const void* attn_, const float* lse,
                     const void* const* w, const float* const* f, void* const* o, void* ws_,
                     cudaStream_t s) {
  const T* xq = static_cast<const T*>(xq_);
  const T* xkv = static_cast<const T*>(xkv_);
  const T* g = static_cast<const T*>(g_);
  const T* attn = static_cast<const T*>(attn_);
  const uint8_t* mask = static_cast<const uint8_t*>(mask_);
  // torch layout [out, in]: the recomputed projections read them as the
  // forward does, the input gradients (KN GEMMs) as [k, n_out] matrices
  const T *wq = static_cast<const T*>(w[0]), *wk = static_cast<const T*>(w[1]),
          *wv = static_cast<const T*>(w[2]), *wo = static_cast<const T*>(w[3]);
  const float *bq = f[0], *bk = f[1], *bv = f[2];
  T* dxq = static_cast<T*>(o[0]);
  T* dxkv = static_cast<T*>(o[1]);
  const Plan pl = plan<T>(B, N, M, D);
  Carve ws{static_cast<char*>(ws_)};
  const Buffers<T> bf = carve<T>(ws, B, N, M, D, H, pl);
  const int nq = B * N, nk = B * M;
  cudaError_t err;

  // recompute k, v and q; dattn = T(g Wo)
  if ((err = gemm<T, kBias>({xkv, D, wk, bk, nk, 2 * D, D, bf.kv, 2 * D, nullptr, 0, nullptr, nullptr, 0, wv, bv, D}, s))) return err;
  if ((err = gemm<T, kBias>({xq, D, wq, bq, nq, D, D, bf.q, D, nullptr, 0, nullptr, nullptr, 0}, s))) return err;
  if ((err = gemm<T, kBias, true>({g, D, wo, nullptr, nq, D, D, bf.dA, D, nullptr, 0, nullptr, nullptr, 0}, s))) return err;

  // attention backward: pass A (row sums, dQ), then pass B (dK, dV)
  // (the compute-type dK and dV are the column halves of dkvc)
  const int dh = D / H;
  const HeadLayout lq = column_heads(N, D, dh), lkv = column_heads(M, 2 * D, dh), lk32 = column_heads(M, D, dh);
  AttnBwdArgs<T> ab;
  ab.q = bf.q; ab.g = bf.dA; ab.k = bf.kv; ab.v = bf.kv + D; ab.out = attn;
  ab.lq = lq; ab.lg = lq; ab.lk = lkv; ab.lv = lkv; ab.lo = lq;
  ab.mask = mask; ab.dead = static_cast<const uint8_t*>(dead); ab.lse = lse; ab.di = bf.di;
  ab.g_lse = nullptr; ab.zero_dead_ds = 0; ab.dead_p_one = 1;
  ab.N = N; ab.M = M;
  ab.dq = bf.dqc; ab.dq32 = bf.dq32; ab.ldq = lq;
  ab.dk = bf.dkvc; ab.dv = bf.dkvc + D; ab.ldkv = lkv;
  ab.dk32 = bf.dk32; ab.dv32 = bf.dv32; ab.ldkv32 = lk32;
  if ((err = attention_backward_passes<T, sizeof(T) == 2>(ab, B, H, dh, s))) return err;

  // dx_q = T(dQ) Wq, dx_kv = [T(dK) | T(dV)] [Wk; Wv]
  if ((err = gemm<T, kBias, true>({bf.dqc, D, wq, nullptr, nq, D, D, dxq, D, nullptr, 0, nullptr, nullptr, 0}, s))) return err;
  if ((err = gemm<T, kBias, true>({bf.dkvc, 2 * D, wk, nullptr, nk, D, 2 * D, dxkv, D, nullptr, 0, nullptr, nullptr, 0,
                                   wv, nullptr, 0, D}, s))) return err;

  // weight gradients dWq, dWk, dWv, dWo (torch layout [out, in])
  TnArgs tn;
  tn.p[0] = {bf.dqc, D, xq, D, nq};
  tn.p[1] = {bf.dkvc, 2 * D, xkv, D, nk};
  tn.p[2] = {bf.dkvc + D, 2 * D, xkv, D, nk};
  tn.p[3] = {g, D, attn, D, nq};
  tn.P = D; tn.Q = D; tn.chunk = pl.tn.chunk; tn.splits = pl.tn.splits; tn.partial = bf.tn_partial;
  const Outputs4 dw = {{static_cast<float*>(o[2]), static_cast<float*>(o[3]), static_cast<float*>(o[4]),
                        static_cast<float*>(o[5])}};
  if ((err = tn_gemm<T>(tn, 4, pl.tn.tile, dw, s))) return err;

  // bias gradients dbq, dbk, dbv from the f32 sums, dbo from g
  ColArgs ca;
  ca.p[0] = {bf.dq32, D, nq, 0};
  ca.p[1] = {bf.dk32, D, nk, 0};
  ca.p[2] = {bf.dv32, D, nk, 0};
  ca.p[3] = {g, D, nq, sizeof(T) == 2};
  ca.cols = D; ca.chunk = pl.col_chunk; ca.splits = pl.col_splits; ca.partial = bf.col_partial;
  colsum_partial<<<dim3((D + kColThreads - 1) / kColThreads, pl.col_splits, 4), kColThreads, 0, s>>>(ca);
  if ((err = cudaGetLastError())) return err;
  Outputs4 db = {{static_cast<float*>(o[6]), static_cast<float*>(o[7]), static_cast<float*>(o[8]),
                  static_cast<float*>(o[9])}};
  reduce_partials<<<dim3((D + 255) / 256, 4), 256, 0, s>>>(bf.col_partial, pl.col_splits, D, db);
  return cudaGetLastError();
}

}  // namespace

// Bytes of workspace og_message_backward needs.
extern "C" size_t og_message_backward_workspace(int is_bf16, int B, int N, int M, int D, int H) {
  Carve ws{nullptr};
  if (is_bf16) carve<bf16>(ws, B, N, M, D, H, plan<bf16>(B, N, M, D));
  else carve<float>(ws, B, N, M, D, H, plan<float>(B, N, M, D));
  return ws.used;
}

// The backward of og_message_forward. is_bf16 selects the compute type T of
// x_q, x_kv, g (the cotangent of msg), attn and the weights; lse f32 [B, H, N].
// mask: [B, M] uint8 or null; dead: [B] uint8 or null, 1 where every key of
// the element is masked.
// weights (T): wq, wk, wv, wo (torch layout [out, in], [D, D]); f32 biases
// bq, bk, bv [D].
// outputs: dx_q (T, [B, N, D]), dx_kv (T, [B, M, D]), then f32 dWq, dWk, dWv,
// dWo ([D, D], torch layout) and dbq, dbk, dbv, dbo ([D]). D = dh * H with dh 32 or 64.
// Returns the CUDA error code of the launches (0 on success).
extern "C" int og_message_backward(int is_bf16, int B, int N, int M, int D, int H,
                                   const void* xq, const void* xkv, const void* mask, const void* dead,
                                   const void* g, const void* attn, const void* lse,
                                   const void* const* weights, const void* const* biases,
                                   void* const* outputs, void* workspace, void* stream) {
  if (!head_width_ok(D, H) || M <= 0 || N <= 0 || B <= 0) return cudaErrorInvalidValue;
  const float* const* f = reinterpret_cast<const float* const*>(biases);
  const float* l = static_cast<const float*>(lse);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return message_backward<bf16>(B, N, M, D, H, xq, xkv, mask, dead, g, attn, l, weights, f, outputs, workspace, s);
  return message_backward<float>(B, N, M, D, H, xq, xkv, mask, dead, g, attn, l, weights, f, outputs, workspace, s);
}
