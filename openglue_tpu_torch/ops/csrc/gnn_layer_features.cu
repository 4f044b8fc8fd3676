// One eval-mode attentional-propagation layer with O(N) feature-map attention
// (linear ELU+1, FAVOR-relu, FAVOR-softmax) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel openglue_tpu/ops/pallas/gnn_layer_kernel.py::
// _layer_kernel, feature-map kinds, reached through fused_attention_propagation.
// For x_q [B, N, D], x_kv [B, M, D], H heads of dh = 32 or 64 and F features per head
// (F = dh for linear; the rows of the projection [F, dh] for FAVOR):
//   q = T(x_q Wq + bq);  k = x_kv Wk + bk (kept f32);  v = T(x_kv Wv + bv)
//   phi(x):  linear         x > 0 ? x + 1 : exp(min(x, 0)), + 1e-6
//            favor_relu     max(ph, 0) + 1e-8,          ph = T(x dh^-1/4) . T(proj)^T
//            favor_softmax  F^-1/2 (exp(ph - |x dh^-1/4|^2 / 2 - stab) + 1e-8), stab the
//                           row max of ph for a query and, for keys, ONE max per
//                           (element, head) over valid keys x features
//   kf = phi(k_h) * mask;  KV_h = T(kf)^T . v_h (f32);  ksum_h = sum_m kf (f32)
//   attn_h = T((T(phi(q_h)) . KV_h) / (phi(q_h) . ksum_h))
//   msg = T(attn Wo + bo);  cat = [x_q, msg] or [T(x_q - msg), msg]
//   h1 = T(relu(cat W1 + b1) * a1 + c1);  out = T(x_q + (h1 W2 + b2))
// T is bf16 or f32; every sum accumulates in f32, at the TPU kernel's rounding
// points. An element whose keys are all masked has KV = ksum = 0 and comes out
// NaN (0 / 0), as on the TPU.
//
// What bounds it on the H100: at B=16, N=M=1024, D=256, F=128 the layer needs
// 2.6e10 FLOP (2.1e10 in the six dense products) against 25 MB of activations in
// and out, so operations bound it, not bytes.
//
// Design. The TPU kernel consumes the key set at the first grid step of a batch
// element and carries KV and ksum in VMEM scratch to the later query blocks.
// CUDA blocks run in no order, so the layer is eleven launches on one stream:
// the k (f32 out), v and q projections and, at the end, the out projection and
// the two FFN products run in the shared tiled GEMM with its fused epilogues
// (in f32 3xTF32 on the tensor cores, gemm.cuh); a
// key kernel writes the feature rows of 64-key tiles (for favor_softmax the
// pre-exponent ph - diag and each tile's max, because the key max needs the
// whole key set before any exp); an aggregate kernel gives one block 64 features
// of one (element, head) and a split of 128 keys, walked in order, and two small
// launches add the splits' partial KV and ksum in a fixed order, so there are no
// atomics and two runs give equal bits; a query kernel builds the feature rows
// of 64 queries in shared memory and applies KV and ksum. KV stays f32 as on the
// TPU, so the feature products are f32 FMAs on operands rounded to T, not
// tensor-core products (the feature kernels have no tensor-core path): they
// are a fifth of the layer's operations. Their
// shared tiles are k-major and every thread owns a 4 x 4 block, so one float4
// load of each operand feeds 16 FMAs. The features of the keys go through
// global memory (they stay in the 50 MB L2 at these sizes).

#include <math.h>

#include "gemm.cuh"

namespace {

enum Kind { kLinear = 0, kFavorRelu = 1, kFavorSoftmax = 2 };

constexpr float kEluEps = 1e-6f, kFavorEps = 1e-8f;
constexpr int kTile = 64;          // query or key rows per block
constexpr int kFeatThreads = 256;
constexpr int kLd = kTile + 4;     // row stride of the shared tiles (float4 rows)
constexpr int kAggKeys = 128;      // keys per aggregate block
constexpr int kMaxFeatures = 256;

__device__ __forceinline__ float elu1p(float x) { return x > 0.f ? x + 1.f : expf(fminf(x, 0.f)); }
__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// Shared-memory plan of the key and query kernels (floats). The tiles are
// k-major, so that a thread reads four rows or four features as one float4:
//   xsT [dh][68] | region: psT [dh][F + 4], later KV [F][68] | fsT [F][68]
//   | diag [64] | rowmax [64] | ksum [F]
__host__ __device__ inline size_t region_floats(int F, int dh) {
  const size_t proj = static_cast<size_t>(dh) * (F + 4), kv = static_cast<size_t>(F) * kLd;
  return proj > kv ? proj : kv;
}
__host__ __device__ inline size_t feature_smem_floats(int F, int dh) {
  return static_cast<size_t>(dh) * kLd + region_floats(F, dh) + static_cast<size_t>(F) * kLd +
         2 * kTile + F;
}

// fsT[f][r] = sum_d xsT[d][r] * psT[d][f] for 64 rows and F features; each
// thread 4 rows x 4 features, two float4 loads for 16 FMAs
template <int DH>
__device__ __forceinline__ void project_tile(const float* xsT, const float* psT, float* fsT, int F) {
  const int rg = threadIdx.x / 16, ft = threadIdx.x % 16, ldp = F + 4;
  for (int f = ft * 4; f < F; f += 64) {
    float acc[4][4] = {};  // [feature][row]
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      const float4 a = ld4(&xsT[d * kLd + rg * 4]), w = ld4(&psT[d * ldp + f]);
      const float av[4] = {a.x, a.y, a.z, a.w}, wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = fmaf(av[i], wv[j], acc[j][i]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      st4(&fsT[(f + j) * kLd + rg * 4], acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
  }
}

// The first half of a feature tile, shared by keys and queries: xsT holds 64
// rows of one head in f32. linear: fsT = elu1p(xsT) + eps. FAVOR: diag (softmax
// only), xsT <- T(xsT * dh^-1/4), fsT = ph. Ends synchronized.
template <typename T, int KIND, int DH>
__device__ __forceinline__ void feature_tile(float* xsT, float* psT, float* fsT, float* diag,
                                             const float* __restrict__ proj, int F) {
  const int tid = threadIdx.x;
  if constexpr (KIND == kLinear) {
    for (int i = tid; i < DH * kTile; i += kFeatThreads) {
      const int d = i / kTile, r = i % kTile;
      fsT[d * kLd + r] = elu1p(xsT[d * kLd + r]) + kEluEps;
    }
  } else {
    constexpr float kDataNorm = Head<DH>::data_norm;
    for (int i = tid; i < F * DH; i += kFeatThreads)
      psT[(i % DH) * (F + 4) + i / DH] = round_to<T>(proj[i]);
    if constexpr (KIND == kFavorSoftmax) {
      if (tid < kTile) {
        float s = 0.f;
        for (int d = 0; d < DH; ++d) {
          const float y = xsT[d * kLd + tid] * kDataNorm;
          s = fmaf(y, y, s);
        }
        diag[tid] = 0.5f * s;
      }
      __syncthreads();
    }
    for (int i = tid; i < DH * kTile; i += kFeatThreads) {
      float* x = &xsT[(i / kTile) * kLd + i % kTile];
      *x = round_to<T>(*x * kDataNorm);
    }
    __syncthreads();
    project_tile<DH>(xsT, psT, fsT, F);
  }
  __syncthreads();
}

// Feature rows of one 64-key tile of one (element, head) -> kfeat [B, H, M, F].
// linear and favor_relu write kf * mask; favor_softmax writes ph - diag and the
// tile's max of ph over valid keys (masked keys at ph - 1e9) into tilemax.
template <typename T, int KIND, int DH>
__global__ void __launch_bounds__(kFeatThreads)
key_features_kernel(const float* __restrict__ k32, const uint8_t* __restrict__ mask,
                    const float* __restrict__ proj, float* __restrict__ kfeat,
                    float* __restrict__ tilemax, int M, int D, int F) {
  extern __shared__ __align__(16) float smem[];
  float* xsT = smem;
  float* psT = xsT + DH * kLd;
  float* fsT = psT + region_floats(F, DH);
  float* diag = fsT + static_cast<size_t>(F) * kLd;
  __shared__ float red[kFeatThreads / 32];
  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z, H = gridDim.y, tid = threadIdx.x;
  const int m0 = tile * kTile;
  for (int i = tid; i < kTile * DH; i += kFeatThreads) {
    const int r = i / DH, d = i % DH;
    xsT[d * kLd + r] =
        m0 + r < M ? k32[(static_cast<size_t>(b) * M + m0 + r) * D + h * DH + d] : 0.f;
  }
  __syncthreads();
  feature_tile<T, KIND, DH>(xsT, psT, fsT, diag, proj, F);

  float* out = kfeat + (static_cast<size_t>(b) * H + h) * M * F;
  float local_max = -INFINITY;
  for (int i = tid; i < kTile * F; i += kFeatThreads) {
    const int r = i / F, f = i % F;
    if (m0 + r >= M) continue;
    const bool valid = mask == nullptr || mask[static_cast<size_t>(b) * M + m0 + r] != 0;
    float y = fsT[f * kLd + r];
    if constexpr (KIND == kFavorSoftmax) {
      local_max = fmaxf(local_max, valid ? y : y + kMasked);
      y = y - diag[r];
    } else {
      if constexpr (KIND == kFavorRelu) y = fmaxf(y, 0.f) + kFavorEps;
      y = y * (valid ? 1.f : 0.f);
    }
    out[static_cast<size_t>(m0 + r) * F + f] = y;
  }
  if constexpr (KIND == kFavorSoftmax) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      local_max = fmaxf(local_max, __shfl_xor_sync(0xffffffffu, local_max, o));
    if (tid % 32 == 0) red[tid / 32] = local_max;
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < kFeatThreads / 32; ++w) local_max = fmaxf(local_max, red[w]);
      tilemax[(static_cast<size_t>(b) * H + h) * gridDim.x + tile] = local_max;
    }
  }
}

// Partial KV [B, H, S, F, dh] and ksum [B, H, S, F]: a block owns 64 features of
// one (element, head) and the 128 keys of split s, walked in order. Thread
// (fg, dg) owns features kFpt fg .. kFpt fg + kFpt - 1 (kFpt = dh / 16) and
// columns 4 dg .. 4 dg + 3.
template <typename T, int KIND, int DH>
__global__ void __launch_bounds__(kFeatThreads)
aggregate_kernel(const float* __restrict__ kfeat, const T* __restrict__ v,
                 const uint8_t* __restrict__ mask, const float* __restrict__ tilemax,
                 float* __restrict__ kv_part, float* __restrict__ ksum_part, int M, int D, int F,
                 int tiles, float ratio) {
  constexpr int kGroups = DH / 4, kFpt = 64 * kGroups / kFeatThreads;  // column groups; features a thread owns
  __shared__ __align__(16) float kfs[kTile][64];
  __shared__ __align__(16) float vs[kTile][DH];
  const int chunks = (F + 63) / 64, splits = gridDim.x / chunks;
  const int f0 = (blockIdx.x % chunks) * 64, sp = blockIdx.x / chunks;
  const int h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int tid = threadIdx.x, fg = tid / kGroups, dg = tid % kGroups;
  const float* kf = kfeat + (static_cast<size_t>(b) * H + h) * M * F;
  const T* vb = v + static_cast<size_t>(b) * M * D + h * DH;
  float stab = 0.f;
  if constexpr (KIND == kFavorSoftmax) {
    stab = -INFINITY;
    for (int t = 0; t < tiles; ++t)
      stab = fmaxf(stab, tilemax[(static_cast<size_t>(b) * H + h) * tiles + t]);
  }
  float acc[kFpt][4] = {}, sum[kFpt] = {};
  const int m_end = min(M, (sp + 1) * kAggKeys);
  for (int m0 = sp * kAggKeys; m0 < m_end; m0 += kTile) {
    __syncthreads();
    for (int i = tid; i < kTile * 16; i += kFeatThreads) {
      const int r = i / 16, c = (i % 16) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m0 + r < m_end && f0 + c < F) {
        x = ld4(kf + static_cast<size_t>(m0 + r) * F + f0 + c);
        if constexpr (KIND == kFavorSoftmax) {
          const float w =
              mask == nullptr || mask[static_cast<size_t>(b) * M + m0 + r] != 0 ? 1.f : 0.f;
          x.x = ratio * (expf(x.x - stab) + kFavorEps) * w;
          x.y = ratio * (expf(x.y - stab) + kFavorEps) * w;
          x.z = ratio * (expf(x.z - stab) + kFavorEps) * w;
          x.w = ratio * (expf(x.w - stab) + kFavorEps) * w;
        }
      }
      *reinterpret_cast<float4*>(&kfs[r][c]) = x;
    }
    for (int i = tid; i < kTile * DH / 2; i += kFeatThreads) {
      const int r = i / (DH / 2), c = (i % (DH / 2)) * 2;
      float2 x = make_float2(0.f, 0.f);
      if (m0 + r < m_end) x = load2(vb + static_cast<size_t>(m0 + r) * D + c);
      vs[r][c] = x.x;
      vs[r][c + 1] = x.y;
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < kTile; ++r) {
      const float4 x = ld4(&vs[r][dg * 4]);
      float av[kFpt];
      if constexpr (kFpt == 4) {
        const float4 a = ld4(&kfs[r][fg * 4]);
        av[0] = a.x; av[1] = a.y; av[2] = a.z; av[3] = a.w;
      } else {
        const float2 a = *reinterpret_cast<const float2*>(&kfs[r][fg * kFpt]);
        av[0] = a.x; av[1] = a.y;
      }
      const float xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int j = 0; j < kFpt; ++j) {
        const float ar = round_to<T>(av[j]);
        sum[j] += av[j];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[j][c] = fmaf(ar, xv[c], acc[j][c]);
      }
    }
  }
  const size_t group = (static_cast<size_t>(b) * H + h) * splits + sp;
#pragma unroll
  for (int j = 0; j < kFpt; ++j) {
    const int f = f0 + fg * kFpt + j;
    if (f < F) {
      st4(kv_part + (group * F + f) * DH + dg * 4, acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
      if (dg == 0) ksum_part[group * F + f] = sum[j];
    }
  }
}

// out[g][e] = sum over s, in order, of part[g][s][e]: the partial KV and ksum
// of the key splits into one, in a fixed summation order
__global__ void __launch_bounds__(256)
reduce_splits_kernel(const float* __restrict__ part, float* __restrict__ out, int splits, int per) {
  const size_t g = blockIdx.y;
  for (int e = (blockIdx.x * 256 + threadIdx.x) * 4; e < per; e += gridDim.x * 1024) {
    float4 acc = ld4(part + g * splits * per + e);
    for (int s = 1; s < splits; ++s) {
      const float4 x = ld4(part + (g * splits + s) * per + e);
      acc.x += x.x; acc.y += x.y; acc.z += x.z; acc.w += x.w;
    }
    *reinterpret_cast<float4*>(out + g * per + e) = acc;
  }
}

// attn rows of 64 queries of one (element, head): the feature rows in shared
// memory, then o = T(qf) . KV, norm = qf . ksum, attn = T(o / norm). Thread
// (rg, dg) owns rows kRpt rg .. kRpt rg + kRpt - 1 (kRpt = dh / 16) and
// columns 4 dg .. 4 dg + 3.
template <typename T, int KIND, int DH>
__global__ void __launch_bounds__(kFeatThreads)
query_kernel(const T* __restrict__ q, const float* __restrict__ proj,
             const float* __restrict__ kv, const float* __restrict__ ksum, T* __restrict__ attn,
             int N, int D, int F, float ratio) {
  extern __shared__ __align__(16) float smem[];
  float* xsT = smem;
  float* region = xsT + DH * kLd;
  float* fsT = region + region_floats(F, DH);
  float* diag = fsT + static_cast<size_t>(F) * kLd;
  float* rowmax = diag + kTile;
  float* ks = rowmax + kTile;
  const int n0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int tid = threadIdx.x;
  const T* qb = q + static_cast<size_t>(b) * N * D + h * DH;
  for (int i = tid; i < kTile * DH; i += kFeatThreads) {
    const int r = i / DH, d = i % DH;
    xsT[d * kLd + r] = n0 + r < N ? to_f(qb[static_cast<size_t>(n0 + r) * D + d]) : 0.f;
  }
  __syncthreads();
  feature_tile<T, KIND, DH>(xsT, region, fsT, diag, proj, F);
  if constexpr (KIND == kFavorRelu) {
    for (int i = tid; i < F * kTile; i += kFeatThreads) {
      float* y = &fsT[(i / kTile) * kLd + i % kTile];
      *y = fmaxf(*y, 0.f) + kFavorEps;
    }
  } else if constexpr (KIND == kFavorSoftmax) {
    if (tid < kTile) {
      float mx = -INFINITY;
      for (int f = 0; f < F; ++f) mx = fmaxf(mx, fsT[f * kLd + tid]);
      rowmax[tid] = mx;
    }
    __syncthreads();
    for (int i = tid; i < F * kTile; i += kFeatThreads) {
      const int r = i % kTile;
      float* y = &fsT[(i / kTile) * kLd + r];
      *y = ratio * (expf(*y - diag[r] - rowmax[r]) + kFavorEps);
    }
  }
  // KV and ksum of this (element, head) take the projection's place
  const float* kvb = kv + (static_cast<size_t>(b) * H + h) * F * DH;
  for (int i = tid; i < F * DH / 4; i += kFeatThreads) {
    const int f = i / (DH / 4), c = (i % (DH / 4)) * 4;
    *reinterpret_cast<float4*>(&region[f * kLd + c]) = ld4(kvb + static_cast<size_t>(f) * DH + c);
  }
  for (int f = tid; f < F; f += kFeatThreads) ks[f] = ksum[(static_cast<size_t>(b) * H + h) * F + f];
  __syncthreads();

  constexpr int kGroups = DH / 4, kRpt = 64 * kGroups / kFeatThreads;  // column groups; rows a thread owns
  const int rg = tid / kGroups, dg = tid % kGroups;
  float acc[kRpt][4] = {}, norm[kRpt] = {};
#pragma unroll 4
  for (int f = 0; f < F; ++f) {
    const float4 w = ld4(&region[f * kLd + dg * 4]);
    float av[kRpt];
    if constexpr (kRpt == 4) {
      const float4 a = ld4(&fsT[f * kLd + rg * 4]);
      av[0] = a.x; av[1] = a.y; av[2] = a.z; av[3] = a.w;
    } else {
      const float2 a = *reinterpret_cast<const float2*>(&fsT[f * kLd + rg * kRpt]);
      av[0] = a.x; av[1] = a.y;
    }
    const float wv[4] = {w.x, w.y, w.z, w.w};
    const float s = ks[f];
#pragma unroll
    for (int i = 0; i < kRpt; ++i) {
      const float ar = round_to<T>(av[i]);
      norm[i] = fmaf(av[i], s, norm[i]);
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(ar, wv[c], acc[i][c]);
    }
  }
  T* ob = attn + static_cast<size_t>(b) * N * D + h * DH + dg * 4;
#pragma unroll
  for (int i = 0; i < kRpt; ++i) {
    const int r = n0 + rg * kRpt + i;
    if (r < N) {
      store2(ob + static_cast<size_t>(r) * D, acc[i][0] / norm[i], acc[i][1] / norm[i]);
      store2(ob + static_cast<size_t>(r) * D + 2, acc[i][2] / norm[i], acc[i][3] / norm[i]);
    }
  }
}

struct Buffers {
  void *q, *k32, *v, *kfeat, *tilemax, *kv_part, *ksum_part, *kv, *ksum, *attn, *cat, *h1;
};

Buffers carve(Carve& ws, int B, int N, int M, int D, int H, int F, size_t elt) {
  const size_t rq = static_cast<size_t>(B) * N, rk = static_cast<size_t>(B) * M;
  const size_t heads = static_cast<size_t>(B) * H;
  Buffers p;
  p.q = ws.take<char>(rq * D * elt);
  p.k32 = ws.take<float>(rk * D);
  p.v = ws.take<char>(rk * D * elt);
  p.kfeat = ws.take<float>(heads * M * F);
  p.tilemax = ws.take<float>(heads * ((M + kTile - 1) / kTile));
  const size_t splits = (M + kAggKeys - 1) / kAggKeys;
  p.kv_part = ws.take<float>(heads * splits * F * (D / H));
  p.ksum_part = ws.take<float>(heads * splits * F);
  p.kv = ws.take<float>(heads * F * (D / H));
  p.ksum = ws.take<float>(heads * F);
  p.attn = ws.take<char>(rq * D * elt);
  p.cat = ws.take<char>(rq * 2 * D * elt);
  p.h1 = ws.take<char>(rq * 2 * D * elt);
  return p;
}

template <typename T, int KIND, int DH>
int layer(int B, int N, int M, int D, int H, int F, int use_offset, const void* xq_,
          const void* xkv_, const void* mask_, const void* const* w, const float* const* f,
          const float* proj, void* ws_, void* out_, cudaStream_t s) {
  const T* xq = static_cast<const T*>(xq_);
  const T* xkv = static_cast<const T*>(xkv_);
  const uint8_t* mask = static_cast<const uint8_t*>(mask_);
  const T *wq = static_cast<const T*>(w[0]), *wk = static_cast<const T*>(w[1]),
          *wv = static_cast<const T*>(w[2]), *wo = static_cast<const T*>(w[3]),
          *w1 = static_cast<const T*>(w[4]), *w2 = static_cast<const T*>(w[5]);
  const float *bq = f[0], *bk = f[1], *bv = f[2], *bo = f[3], *b1 = f[4], *a1 = f[5], *c1 = f[6],
              *b2 = f[7];
  Carve ws{static_cast<char*>(ws_)};
  const Buffers p = carve(ws, B, N, M, D, H, F, sizeof(T));
  T *q = static_cast<T*>(p.q), *v = static_cast<T*>(p.v), *attn = static_cast<T*>(p.attn),
    *cat = static_cast<T*>(p.cat), *h1 = static_cast<T*>(p.h1), *out = static_cast<T*>(out_);
  float *k32 = static_cast<float*>(p.k32), *kfeat = static_cast<float*>(p.kfeat),
        *tilemax = static_cast<float*>(p.tilemax), *kv = static_cast<float*>(p.kv),
        *ksum = static_cast<float*>(p.ksum), *kv_part = static_cast<float*>(p.kv_part),
        *ksum_part = static_cast<float*>(p.ksum_part);
  const int nq = B * N, nk = B * M, tiles = (M + kTile - 1) / kTile;
  const int splits = (M + kAggKeys - 1) / kAggKeys, chunks = (F + 63) / 64;
  const size_t smem = feature_smem_floats(F, DH) * sizeof(float);
  const float ratio = static_cast<float>(1.0 / sqrt(static_cast<double>(F)));  // F^-1/2
  cudaError_t err;
  // k stays f32 into the feature map; v and q are cast to T
  if ((err = gemm<T, kBiasF32>({xkv, D, wk, bk, nk, D, D, reinterpret_cast<T*>(k32), D, nullptr, 0, nullptr, nullptr, 0}, s))) return err;
  if ((err = gemm<T, kBias>({xkv, D, wv, bv, nk, D, D, v, D, nullptr, 0, nullptr, nullptr, 0}, s))) return err;
  if ((err = gemm<T, kBias>({xq, D, wq, bq, nq, D, D, q, D, nullptr, 0, nullptr, nullptr, 0}, s))) return err;
  if ((err = cudaFuncSetAttribute(key_features_kernel<T, KIND, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)))) return err;
  if ((err = cudaFuncSetAttribute(query_kernel<T, KIND, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)))) return err;
  key_features_kernel<T, KIND, DH><<<dim3(tiles, H, B), kFeatThreads, smem, s>>>(k32, mask, proj, kfeat, tilemax, M, D, F);
  if ((err = cudaGetLastError())) return err;
  aggregate_kernel<T, KIND, DH><<<dim3(chunks * splits, H, B), kFeatThreads, 0, s>>>(kfeat, v, mask, tilemax, kv_part, ksum_part, M, D, F, tiles, ratio);
  reduce_splits_kernel<<<dim3((F * DH + 1023) / 1024, B * H), 256, 0, s>>>(kv_part, kv, splits, F * DH);
  reduce_splits_kernel<<<dim3(1, B * H), 256, 0, s>>>(ksum_part, ksum, splits, F);
  if ((err = cudaGetLastError())) return err;
  query_kernel<T, KIND, DH><<<dim3((N + kTile - 1) / kTile, H, B), kFeatThreads, smem, s>>>(q, proj, kv, ksum, attn, N, D, F, ratio);
  if ((err = cudaGetLastError())) return err;
  // out projection with the concat, then the FFN, as in the softmax layer
  if ((err = gemm<T, kConcat>({attn, D, wo, bo, nq, D, D, cat, 2 * D, xq, D, nullptr, nullptr, use_offset}, s))) return err;
  if ((err = gemm<T, kReluAffine>({cat, 2 * D, w1, b1, nq, 2 * D, 2 * D, h1, 2 * D, nullptr, 0, a1, c1, 0}, s))) return err;
  return gemm<T, kResidual>({h1, 2 * D, w2, b2, nq, D, 2 * D, out, D, xq, D, nullptr, nullptr, 0}, s);
}

template <typename T>
int layer_of_kind(int kind, int B, int N, int M, int D, int H, int F, int use_offset,
                  const void* xq, const void* xkv, const void* mask, const void* const* w,
                  const float* const* f, const float* proj, void* ws, void* out, cudaStream_t s) {
  return with_head_width(D / H, [&](auto width) -> cudaError_t {
    constexpr int DH = decltype(width)::value;
    switch (kind) {
      case kLinear: return static_cast<cudaError_t>(layer<T, kLinear, DH>(B, N, M, D, H, F, use_offset, xq, xkv, mask, w, f, proj, ws, out, s));
      case kFavorRelu: return static_cast<cudaError_t>(layer<T, kFavorRelu, DH>(B, N, M, D, H, F, use_offset, xq, xkv, mask, w, f, proj, ws, out, s));
      case kFavorSoftmax: return static_cast<cudaError_t>(layer<T, kFavorSoftmax, DH>(B, N, M, D, H, F, use_offset, xq, xkv, mask, w, f, proj, ws, out, s));
    }
    return cudaErrorInvalidValue;
  });
}

}  // namespace

// Bytes of workspace og_gnn_layer_features needs.
extern "C" size_t og_gnn_layer_features_workspace(int is_bf16, int B, int N, int M, int D, int H,
                                                  int F) {
  Carve ws{nullptr};
  carve(ws, B, N, M, D, H, F, is_bf16 ? 2 : 4);
  return ws.used;
}

// One layer. is_bf16 selects the compute type T of x and the weights; kind is 0
// linear (F = dh, proj unused), 1 favor_relu, 2 favor_softmax (proj: f32 [F, dh], F a
// multiple of 16 up to 256). weights (T, [out, in]): wq, wk, wv, wo [D, D], w1
// [2D, 2D], w2 [D, 2D]. f32 vectors: bq, bk, bv, bo [D], b1, a1, c1 [2D], b2 [D].
// mask: [B, M] uint8 or null. out (T): [B, N, D]. D = dh * H with dh 32 or 64.
// Returns the CUDA error code of the launches (0 on success).
extern "C" int og_gnn_layer_features(int is_bf16, int B, int N, int M, int D, int H, int F,
                                     int kind, int use_offset, const void* xq, const void* xkv,
                                     const void* mask, const void* const* weights,
                                     const void* const* vectors, const void* proj,
                                     void* workspace, void* out, void* stream) {
  if (B == 0 || N == 0) return cudaSuccess;
  if (!head_width_ok(D, H) || D % 64 != 0 || M <= 0) return cudaErrorInvalidValue;
  if (F % 16 != 0 || F <= 0 || F > kMaxFeatures || (kind == kLinear && F != D / H)) return cudaErrorInvalidValue;
  if (kind != kLinear && proj == nullptr) return cudaErrorInvalidValue;
  const float* const* f = reinterpret_cast<const float* const*>(vectors);
  const float* pr = static_cast<const float*>(proj);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return layer_of_kind<bf16>(kind, B, N, M, D, H, F, use_offset, xq, xkv, mask, weights, f, pr, workspace, out, s);
  return layer_of_kind<float>(kind, B, N, M, D, H, F, use_offset, xq, xkv, mask, weights, f, pr, workspace, out, s);
}
