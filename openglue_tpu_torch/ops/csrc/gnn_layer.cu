// One eval-mode attentional-propagation layer (softmax attention) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel openglue_tpu/ops/pallas/gnn_layer_kernel.py::
// _layer_kernel (softmax kind), reached through fused_attention_propagation. It
// computes, for x_q [B, N, D] and x_kv [B, M, D] with H heads of dh = 64:
//   q, k, v = T(x W + b)                         (T: the compute type)
//   logits  = (q_h . k_h) * dh^-0.5 + (mask ? 0 : -1e9)        (f32)
//   attn_h  = T((T(exp(logits - max)) . v_h) / sum exp(logits - max))
//   msg     = T(attn Wo + bo);  cat = [x_q, msg] or [T(x_q - msg), msg]
//   h1      = T(relu(cat W1 + b1) * a1 + c1)     (eval BatchNorm folded to a1, c1)
//   out     = T(x_q + (h1 W2 + b2))
// in bf16 (mma.sync m16n8k16, f32 accumulation) or f32 (FMA tiles), keeping the
// TPU kernel's rounding points.
//
// What bounds it on the H100: at the serving shape (B=16, N=M=1024, D=256) the
// layer is 3.9e10 FLOP against 64 MB of activations in and out, so the tensor
// cores bound it (about 39 us at 989 TFLOP/s bf16).
//
// Design: the TPU kernel keeps K/V of the whole key set in VMEM (about 1 MB at
// M=1024, D=256) and runs one exact softmax pass per query block. An SM has 227
// KB, so here the layer is six launches on one stream: the k and v projections
// (one GEMM on stacked weights) and the q projection write to global memory
// (they stay in the 50 MB L2); a flash-style attention kernel streams K/V
// tiles through shared memory with an f32 running max and sum (one CTA per
// batch element, head and 64-query block); the out projection and both FFN
// products run in the same tiled GEMM kernel, whose epilogue fuses the bias,
// the concat (with or without the offset), the ReLU and folded BatchNorm, and
// the residual add with the output cast. The launches are separate because the
// projections of all keys must exist before any query block attends to them.
// Loads are double-buffered with cp.async and the products use mma.sync; TMA
// and wgmma are not used yet, so the kernels reach a fraction of the
// tensor-core rate.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kDh = 64;  // head width
constexpr float kScale = 0.125f;  // kDh^-0.5
constexpr float kMasked = -1e9f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16-byte asynchronous copy global -> shared; a false predicate zero-fills
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
template <typename T> __device__ __forceinline__ float round_to(float x) { return to_f(from_f<T>(x)); }

// ---------------------------------------------------------------- GEMM
// out[r, c] = epilogue(sum_k A[r, k] * W[c, k]); W is [n_out, k] (torch layout).

enum Epilogue { kBias = 0, kConcat = 1, kReluAffine = 2, kResidual = 3 };

template <typename T>
struct GemmArgs {
  const T* A; int lda;
  const T* W;            // [n_out, k]
  const float* bias;     // [n_out]
  int rows, n_out, k;
  T* out; int ldo;
  const T* x; int ldx;   // x_q for kConcat / kResidual
  const float* scale;    // a1 for kReluAffine
  const float* shift;    // c1 for kReluAffine
  int use_offset;
  // the k+v projection reads wk and wv as one [2D, D] matrix: output columns
  // from `split` on take W2 and bias2 (split 0: W and bias only)
  const T* W2 = nullptr;
  const float* bias2 = nullptr;
  int split = 0;
};

template <typename T>
__device__ __forceinline__ const T* weight_row(const GemmArgs<T>& p, int c) {
  return p.split && c >= p.split ? p.W2 + static_cast<size_t>(c - p.split) * p.k
                                 : p.W + static_cast<size_t>(c) * p.k;
}
template <typename T>
__device__ __forceinline__ float bias_at(const GemmArgs<T>& p, int c) {
  return p.split && c >= p.split ? p.bias2[c - p.split] : p.bias[c];
}

// columns c and c+1 of row r
template <typename T, int EPI>
__device__ __forceinline__ void epilogue2(const GemmArgs<T>& p, int r, int c, float acc0, float acc1) {
  const float y0 = acc0 + bias_at(p, c), y1 = acc1 + bias_at(p, c + 1);
  T* o = p.out + static_cast<size_t>(r) * p.ldo + c;
  if constexpr (EPI == kBias) {
    store2(o, y0, y1);
  } else if constexpr (EPI == kConcat) {
    const float m0 = round_to<T>(y0), m1 = round_to<T>(y1);
    const float2 x = load2(p.x + static_cast<size_t>(r) * p.ldx + c);
    store2(o + p.n_out, m0, m1);
    if (p.use_offset) store2(o, x.x - m0, x.y - m1);
    else store2(o, x.x, x.y);
  } else if constexpr (EPI == kReluAffine) {
    store2(o, fmaxf(y0, 0.f) * p.scale[c] + p.shift[c], fmaxf(y1, 0.f) * p.scale[c + 1] + p.shift[c + 1]);
  } else {
    const float2 x = load2(p.x + static_cast<size_t>(r) * p.ldx + c);
    store2(o, x.x + y0, x.y + y1);
  }
}

constexpr int kBK = 32;

// bf16: a BM x BN block per CTA, warps of WM x WN m16n8k16 tiles, the k loop
// double-buffered with cp.async
template <int EPI, int BM, int BN, int WM, int WN>
__global__ void __launch_bounds__((BM / WM) * (BN / WN) * 32) gemm_bf16(GemmArgs<bf16> p) {
  constexpr int kPad = 8, kThreads = (BM / WM) * (BN / WN) * 32, MI = WM / 16, NI = WN / 8;
  __shared__ __align__(16) bf16 As[2][BM][kBK + kPad];
  __shared__ __align__(16) bf16 Ws[2][BN][kBK + kPad];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int wm = (warp / (BN / WN)) * WM, wn = (warp % (BN / WN)) * WN;
  float acc[MI][NI][4] = {};

  auto load = [&](int stage, int k0) {
    for (int i = tid; i < BM * kBK / 8; i += kThreads) {
      const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
      const bool ok = m0 + r < p.rows;
      cp_async16(&As[stage][r][c], p.A + static_cast<size_t>(ok ? m0 + r : 0) * p.lda + k0 + c, ok);
    }
    for (int i = tid; i < BN * kBK / 8; i += kThreads) {
      const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
      cp_async16(&Ws[stage][r][c], weight_row(p, n0 + r) + k0 + c, true);
    }
    cp_async_commit();
  };

  const int ktiles = p.k / kBK;
  load(0, 0);
  for (int kt = 0; kt < ktiles; ++kt) {
    const int stage = kt & 1;
    if (kt + 1 < ktiles) {
      load(stage ^ 1, (kt + 1) * kBK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[MI][4], b[NI][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        ldmatrix_x4(a[mi], &As[stage][wm + mi * 16 + (lane % 16)][kk + (lane / 16) * 8]);
#pragma unroll
      for (int np = 0; np < NI / 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4(r, &Ws[stage][wn + np * 16 + (lane % 8) + (lane / 16) * 8][kk + ((lane / 8) % 2) * 8]);
        b[2 * np][0] = r[0]; b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2]; b[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
    }
    __syncthreads();  // this stage is refilled by the next iteration's load
  }

  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + wm + mi * 16 + g + 8 * h;
        if (r < p.rows)
          epilogue2<bf16, EPI>(p, r, n0 + wn + ni * 8 + 2 * t, acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
}

constexpr int kFM = 64, kFN = 64, kFThreads = 128;

// f32: FMA tiles, each thread 4 rows x 4 column pairs of the 64x64 block
template <int EPI>
__global__ void __launch_bounds__(kFThreads) gemm_f32(GemmArgs<float> p) {
  __shared__ float As[kBK][kFM + 4];  // transposed: [k][m]
  __shared__ float Ws[kBK][kFN + 4];  // [k][n]
  const int tid = threadIdx.x, ty = tid / 8, tx = tid % 8;
  const int m0 = blockIdx.x * kFM, n0 = blockIdx.y * kFN;
  float acc[4][8] = {};  // rows ty + 16i; columns 2tx + 16(j/2) + j%2

  for (int k0 = 0; k0 < p.k; k0 += kBK) {
    for (int i = tid; i < kFM * kBK / 4; i += kFThreads) {
      const int r = i / (kBK / 4), c = (i % (kBK / 4)) * 4;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m0 + r < p.rows)
        a = *reinterpret_cast<const float4*>(p.A + static_cast<size_t>(m0 + r) * p.lda + k0 + c);
      const float4 w = *reinterpret_cast<const float4*>(weight_row(p, n0 + r) + k0 + c);
      As[c][r] = a.x; As[c + 1][r] = a.y; As[c + 2][r] = a.z; As[c + 3][r] = a.w;
      Ws[c][r] = w.x; Ws[c + 1][r] = w.y; Ws[c + 2][r] = w.z; Ws[c + 3][r] = w.w;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], w[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) w[j] = Ws[kk][2 * tx + 16 * (j / 2) + j % 2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty + 16 * i;
    if (r < p.rows) {
#pragma unroll
      for (int j = 0; j < 8; j += 2)
        epilogue2<float, EPI>(p, r, n0 + 2 * tx + 8 * j, acc[i][j], acc[i][j + 1]);
    }
  }
}

template <typename T, int EPI>
cudaError_t gemm(const GemmArgs<T>& p, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    // 128x128 blocks where they fill the card, 64x64 for small batches
    const int big_blocks = ((p.rows + 127) / 128) * (p.n_out / 128);
    if (p.n_out % 128 == 0 && big_blocks >= 132) {
      const dim3 grid((p.rows + 127) / 128, p.n_out / 128);
      gemm_bf16<EPI, 128, 128, 64, 32><<<grid, 256, 0, stream>>>(p);
    } else {
      const dim3 grid((p.rows + 63) / 64, p.n_out / 64);
      gemm_bf16<EPI, 64, 64, 32, 32><<<grid, 128, 0, stream>>>(p);
    }
  } else {
    const dim3 grid((p.rows + kFM - 1) / kFM, p.n_out / kFN);
    gemm_f32<EPI><<<grid, kFThreads, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

// ------------------------------------------------------------ attention
// q [B, N, ldq], k/v [B, M, ldkv] (k and v are column blocks of one buffer),
// head h in columns [h*64, h*64+64); mask [B, M] (1 valid, 0 masked) or null;
// out [B, N, D].

__device__ __forceinline__ float mask_add(const uint8_t* mask, int b, int M, int key) {
  if (key >= M) return -INFINITY;  // beyond the key set: no weight at all
  return (mask != nullptr && mask[static_cast<size_t>(b) * M + key] == 0) ? kMasked : 0.f;
}

constexpr int kAq = 64, kAk = 64, kAttnThreads = 128;

// bf16: 4 warps, 16 query rows each; S, P and O stay in mma registers; K/V
// tiles double-buffered with cp.async
__global__ void __launch_bounds__(kAttnThreads)
attention_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
               bf16* __restrict__ out, int N, int M, int D, int ldq, int ldkv) {
  constexpr int kPad = 8;
  __shared__ __align__(16) bf16 Qs[kAq][kDh + kPad];
  __shared__ __align__(16) bf16 Ks[2][kAk][kDh + kPad];
  __shared__ __align__(16) bf16 Vs[2][kAk][kDh + kPad];
  __shared__ float madd[2][kAk];
  const int b = blockIdx.z, h = blockIdx.y, n0 = blockIdx.x * kAq;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const bf16* qb = q + static_cast<size_t>(b) * N * ldq + h * kDh;
  const bf16* kb = k + static_cast<size_t>(b) * M * ldkv + h * kDh;
  const bf16* vb = v + static_cast<size_t>(b) * M * ldkv + h * kDh;

  auto load_kv = [&](int stage, int k0) {
    for (int i = tid; i < kAk * kDh / 8; i += kAttnThreads) {
      const int r = i / 8, c = (i % 8) * 8;
      const bool ok = k0 + r < M;
      const size_t row = static_cast<size_t>(ok ? k0 + r : 0) * ldkv + c;
      cp_async16(&Ks[stage][r][c], kb + row, ok);
      cp_async16(&Vs[stage][r][c], vb + row, ok);
    }
    if (tid < kAk) madd[stage][tid] = mask_add(mask, b, M, k0 + tid);
    cp_async_commit();
  };

  for (int i = tid; i < kAq * kDh / 8; i += kAttnThreads) {
    const int r = i / 8, c = (i % 8) * 8;
    const bool ok = n0 + r < N;
    cp_async16(&Qs[r][c], qb + static_cast<size_t>(ok ? n0 + r : 0) * ldq + c, ok);
  }
  load_kv(0, 0);  // commits Q's copies with the first tile's
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    ldmatrix_x4(qa[kk], &Qs[warp * 16 + (lane % 16)][kk * 16 + (lane / 16) * 8]);

  float o[8][4] = {};
  float row_max[2] = {-INFINITY, -INFINITY};
  float row_sum[2] = {0.f, 0.f};

  const int ktiles = (M + kAk - 1) / kAk;
  for (int kt = 0; kt < ktiles; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < ktiles) {
      load_kv(st ^ 1, (kt + 1) * kAk);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    float s[8][4] = {};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t r[4];
        ldmatrix_x4(r, &Ks[st][np * 16 + (lane % 8) + (lane / 16) * 8][kk * 16 + ((lane / 8) % 2) * 8]);
        mma_bf16(s[2 * np], qa[kk], r[0], r[1]);
        mma_bf16(s[2 * np + 1], qa[kk], r[2], r[3]);
      }

    float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = s[nt][e] * kScale + madd[st][nt * 8 + 2 * t + (e & 1)];
        tile_max[e >> 1] = fmaxf(tile_max[e >> 1], s[nt][e]);
      }
    float alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = tile_max[hh];
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(row_max[hh], mx);
      alpha[hh] = expf(row_max[hh] - m_new);
      row_max[hh] = m_new;
      row_sum[hh] *= alpha[hh];
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = expf(s[nt][e] - row_max[e >> 1]);
        s[nt][e] = pe;
        row_sum[e >> 1] += pe;
      }
#pragma unroll
    for (int nd = 0; nd < 8; ++nd) {
      o[nd][0] *= alpha[0]; o[nd][1] *= alpha[0];
      o[nd][2] *= alpha[1]; o[nd][3] *= alpha[1];
    }
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kc][0], s[2 * kc][1]), pack_bf16(s[2 * kc][2], s[2 * kc][3]),
          pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
          pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int ndp = 0; ndp < 4; ++ndp) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, &Vs[st][kc * 16 + (lane % 8) + ((lane / 8) % 2) * 8][ndp * 16 + (lane / 16) * 8]);
        mma_bf16(o[2 * ndp], pa, r[0], r[1]);
        mma_bf16(o[2 * ndp + 1], pa, r[2], r[3]);
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration's load
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    row_sum[hh] += __shfl_xor_sync(0xffffffffu, row_sum[hh], 1);
    row_sum[hh] += __shfl_xor_sync(0xffffffffu, row_sum[hh], 2);
  }
  bf16* ob = out + static_cast<size_t>(b) * N * D + h * kDh;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = n0 + warp * 16 + g + 8 * hh;
    if (r < N) {
#pragma unroll
      for (int nd = 0; nd < 8; ++nd)
        store2(ob + static_cast<size_t>(r) * D + nd * 8 + 2 * t, o[nd][2 * hh] / row_sum[hh],
               o[nd][2 * hh + 1] / row_sum[hh]);
    }
  }
}

constexpr int kFq = 64, kFk = 32;

// f32: one thread per query row, K/V tiles in shared memory, FMA
__global__ void __launch_bounds__(kFq)
attention_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const uint8_t* __restrict__ mask,
              float* __restrict__ out, int N, int M, int D, int ldq, int ldkv) {
  __shared__ __align__(16) float Ks[kFk][kDh];
  __shared__ __align__(16) float Vs[kFk][kDh];
  __shared__ float madd[kFk];
  const int b = blockIdx.z, h = blockIdx.y, tid = threadIdx.x;
  const int row = blockIdx.x * kFq + tid;
  const float* kb = k + static_cast<size_t>(b) * M * ldkv + h * kDh;
  const float* vb = v + static_cast<size_t>(b) * M * ldkv + h * kDh;

  float qr[kDh], o[kDh];
  const float* qrow = q + (static_cast<size_t>(b) * N + (row < N ? row : 0)) * ldq + h * kDh;
#pragma unroll
  for (int d = 0; d < kDh; d += 4) {
    const float4 x = *reinterpret_cast<const float4*>(qrow + d);
    qr[d] = x.x; qr[d + 1] = x.y; qr[d + 2] = x.z; qr[d + 3] = x.w;
    o[d] = o[d + 1] = o[d + 2] = o[d + 3] = 0.f;
  }
  float row_max = -INFINITY, row_sum = 0.f;

  for (int k0 = 0; k0 < M; k0 += kFk) {
    __syncthreads();
    for (int i = tid; i < kFk * kDh / 4; i += kFq) {
      const int r = i / (kDh / 4), c = (i % (kDh / 4)) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (k0 + r < M) {
        kv = *reinterpret_cast<const float4*>(kb + static_cast<size_t>(k0 + r) * ldkv + c);
        vv = *reinterpret_cast<const float4*>(vb + static_cast<size_t>(k0 + r) * ldkv + c);
      }
      *reinterpret_cast<float4*>(&Ks[r][c]) = kv;
      *reinterpret_cast<float4*>(&Vs[r][c]) = vv;
    }
    if (tid < kFk) madd[tid] = mask_add(mask, b, M, k0 + tid);
    __syncthreads();

    float s[kFk];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kFk; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < kDh; ++d) dot = fmaf(qr[d], Ks[j][d], dot);
      s[j] = dot * kScale + madd[j];
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(row_max, tile_max);
    const float alpha = expf(row_max - m_new);
    row_max = m_new;
    row_sum *= alpha;
#pragma unroll
    for (int d = 0; d < kDh; ++d) o[d] *= alpha;
#pragma unroll
    for (int j = 0; j < kFk; ++j) {
      const float pj = expf(s[j] - row_max);
      row_sum += pj;
#pragma unroll
      for (int d = 0; d < kDh; ++d) o[d] = fmaf(pj, Vs[j][d], o[d]);
    }
  }
  if (row < N) {
    float* orow = out + (static_cast<size_t>(b) * N + row) * D + h * kDh;
#pragma unroll
    for (int d = 0; d < kDh; ++d) orow[d] = o[d] / row_sum;
  }
}

template <typename T>
cudaError_t attention(const T* q, const T* k, const T* v, const uint8_t* mask, T* out, int B,
                      int N, int M, int D, int H, int ldq, int ldkv, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    const dim3 grid((N + kAq - 1) / kAq, H, B);
    attention_bf16<<<grid, kAttnThreads, 0, stream>>>(q, k, v, mask, out, N, M, D, ldq, ldkv);
  } else {
    const dim3 grid((N + kFq - 1) / kFq, H, B);
    attention_f32<<<grid, kFq, 0, stream>>>(q, k, v, mask, out, N, M, D, ldq, ldkv);
  }
  return cudaGetLastError();
}

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
  if ((err = attention<T>(q, kv, kv + D, mask, attn, B, N, M, D, H, D, 2 * D, s))) return err;
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
// mask: [B, M] uint8 or null. D = 64 * H.
// Returns the CUDA error code of the launches (0 on success).
extern "C" int og_gnn_layer(int is_bf16, int B, int N, int M, int D, int H, int use_offset,
                            const void* xq, const void* xkv, const void* mask,
                            const void* const* weights, const void* const* vectors,
                            void* workspace, void* out, void* stream) {
  if (B == 0 || N == 0) return cudaSuccess;
  if (D != H * kDh || D % kFN != 0 || M <= 0) return cudaErrorInvalidValue;
  const float* const* f = reinterpret_cast<const float* const*>(vectors);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return layer<bf16>(B, N, M, D, H, use_offset, xq, xkv, mask, weights, f, workspace, out, s);
  return layer<float>(B, N, M, D, H, use_offset, xq, xkv, mask, weights, f, workspace, out, s);
}
