// Tiled GEMM with fused epilogues, shared by the layer and message kernels:
//   out[r, c] = epilogue(sum_k A[r, k] * W[c, k])
// with W in torch layout [n_out, k], or, with KN, epilogue(sum_k A[r, k] *
// W[k, c]) with W stored [k, n_out] (an input gradient times a projection's
// weight). bf16: mma.sync m16n8k16 with cp.async double buffering; f32: FMA
// tiles. n_out must be a multiple of 64 and k of 32.

#pragma once

#include "mma.cuh"

namespace {

// kBiasF32 writes f32 whatever T is: out is then a float buffer and ldo counts floats
enum Epilogue { kBias = 0, kConcat = 1, kReluAffine = 2, kResidual = 3, kBiasF32 = 4, kRelu = 5 };

template <typename T>
struct GemmArgs {
  const T* A; int lda;
  const T* W;            // [n_out, k]
  const float* bias;     // [n_out], or null for none
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
  // KN only: rows of W from `k_split` on are rows of W2 (0: W alone)
  int k_split = 0;
};

template <typename T>
__device__ __forceinline__ const T* weight_row(const GemmArgs<T>& p, int c) {
  return p.split && c >= p.split ? p.W2 + static_cast<size_t>(c - p.split) * p.k
                                 : p.W + static_cast<size_t>(c) * p.k;
}
// KN: row kr of the [k, n_out] weight
template <typename T>
__device__ __forceinline__ const T* weight_krow(const GemmArgs<T>& p, int kr) {
  return p.k_split && kr >= p.k_split ? p.W2 + static_cast<size_t>(kr - p.k_split) * p.n_out
                                      : p.W + static_cast<size_t>(kr) * p.n_out;
}
template <typename T>
__device__ __forceinline__ float bias_at(const GemmArgs<T>& p, int c) {
  if (p.split && c >= p.split) return p.bias2[c - p.split];
  return p.bias != nullptr ? p.bias[c] : 0.f;
}

// columns c and c+1 of row r
template <typename T, int EPI>
__device__ __forceinline__ void epilogue2(const GemmArgs<T>& p, int r, int c, float acc0, float acc1) {
  const float y0 = acc0 + bias_at(p, c), y1 = acc1 + bias_at(p, c + 1);
  T* o = p.out + static_cast<size_t>(r) * p.ldo + c;
  if constexpr (EPI == kBias) {
    store2(o, y0, y1);
  } else if constexpr (EPI == kBiasF32) {
    store2(reinterpret_cast<float*>(p.out) + static_cast<size_t>(r) * p.ldo + c, y0, y1);
  } else if constexpr (EPI == kConcat) {
    const float m0 = round_to<T>(y0), m1 = round_to<T>(y1);
    const float2 x = load2(p.x + static_cast<size_t>(r) * p.ldx + c);
    store2(o + p.n_out, m0, m1);
    if (p.use_offset) store2(o, x.x - m0, x.y - m1);
    else store2(o, x.x, x.y);
  } else if constexpr (EPI == kReluAffine) {
    // a ReLU that keeps NaN (fmaxf would drop it): a feature-kind element with
    // no valid key is NaN through the whole layer
    const float r0 = y0 < 0.f ? 0.f : y0, r1 = y1 < 0.f ? 0.f : y1;
    store2(o, r0 * p.scale[c] + p.shift[c], r1 * p.scale[c + 1] + p.shift[c + 1]);
  } else if constexpr (EPI == kRelu) {  // the same ReLU, no affine after it
    store2(o, y0 < 0.f ? 0.f : y0, y1 < 0.f ? 0.f : y1);
  } else {
    const float2 x = load2(p.x + static_cast<size_t>(r) * p.ldx + c);
    store2(o, x.x + y0, x.y + y1);
  }
}

constexpr int kBK = 32;

// bf16: a BM x BN block per CTA, warps of WM x WN m16n8k16 tiles, the k loop
// double-buffered with cp.async. The weight tile is staged as stored ([n][k],
// or [k][n] with KN) and KN reads its fragments with the transposing ldmatrix.
template <int EPI, int BM, int BN, int WM, int WN, bool KN>
__global__ void __launch_bounds__((BM / WM) * (BN / WN) * 32) gemm_bf16(GemmArgs<bf16> p) {
  constexpr int kPad = 8, kThreads = (BM / WM) * (BN / WN) * 32, MI = WM / 16, NI = WN / 8;
  constexpr int kWRows = KN ? kBK : BN, kWCols = KN ? BN : kBK;
  __shared__ __align__(16) bf16 As[2][BM][kBK + kPad];
  __shared__ __align__(16) bf16 Ws[2][kWRows][kWCols + kPad];
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
      const int r = i / (kWCols / 8), c = (i % (kWCols / 8)) * 8;
      if constexpr (KN) cp_async16(&Ws[stage][r][c], weight_krow(p, k0 + r) + n0 + c, true);
      else cp_async16(&Ws[stage][r][c], weight_row(p, n0 + r) + k0 + c, true);
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
        if constexpr (KN)
          ldmatrix_x4_trans(r, &Ws[stage][kk + (lane % 8) + ((lane / 8) % 2) * 8][wn + np * 16 + (lane / 16) * 8]);
        else
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
template <int EPI, bool KN>
__global__ void __launch_bounds__(kFThreads) gemm_f32(GemmArgs<float> p) {
  __shared__ float As[kBK][kFM + 4];  // transposed: [k][m]
  __shared__ __align__(16) float Ws[kBK][kFN + 4];  // [k][n]
  const int tid = threadIdx.x, ty = tid / 8, tx = tid % 8;
  const int m0 = blockIdx.x * kFM, n0 = blockIdx.y * kFN;
  float acc[4][8] = {};  // rows ty + 16i; columns 2tx + 16(j/2) + j%2

  for (int k0 = 0; k0 < p.k; k0 += kBK) {
    for (int i = tid; i < kFM * kBK / 4; i += kFThreads) {
      const int r = i / (kBK / 4), c = (i % (kBK / 4)) * 4;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m0 + r < p.rows)
        a = *reinterpret_cast<const float4*>(p.A + static_cast<size_t>(m0 + r) * p.lda + k0 + c);
      As[c][r] = a.x; As[c + 1][r] = a.y; As[c + 2][r] = a.z; As[c + 3][r] = a.w;
      if constexpr (KN) {  // the same 512 float4s of the weight tile, read along n
        const int kr = i / (kFN / 4), nc = (i % (kFN / 4)) * 4;
        *reinterpret_cast<float4*>(&Ws[kr][nc]) =
            *reinterpret_cast<const float4*>(weight_krow(p, k0 + kr) + n0 + nc);
      } else {
        const float4 w = *reinterpret_cast<const float4*>(weight_row(p, n0 + r) + k0 + c);
        Ws[c][r] = w.x; Ws[c + 1][r] = w.y; Ws[c + 2][r] = w.z; Ws[c + 3][r] = w.w;
      }
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

template <typename T, int EPI, bool KN = false>
cudaError_t gemm(const GemmArgs<T>& p, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    // 128x128 blocks where they fill the card, 64x64 for small batches
    const int big_blocks = ((p.rows + 127) / 128) * (p.n_out / 128);
    if (p.n_out % 128 == 0 && big_blocks >= 132) {
      const dim3 grid((p.rows + 127) / 128, p.n_out / 128);
      gemm_bf16<EPI, 128, 128, 64, 32, KN><<<grid, 256, 0, stream>>>(p);
    } else {
      const dim3 grid((p.rows + 63) / 64, p.n_out / 64);
      gemm_bf16<EPI, 64, 64, 32, 32, KN><<<grid, 128, 0, stream>>>(p);
    }
  } else {
    const dim3 grid((p.rows + kFM - 1) / kFM, p.n_out / kFN);
    gemm_f32<EPI, KN><<<grid, kFThreads, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace
