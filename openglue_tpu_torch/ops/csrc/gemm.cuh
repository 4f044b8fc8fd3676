// Tiled GEMM with fused epilogues, shared by the layer and message kernels:
//   out[r, c] = epilogue(sum_k A[r, k] * W[c, k])
// with W in torch layout [n_out, k], or, with KN, epilogue(sum_k A[r, k] *
// W[k, c]) with W stored [k, n_out] (an input gradient times a projection's
// weight). n_out must be a multiple of 64 and k of 32; any number of rows.
//
// These are the dense products inside the TPU layer kernels of
// openglue_tpu/ops/pallas/gnn_layer_kernel.py (_layer_kernel's projections
// and FFN, _message_kernel's and _train_half_kernel's projections,
// _message_bwd_kernel's recomputed projections and input gradients), which
// the TPU ran on its matrix unit inside one kernel. Here each is a launch of
// its own from the layer kernels (K1, K4, K5, K6, K8).
//
// What bounds them on the H100: at the training shape (12,288 rows, D=256)
// each f32 product is 1.6e9-3.2e9 FLOP against 25-50 MB of operands, so the
// operations bound it: 10-20 us at 165 TFLOP/s (3xTF32), 24-48 us at the
// f32 FMA rate. In bf16 the bytes bound them, launch by launch: K1's five
// GEMMs move 143 MB per layer at B=16 (43 us), twice their operation time.
//
// bf16: mma.sync m16n8k16 with cp.async double buffering. f32: 3xTF32 on
// the tensor cores from a three-stage cp.async ring of raw f32 tiles, up to
// 128 x 128 per CTA of 8 warps (see the f32 section below).

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

// ---------------------------------------------------------------- f32
// 3xTF32 on the tensor cores (mma.sync m16n8k8). Each f32 operand splits as
// x = hi + lo (split_tf32: hi = TF32(x), lo = TF32(x - hi)), and a product is
// lo.hi + hi.lo + hi.hi: within 2^-21 of the f32 product, at a third of the
// TF32 rate (495 / 3 = 165 TFLOP/s on an H100 SXM against 67 TFLOP/s of f32
// FMA).
//
// A k-tile of 32 of each operand is staged as raw f32 by 16-byte cp.async in
// a ring of kF32Stages stages, either row-major ([rows][k], row stride kBK +
// 8) or k-major ([k][cols], row stride cols + 4). Within each k-step of 8 a
// fragment's k slots t and t + 4 hold k = 2t and 2t + 1 (the same in both
// operands, so the sum is unchanged): a row-major fragment is one 8-byte
// shared load per row, and both strides keep a warp's loads off each other's
// banks. Each warp splits the fragments it reads.
//
// Precision. The tensor cores add into their f32 accumulator rounding toward
// zero, so a sum chained through many mma.sync drifts toward zero by about
// half an ulp per step. Here no chain is longer than one k-step: each
// k-step's product starts from zero, takes the two small terms first and
// hi.hi last (one rounding at full size), and is added to the running sum in
// f32, rounding to nearest.
//
// Issue order. The fragment loads, the TF32 conversions and the products are
// volatile asm, so they issue in program order: a warp loads a k-step's raw
// fragments, splits B, then for each group of m-tiles (two at 128 x 128, one
// at 64 x 64) splits A and issues the products in three rounds over the
// n-tiles (lo.hi, hi.lo, hi.hi), so that no mma waits on the one just before
// it.

constexpr int kF32Stages = 3;

__device__ __forceinline__ float lds1(const float* p) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(smem_addr(p)));
  return v;
}
__device__ __forceinline__ float2 lds2(const float* p) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(smem_addr(p)));
  return v;
}

// d = a (16x8, row) * b (8x8, col) in TF32, from a zero accumulator
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// A BM x BN output tile per CTA from warps of WM x WN; A k-major (AK) or
// row-major, B k-major (BK: [k][n]) or row-major ([n][k])
template <int BM, int BN, int WM, int WN, bool AK, bool BK, int MP = 1>
struct F32Tile {
  static constexpr int kStages = kF32Stages, kMP = MP;
  static constexpr int kWarpsN = BN / WN, kThreads = (BM / WM) * kWarpsN * 32;
  static constexpr int MI = WM / 16, NI = WN / 8;
  static constexpr int lda = AK ? BM + 4 : kBK + 8, ldb = BK ? BN + 4 : kBK + 8;
  static constexpr int a_floats = (AK ? kBK : BM) * lda, b_floats = (BK ? kBK : BN) * ldb;
  static constexpr int stage_floats = a_floats + b_floats;
  static constexpr size_t bytes = static_cast<size_t>(kStages) * stage_floats * sizeof(float);
  static_assert(MI % MP == 0 && WN % 8 == 0 && BM % WM == 0 && BN % WN == 0, "tile shape");
};

// The raw A fragment of the m-tile at row m of a staged tile, k-step kk:
// {(g, 2t), (g + 8, 2t), (g, 2t + 1), (g + 8, 2t + 1)}
template <bool KM, int LD>
__device__ __forceinline__ void frag_a(float (&x)[4], const float* s, int m, int kk, int g, int t) {
  if constexpr (KM) {  // s[k][m]
    const float* r = s + (kk + 2 * t) * LD + m + g;
    x[0] = lds1(r); x[1] = lds1(r + 8); x[2] = lds1(r + LD); x[3] = lds1(r + LD + 8);
  } else {  // s[m][k]
    const float2 a = lds2(s + (m + g) * LD + kk + 2 * t), b = lds2(s + (m + g + 8) * LD + kk + 2 * t);
    x[0] = a.x; x[1] = b.x; x[2] = a.y; x[3] = b.y;
  }
}
// The raw B fragment of the n-tile at column n: {(2t, g), (2t + 1, g)}
template <bool KM, int LD>
__device__ __forceinline__ void frag_b(float (&x)[2], const float* s, int n, int kk, int g, int t) {
  if constexpr (KM) {  // s[k][n]
    const float* r = s + (kk + 2 * t) * LD + n + g;
    x[0] = lds1(r); x[1] = lds1(r + LD);
  } else {  // s[n][k]
    const float2 b = lds2(s + (n + g) * LD + kk + 2 * t);
    x[0] = b.x; x[1] = b.y;
  }
}

// acc += A . B over `ktiles` k-tiles of 32 for this warp's WM x WN block:
// load(a_stage, b_stage, kt) issues (does not commit) the cp.async copies of
// k-tile kt into one stage of smem
template <class G, bool AK, bool BK, class Load>
__device__ __forceinline__ void f32_mainloop(float (&acc)[G::MI][G::NI][4], float* smem, int ktiles, int wm, int wn,
                                             Load&& load) {
  constexpr int MP = G::kMP;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  auto stage = [&](int kt) { return smem + (kt % G::kStages) * G::stage_floats; };
#pragma unroll
  for (int s = 0; s < G::kStages - 1; ++s) {
    if (s < ktiles) load(stage(s), stage(s) + G::a_floats, s);
    cp_async_commit();
  }
#pragma unroll 1
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<G::kStages - 2>();
    __syncthreads();  // k-tile kt has landed, and every warp is done with k-tile kt - 1
    const int next = kt + G::kStages - 1;
    if (next < ktiles) load(stage(next), stage(next) + G::a_floats, next);
    cp_async_commit();
    const float* as = stage(kt);
    const float* bs = as + G::a_floats;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      float bx[G::NI][2], ax[G::MI][4];
#pragma unroll
      for (int ni = 0; ni < G::NI; ++ni) frag_b<BK, G::ldb>(bx[ni], bs, wn + ni * 8, kk, g, t);
#pragma unroll
      for (int mi = 0; mi < G::MI; ++mi) frag_a<AK, G::lda>(ax[mi], as, wm + mi * 16, kk, g, t);
      uint32_t bh[G::NI][2], bl[G::NI][2];
#pragma unroll
      for (int ni = 0; ni < G::NI; ++ni) split_tf32(bx[ni], bh[ni], bl[ni]);
#pragma unroll
      for (int mp = 0; mp < G::MI; mp += MP) {
        uint32_t ah[MP][4], al[MP][4];
#pragma unroll
        for (int i = 0; i < MP; ++i) split_tf32(ax[mp + i], ah[i], al[i]);
        float part[MP][G::NI][4];
#pragma unroll
        for (int i = 0; i < MP; ++i)
#pragma unroll
          for (int ni = 0; ni < G::NI; ++ni) mma_tf32_zero(part[i][ni], al[i], bh[ni][0], bh[ni][1]);
#pragma unroll
        for (int i = 0; i < MP; ++i)
#pragma unroll
          for (int ni = 0; ni < G::NI; ++ni) mma_tf32(part[i][ni], ah[i], bl[ni][0], bl[ni][1]);
#pragma unroll
        for (int i = 0; i < MP; ++i)
#pragma unroll
          for (int ni = 0; ni < G::NI; ++ni) mma_tf32(part[i][ni], ah[i], bh[ni][0], bh[ni][1]);
#pragma unroll
        for (int i = 0; i < MP; ++i)
#pragma unroll
          for (int ni = 0; ni < G::NI; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mp + i][ni][e] += part[i][ni][e];
      }
    }
  }
  cp_async_wait<0>();
}

// f32 out = epilogue(A . W^T) (or A . W with KN) for one BM x BN tile
template <int EPI, bool KN, int BM, int BN, int WM, int WN, int MINB, int MP>
__global__ void __launch_bounds__(F32Tile<BM, BN, WM, WN, false, KN, MP>::kThreads, MINB)
    gemm_f32(GemmArgs<float> p) {
  using G = F32Tile<BM, BN, WM, WN, false, KN, MP>;
  extern __shared__ __align__(16) float f32_smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int wm = (warp / G::kWarpsN) * WM, wn = (warp % G::kWarpsN) * WN;
  float acc[G::MI][G::NI][4] = {};
  f32_mainloop<G, false, KN>(acc, f32_smem, p.k / kBK, wm, wn, [&](float* as, float* bs, int kt) {
    const int k0 = kt * kBK;
#pragma unroll 1  // unrolled, the addresses would be hoisted and held in registers across the k loop
    for (int i = tid; i < BM * (kBK / 4); i += G::kThreads) {
      const int r = i / (kBK / 4), c = (i % (kBK / 4)) * 4;
      const bool ok = m0 + r < p.rows;
      cp_async16(as + r * G::lda + c, p.A + static_cast<size_t>(ok ? m0 + r : 0) * p.lda + k0 + c, ok);
    }
#pragma unroll 1
    for (int i = tid; i < BN * (kBK / 4); i += G::kThreads) {
      if constexpr (KN) {
        const int r = i / (BN / 4), c = (i % (BN / 4)) * 4;
        cp_async16(bs + r * G::ldb + c, weight_krow(p, k0 + r) + n0 + c, true);
      } else {
        const int r = i / (kBK / 4), c = (i % (kBK / 4)) * 4;
        cp_async16(bs + r * G::ldb + c, weight_row(p, n0 + r) + k0 + c, true);
      }
    }
  });
#pragma unroll
  for (int mi = 0; mi < G::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < G::NI; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + wm + mi * 16 + g + 8 * h;
        if (r < p.rows)
          epilogue2<float, EPI>(p, r, n0 + wn + ni * 8 + 2 * t, acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
}

// The f32 tile shapes
enum F32TileShape { kTile128x128 = 1, kTile64x64 = 2 };

// The card's SM count, read once
inline int sm_count() {
  static const int sms = [] {
    int device = 0, count = 0;
    if (cudaGetDevice(&device) != cudaSuccess) return 0;
    if (cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) return 0;
    return count;
  }();
  return sms;
}

// The launches of the f32 GEMM kernels this library made, counted on the
// host where each kernel is launched; og_f32_gemm_launches reads them
enum F32Gemm { kGemmF32 = 0, kTnGemmF32 = 1 };
unsigned long long f32_gemm_launches[2] = {0, 0};

inline cudaError_t counted_launch(F32Gemm which) {
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++f32_gemm_launches[which];
  return err;
}

template <int EPI, bool KN, int BM, int BN, int WM, int WN, int MINB, int MP>
cudaError_t launch_gemm_f32(const GemmArgs<float>& p, cudaStream_t stream) {
  using G = F32Tile<BM, BN, WM, WN, false, KN, MP>;
  auto kernel = gemm_f32<EPI, KN, BM, BN, WM, WN, MINB, MP>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(G::bytes));
  if (err != cudaSuccess) return err;
  kernel<<<dim3((p.rows + BM - 1) / BM, p.n_out / BN), G::kThreads, G::bytes, stream>>>(p);
  return counted_launch(kGemmF32);
}

// The launch rule. 128 x 128 (8 warps of 64 x 32, 254 registers: one CTA
// per SM) reads each operand half as often as 64 x 64 (4 warps of 32 x 32,
// 158 registers: three CTAs per SM), but 192 such tiles at 12,288 x 256
// leave a second wave 45% full on 132 SMs. So 128 x 128 where it gives every
// SM two tiles or more, else 64 x 64: the faster of the two at each shape of
// the training step on an H100 (PERF.md). 128 x 64 and 32 x 64 tiles and
// deeper rings were no faster.
inline int f32_tile_rule(int rows, int n_out) {
  const int ctas128 = (rows + 127) / 128 * (n_out / 128);
  return n_out % 128 == 0 && ctas128 >= 2 * sm_count() ? kTile128x128 : kTile64x64;
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
    if (f32_tile_rule(p.rows, p.n_out) == kTile128x128)
      return launch_gemm_f32<EPI, KN, 128, 128, 64, 32, 1, 2>(p, stream);
    return launch_gemm_f32<EPI, KN, 64, 64, 32, 32, 3, 1>(p, stream);
  }
  return cudaGetLastError();
}

}  // namespace

// The launches of gemm_f32 (which 0) or tn_gemm_f32 (which 1) this library
// has made since it was loaded or since that count was last reset; with
// reset, sets the count to 0 after reading it.
extern "C" unsigned long long og_f32_gemm_launches(int which, int reset) {
  if (which != kGemmF32 && which != kTnGemmF32) return 0;
  const unsigned long long launches = f32_gemm_launches[which];
  if (reset) f32_gemm_launches[which] = 0;
  return launches;
}
