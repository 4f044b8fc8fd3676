// Weight-gradient GEMMs C = X^T Y, shared by the message backward kernel and
// the GEMM test entry (gemm.cu).
//
// These are the TPU kernel openglue_tpu/ops/pallas/gnn_layer_kernel.py::
// _message_bwd_kernel's weight gradients (dWq, dWk, dWv, dWo), which it
// accumulated into one output across its grid, safe only because a TPU grid
// runs in order. Here up to four problems run per launch, each X [rows, >= P]
// and Y [rows, >= Q] (the rows are the B*N or B*M tokens), split over row
// chunks into f32 partials [problem][split][P][Q] that reduce_partials sums
// in a fixed order: no atomics, so two runs give equal bits.
//
// What bounds it on the H100: at the training shape (12,288 rows, D=256) the
// four products are 6.4e9 FLOP against 88 MB of operands, so the operations
// bound them: 39 us at 165 TFLOP/s (3xTF32), 96 us at the f32 FMA rate.
//
// bf16: 64 x 64 tiles, mma.sync m16n8k16 on ldmatrix.trans fragments, chunks
// of about 1,024 rows. f32: the 3xTF32 core of gemm.cuh with both operands
// k-major (the rows are k), 128 x 128 or 64 x 64 per CTA, chunks of 512 rows
// or fewer so that every SM gets a CTA (tn_plan).

#pragma once

#include "gemm.cuh"

namespace {

struct TnProblem {
  const void* X; int ldx;  // [rows, >= P]
  const void* Y; int ldy;  // [rows, >= Q]
  int rows;
};
struct TnArgs {
  TnProblem p[4];
  int P, Q, chunk, splits;
  float* partial;
};

constexpr int kTn = 64, kTk = 32;

__global__ void __launch_bounds__(128) tn_gemm_bf16(TnArgs a) {
  constexpr int MI = 2, NI = 4;
  __shared__ __align__(16) bf16 Xs[2][kTk][kTn + 8];
  __shared__ __align__(16) bf16 Ys[2][kTk][kTn + 8];
  const int prob = blockIdx.z / a.splits, split = blockIdx.z % a.splits;
  const TnProblem pr = a.p[prob];
  const bf16* X = static_cast<const bf16*>(pr.X);
  const bf16* Y = static_cast<const bf16*>(pr.Y);
  const int i0 = blockIdx.y * kTn, j0 = blockIdx.x * kTn;
  const int r_begin = split * a.chunk, r_end = min(pr.rows, r_begin + a.chunk);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  float acc[MI][NI][4] = {};

  auto load = [&](int stage, int r0) {
    for (int i = tid; i < kTk * kTn / 8; i += 128) {
      const int r = i / (kTn / 8), c = (i % (kTn / 8)) * 8;
      const bool ok = r0 + r < r_end;
      const size_t row = static_cast<size_t>(ok ? r0 + r : 0);
      cp_async16(&Xs[stage][r][c], X + row * pr.ldx + i0 + c, ok);
      cp_async16(&Ys[stage][r][c], Y + row * pr.ldy + j0 + c, ok);
    }
    cp_async_commit();
  };

  const int ktiles = r_end > r_begin ? (r_end - r_begin + kTk - 1) / kTk : 0;
  if (ktiles > 0) load(0, r_begin);
  for (int kt = 0; kt < ktiles; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < ktiles) {
      load(st ^ 1, r_begin + (kt + 1) * kTk);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTk; kk += 16) {
      uint32_t af[MI][4], bfr[NI][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)  // X is stored [row][i]: the transposed load gives A = X^T
        ldmatrix_x4_trans(af[mi], &Xs[st][kk + (lane % 8) + (lane / 16) * 8][wm + mi * 16 + ((lane / 8) % 2) * 8]);
#pragma unroll
      for (int np = 0; np < NI / 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, &Ys[st][kk + (lane % 8) + ((lane / 8) % 2) * 8][wn + np * 16 + (lane / 16) * 8]);
        bfr[2 * np][0] = r[0]; bfr[2 * np][1] = r[1];
        bfr[2 * np + 1][0] = r[2]; bfr[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) mma_bf16(acc[mi][ni], af[mi], bfr[ni][0], bfr[ni][1]);
    }
    __syncthreads();
  }
  float* out = a.partial + static_cast<size_t>(blockIdx.z) * a.P * a.Q;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = i0 + wm + mi * 16 + g + 8 * hh, j = j0 + wn + ni * 8 + 2 * t;
        store2(out + static_cast<size_t>(i) * a.Q + j, acc[mi][ni][2 * hh], acc[mi][ni][2 * hh + 1]);
      }
}

// f32: one BM x BN tile of one problem's partial over one row chunk, X^T the
// k-major A operand and Y the k-major B operand of the 3xTF32 core
template <int BM, int BN, int WM, int WN, int MINB, int MP>
__global__ void __launch_bounds__(F32Tile<BM, BN, WM, WN, true, true, MP>::kThreads, MINB) tn_gemm_f32(TnArgs a) {
  using G = F32Tile<BM, BN, WM, WN, true, true, MP>;
  extern __shared__ __align__(16) float f32_smem[];
  const int prob = blockIdx.z / a.splits, split = blockIdx.z % a.splits;
  const TnProblem pr = a.p[prob];
  const float* X = static_cast<const float*>(pr.X);
  const float* Y = static_cast<const float*>(pr.Y);
  const int i0 = blockIdx.y * BM, j0 = blockIdx.x * BN;
  const int r_begin = split * a.chunk, r_end = min(pr.rows, r_begin + a.chunk);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int wm = (warp / G::kWarpsN) * WM, wn = (warp % G::kWarpsN) * WN;
  float acc[G::MI][G::NI][4] = {};
  const int ktiles = r_end > r_begin ? (r_end - r_begin + kBK - 1) / kBK : 0;
  f32_mainloop<G, true, true>(acc, f32_smem, ktiles, wm, wn, [&](float* xs, float* ys, int kt) {
    const int r0 = r_begin + kt * kBK;
#pragma unroll 1  // as in gemm_f32
    for (int i = tid; i < kBK * (BM / 4); i += G::kThreads) {
      const int r = i / (BM / 4), c = (i % (BM / 4)) * 4;
      const bool ok = r0 + r < r_end;
      cp_async16(xs + r * G::lda + c, X + static_cast<size_t>(ok ? r0 + r : 0) * pr.ldx + i0 + c, ok);
    }
#pragma unroll 1
    for (int i = tid; i < kBK * (BN / 4); i += G::kThreads) {
      const int r = i / (BN / 4), c = (i % (BN / 4)) * 4;
      const bool ok = r0 + r < r_end;
      cp_async16(ys + r * G::ldb + c, Y + static_cast<size_t>(ok ? r0 + r : 0) * pr.ldy + j0 + c, ok);
    }
  });
  float* out = a.partial + static_cast<size_t>(blockIdx.z) * a.P * a.Q;
#pragma unroll
  for (int mi = 0; mi < G::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < G::NI; ++ni)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = i0 + wm + mi * 16 + g + 8 * hh, j = j0 + wn + ni * 8 + 2 * t;
        store2(out + static_cast<size_t>(i) * a.Q + j, acc[mi][ni][2 * hh], acc[mi][ni][2 * hh + 1]);
      }
}

struct Outputs4 {
  float* out[4];
};

// out[p][e] = sum over s of partial[p][s][e], s in order
__global__ void __launch_bounds__(256)
reduce_partials(const float* __restrict__ partial, int splits, int count, Outputs4 o) {
  const int e = blockIdx.x * 256 + threadIdx.x;
  if (e >= count) return;
  const float* src = partial + static_cast<size_t>(blockIdx.y) * splits * count + e;
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp) s += src[static_cast<size_t>(sp) * count];
  o.out[blockIdx.y][e] = s;
}

// How the tn GEMM cuts `problems` products of P x Q over at most `rows` rows
struct TnPlan {
  int tile, splits, chunk;
};

// bf16: chunks of about 1,024 rows (at most 64), 64 x 64 tiles. f32: chunks
// of 512 rows in 128 x 128 tiles where that gives every SM a CTA, else 64 x
// 64 tiles and chunks down to 128 rows until it does; at most 64 chunks.
template <typename T>
TnPlan tn_plan(int rows, int P, int Q, int problems) {
  TnPlan pl;
  if constexpr (sizeof(T) == 2) {
    pl.tile = kTile64x64;
    pl.splits = (rows + 1023) / 1024;
    if (pl.splits > 64) pl.splits = 64;
    pl.chunk = ((rows + pl.splits - 1) / pl.splits + kTk - 1) / kTk * kTk;
    return pl;
  }
  const int tiles128 = P % 128 == 0 && Q % 128 == 0 ? problems * (P / 128) * (Q / 128) : 0;
  const int tiles64 = problems * (P / 64) * (Q / 64);
  pl.chunk = 512;
  pl.splits = (rows + pl.chunk - 1) / pl.chunk;
  pl.tile = tiles128 * pl.splits >= sm_count() ? kTile128x128 : kTile64x64;
  while (pl.tile == kTile64x64 && tiles64 * pl.splits < sm_count() && pl.chunk > 128) {
    pl.chunk /= 2;
    pl.splits = (rows + pl.chunk - 1) / pl.chunk;
  }
  if (pl.splits > 64) {
    pl.splits = 64;
    pl.chunk = ((rows + 63) / 64 + kBK - 1) / kBK * kBK;
  }
  return pl;
}

template <int BM, int BN, int WM, int WN, int MINB, int MP>
cudaError_t launch_tn_f32(const TnArgs& a, int problems, cudaStream_t s) {
  using G = F32Tile<BM, BN, WM, WN, true, true, MP>;
  const cudaError_t err = cudaFuncSetAttribute(tn_gemm_f32<BM, BN, WM, WN, MINB, MP>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(G::bytes));
  if (err != cudaSuccess) return err;
  tn_gemm_f32<BM, BN, WM, WN, MINB, MP><<<dim3(a.Q / BN, a.P / BM, problems * a.splits), G::kThreads, G::bytes, s>>>(a);
  return counted_launch(kTnGemmF32);
}

// The partials of `problems` products (a.chunk, a.splits from tn_plan; P and
// Q multiples of 64, of 128 for the 128 x 128 tile), then their sums into
// out[0 .. problems), each P x Q f32
template <typename T>
cudaError_t tn_gemm(const TnArgs& a, int problems, int tile, const Outputs4& out, cudaStream_t s) {
  cudaError_t err;
  if constexpr (sizeof(T) == 2) {
    tn_gemm_bf16<<<dim3(a.Q / kTn, a.P / kTn, problems * a.splits), 128, 0, s>>>(a);
    err = cudaGetLastError();
  } else if (tile == kTile128x128) {
    if (a.P % 128 != 0 || a.Q % 128 != 0) return cudaErrorInvalidValue;
    err = launch_tn_f32<128, 128, 64, 32, 1, 2>(a, problems, s);
  } else if (tile == kTile64x64) {
    err = launch_tn_f32<64, 64, 32, 32, 3, 1>(a, problems, s);
  } else {
    return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  reduce_partials<<<dim3((a.P * a.Q + 255) / 256, problems), 256, 0, s>>>(a.partial, a.splits, a.P * a.Q, out);
  return cudaGetLastError();
}

}  // namespace
