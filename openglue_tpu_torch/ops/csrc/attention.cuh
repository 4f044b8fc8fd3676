// Flash-style masked softmax attention forward, shared by the layer, message
// and standalone attention kernels. q and out are [B, H, N, 64] views, k and v
// [B, H, M, 64] views, each given by its HeadLayout (for the layer kernels:
// q [B, N, ldq], k/v [B, M, ldkv] with head h in columns [h*64, h*64+64), k
// and v column blocks of one buffer, out [B, N, D]); mask [B, M] (1 valid, 0
// masked) or null; out in the compute type (the bf16 kernel can also write
// f32); lse [B, H, N] f32 (max + log(sum exp)) or null. The row max and sum
// run online in f32; the division comes after P.V.

#pragma once

#include "mma.cuh"

namespace {

constexpr int kAq = 64, kAk = 64, kAttnThreads = 128;

// bf16: 4 warps, 16 query rows each; S, P and O stay in mma registers; K/V
// tiles double-buffered with cp.async
template <typename O>
__global__ void __launch_bounds__(kAttnThreads)
attention_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
               O* __restrict__ out, float* __restrict__ lse, int N, int M, HeadLayout lq,
               HeadLayout lk, HeadLayout lv, HeadLayout lo) {
  constexpr int kPad = 8;
  __shared__ __align__(16) bf16 Qs[kAq][kDh + kPad];
  __shared__ __align__(16) bf16 Ks[2][kAk][kDh + kPad];
  __shared__ __align__(16) bf16 Vs[2][kAk][kDh + kPad];
  __shared__ float madd[2][kAk];
  const int b = blockIdx.z, h = blockIdx.y, n0 = blockIdx.x * kAq;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const bf16* qb = q + b * lq.batch + h * lq.head;
  const bf16* kb = k + b * lk.batch + h * lk.head;
  const bf16* vb = v + b * lv.batch + h * lv.head;

  auto load_kv = [&](int stage, int k0) {
    for (int i = tid; i < kAk * kDh / 8; i += kAttnThreads) {
      const int r = i / 8, c = (i % 8) * 8;
      const bool ok = k0 + r < M;
      const long long row = ok ? k0 + r : 0;
      cp_async16(&Ks[stage][r][c], kb + row * lk.row + c, ok);
      cp_async16(&Vs[stage][r][c], vb + row * lv.row + c, ok);
    }
    if (tid < kAk) madd[stage][tid] = mask_add(mask, b, M, k0 + tid);
    cp_async_commit();
  };

  for (int i = tid; i < kAq * kDh / 8; i += kAttnThreads) {
    const int r = i / 8, c = (i % 8) * 8;
    const bool ok = n0 + r < N;
    cp_async16(&Qs[r][c], qb + (ok ? n0 + r : 0) * lq.row + c, ok);
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
      uint32_t pa[4];
      pack_a(pa, s[2 * kc], s[2 * kc + 1]);
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
  O* ob = out + b * lo.batch + h * lo.head;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = n0 + warp * 16 + g + 8 * hh;
    if (r < N) {
#pragma unroll
      for (int nd = 0; nd < 8; ++nd)
        store2(ob + r * lo.row + nd * 8 + 2 * t, o[nd][2 * hh] / row_sum[hh],
               o[nd][2 * hh + 1] / row_sum[hh]);
      if (lse != nullptr && t == 0)
        lse[(static_cast<size_t>(b) * gridDim.y + h) * N + r] = row_max[hh] + logf(row_sum[hh]);
    }
  }
}

constexpr int kFq = 64, kFk = 32;

// f32: one thread per query row, K/V tiles in shared memory, FMA
__global__ void __launch_bounds__(kFq)
attention_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const uint8_t* __restrict__ mask,
              float* __restrict__ out, float* __restrict__ lse, int N, int M, HeadLayout lq,
              HeadLayout lk, HeadLayout lv, HeadLayout lo) {
  __shared__ __align__(16) float Ks[kFk][kDh];
  __shared__ __align__(16) float Vs[kFk][kDh];
  __shared__ float madd[kFk];
  const int b = blockIdx.z, h = blockIdx.y, tid = threadIdx.x;
  const int row = blockIdx.x * kFq + tid;
  const float* kb = k + b * lk.batch + h * lk.head;
  const float* vb = v + b * lv.batch + h * lv.head;

  float qr[kDh], o[kDh];
  const float* qrow = q + b * lq.batch + h * lq.head + (row < N ? row : 0) * lq.row;
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
        kv = *reinterpret_cast<const float4*>(kb + (k0 + r) * lk.row + c);
        vv = *reinterpret_cast<const float4*>(vb + (k0 + r) * lv.row + c);
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
    float* orow = out + b * lo.batch + h * lo.head + row * lo.row;
#pragma unroll
    for (int d = 0; d < kDh; ++d) orow[d] = o[d] / row_sum;
    if (lse != nullptr)
      lse[(static_cast<size_t>(b) * gridDim.y + h) * N + row] = row_max + logf(row_sum);
  }
}

// operands by their layouts
template <typename T, typename O = T>
cudaError_t attention_views(const T* q, const T* k, const T* v, const uint8_t* mask, O* out,
                            float* lse, int B, int N, int M, int H, HeadLayout lq, HeadLayout lk,
                            HeadLayout lv, HeadLayout lo, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    const dim3 grid((N + kAq - 1) / kAq, H, B);
    attention_bf16<O><<<grid, kAttnThreads, 0, stream>>>(q, k, v, mask, out, lse, N, M, lq, lk, lv, lo);
  } else {
    const dim3 grid((N + kFq - 1) / kFq, H, B);
    attention_f32<<<grid, kFq, 0, stream>>>(q, k, v, mask, out, lse, N, M, lq, lk, lv, lo);
  }
  return cudaGetLastError();
}

// q [B, N, ldq], k/v [B, M, ldkv], out [B, N, D], head h in columns h*64..
template <typename T, typename O = T>
cudaError_t attention(const T* q, const T* k, const T* v, const uint8_t* mask, O* out, float* lse,
                      int B, int N, int M, int D, int H, int ldq, int ldkv, cudaStream_t stream) {
  const HeadLayout lkv = column_heads(M, ldkv);
  return attention_views<T, O>(q, k, v, mask, out, lse, B, N, M, H, column_heads(N, ldq), lkv, lkv,
                               column_heads(N, D), stream);
}

}  // namespace
