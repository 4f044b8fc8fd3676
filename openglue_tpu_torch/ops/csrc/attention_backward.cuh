// Masked softmax attention backward in two passes, shared by the message
// backward kernel and the standalone attention backward kernel. Per head, from
// q, k, v, the cotangent g of the attention output and the forward's per-row
// LSE:
//   P  = exp(q k^T * dh^-0.5 + mask - lse)                      (f32, one exp)
//   dP = g v^T;  dS = P o (dP - di),  di = rowsum(dP o P) - g_lse (f32)
//   dV = T(P)^T g;  dK = T(dS)^T q * scale;  dQ = T(dS) k * scale
// g_lse [B, H, N] (or null, read as 0) is the cotangent of the forward's LSE:
// d lse / dS = P, so it enters dS = P o (dP - rowsum(dP o P) + g_lse) through
// di, where pass A forms it, before pass A uses it and before it stores it
// for pass B.
// Pass A takes one 64-query block per CTA (and head): it forms dS over the key
// tiles and accumulates dQ in registers. Pass B takes one 64-key block per
// CTA: it sweeps the query tiles with the LSE and pass A's row sums and
// accumulates dK and dV in registers. S and dP are recomputed in each pass;
// that keeps every sum inside one CTA: no atomics, a fixed order, equal bits
// on two runs.
//
// di comes from a first sweep of pass A over the key tiles (kSweep), or, where
// the caller holds the forward's output o, from rowsum(g o o), which is the
// same number (sum_j P_ij g_i . v_j = g_i . o_i) without the sweep.
//
// Every operand is a [B, H, L, 64] view given by its HeadLayout, so that the
// passes read projections stored [B, L, D] (head h in columns h*64..) and
// tensors stored [B, H, L, 64] alike. bf16 uses mma.sync with cp.async double
// buffering. f32 uses FMA: two threads per query (pass A) or key (pass B) row,
// each owning half of the head dims, with the accumulators in registers.
//
// `dead` [B] (or null) marks batch elements whose keys are all masked. Their
// forward is the uniform average over the M keys (every logit is absorbed by
// the -1e9 it is added to), and no f32 LSE near -1e9 can say so: for them the
// passes take logits of 0 and an LSE of log(M). With `zero_dead_ds` they also
// take dS = 0 there (dQ = dK = 0, dV = P^T g): the gradient of logits that a
// `where` replaced by -1e9, as the XLA backward of the LSE-emitting attention
// differentiates them; without it, dS of the uniform softmax, as the TPU
// backward kernel does.

#pragma once

#include "mma.cuh"

namespace {

template <typename T>
struct AttnBwdArgs {
  const T *q, *g, *k, *v;
  const T* out;  // the forward's output: read only without kSweep
  HeadLayout lq, lg, lk, lv, lo;
  const uint8_t* mask;  // [B, M] (1 valid, 0 masked) or null
  const uint8_t* dead;  // [B] or null
  const float* lse;     // [B, H, N]
  float* di;            // [B, H, N]: written by pass A, read by pass B
  const float* g_lse;   // [B, H, N] or null
  int zero_dead_ds;     // dS = 0 in dead elements
  int N, M;
  T* dq; float* dq32; HeadLayout ldq;        // pass A; dq32 may be null
  T *dk, *dv; HeadLayout ldkv;               // pass B, in the compute type
  float *dk32, *dv32; HeadLayout ldkv32;     // pass B, f32 copies; may be null
};

__device__ __forceinline__ float key_add(const uint8_t* mask, int b, int M, int key, bool dead) {
  return dead && key < M ? 0.f : mask_add(mask, b, M, key);
}

constexpr int kBq = 64, kBk = 64, kBThreads = 128, kPadB = 8;

// ------------------------------------------------ pass A (bf16): dQ (and di)
template <bool kSweep>
__global__ void __launch_bounds__(kBThreads) attn_bwd_dq_bf16(AttnBwdArgs<bf16> a) {
  __shared__ __align__(16) bf16 Rs[kBq][kDh + kPadB];  // stages Q, then g
  __shared__ __align__(16) bf16 Ks[2][kBk][kDh + kPadB];
  __shared__ __align__(16) bf16 Vs[2][kBk][kDh + kPadB];
  __shared__ float madd[2][kBk];
  const int b = blockIdx.z, h = blockIdx.y, H = gridDim.y, n0 = blockIdx.x * kBq;
  const int N = a.N, M = a.M;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const bool dead = a.dead != nullptr && a.dead[b] != 0;
  const float lscale = dead ? 0.f : kScale, ds_keep = dead && a.zero_dead_ds ? 0.f : 1.f;
  const uint8_t* __restrict__ mask = a.mask;
  const bf16* __restrict__ kb = a.k + b * a.lk.batch + h * a.lk.head;
  const bf16* __restrict__ vb = a.v + b * a.lv.batch + h * a.lv.head;
  const long long ldk = a.lk.row, ldv = a.lv.row;

  auto stage_rows = [&](const bf16* src, long long ld, uint32_t (&frag)[4][4]) {
    for (int i = tid; i < kBq * kDh / 8; i += kBThreads) {
      const int r = i / 8, c = (i % 8) * 8;
      const bool ok = n0 + r < N;
      cp_async16(&Rs[r][c], src + (ok ? n0 + r : 0) * ld + c, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      ldmatrix_x4(frag[kk], &Rs[warp * 16 + (lane % 16)][kk * 16 + (lane / 16) * 8]);
    __syncthreads();
  };
  uint32_t qa[4][4], da[4][4];
  const bf16* gb = a.g + b * a.lg.batch + h * a.lg.head;
  stage_rows(a.q + b * a.lq.batch + h * a.lq.head, a.lq.row, qa);
  stage_rows(gb, a.lg.row, da);

  float lse_r[2];
  float di[2] = {0.f, 0.f};
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = n0 + warp * 16 + g + 8 * hh;
    lse_r[hh] = INFINITY;  // padding rows: P = 0
    if (r < N) lse_r[hh] = dead ? logf(static_cast<float>(M)) : a.lse[(static_cast<size_t>(b) * H + h) * N + r];
    if constexpr (!kSweep) {
      float s = 0.f;
      if (r < N) {
        const bf16* grow = gb + r * a.lg.row;
        const bf16* orow = a.out + b * a.lo.batch + h * a.lo.head + r * a.lo.row;
#pragma unroll
        for (int nd = 0; nd < 8; ++nd) {
          const float2 x = load2(grow + nd * 8 + 2 * t), y = load2(orow + nd * 8 + 2 * t);
          s = fmaf(x.x, y.x, s);
          s = fmaf(x.y, y.y, s);
        }
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      di[hh] = s - (a.g_lse != nullptr && r < N ? a.g_lse[(static_cast<size_t>(b) * H + h) * N + r] : 0.f);
    }
  }

  auto load_kv = [&](int stage, int k0) {
    for (int i = tid; i < kBk * kDh / 8; i += kBThreads) {
      const int r = i / 8, c = (i % 8) * 8;
      const bool ok = k0 + r < M;
      const long long row = ok ? k0 + r : 0;
      cp_async16(&Ks[stage][r][c], kb + row * ldk + c, ok);
      cp_async16(&Vs[stage][r][c], vb + row * ldv + c, ok);
    }
    if (tid < kBk) madd[stage][tid] = key_add(mask, b, M, k0 + tid, dead);
    cp_async_commit();
  };

  float dq[8][4] = {};
  const int ktiles = (M + kBk - 1) / kBk, total = kSweep ? 2 * ktiles : ktiles;
  load_kv(0, 0);
  for (int it = 0; it < total; ++it) {
    const int st = it & 1;
    const bool second = !kSweep || it >= ktiles;  // the sweep that forms dS and dQ
    if (it + 1 < total) {
      load_kv(st ^ 1, ((it + 1) % ktiles) * kBk);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    float s[8][4] = {}, dp[8][4] = {};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        const int row = np * 16 + (lane % 8) + (lane / 16) * 8, col = kk * 16 + ((lane / 8) % 2) * 8;
        uint32_t r[4];
        ldmatrix_x4(r, &Ks[st][row][col]);
        mma_bf16(s[2 * np], qa[kk], r[0], r[1]);
        mma_bf16(s[2 * np + 1], qa[kk], r[2], r[3]);
        ldmatrix_x4(r, &Vs[st][row][col]);
        mma_bf16(dp[2 * np], da[kk], r[0], r[1]);
        mma_bf16(dp[2 * np + 1], da[kk], r[2], r[3]);
      }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nt][e] * lscale + madd[st][nt * 8 + 2 * t + (e & 1)] - lse_r[e >> 1]);
        if (second) s[nt][e] = ds_keep * p * (dp[nt][e] - di[e >> 1]);
        else di[e >> 1] = fmaf(p, dp[nt][e], di[e >> 1]);
      }
    if (second) {
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        uint32_t pa[4];
        pack_a(pa, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
        for (int ndp = 0; ndp < 4; ++ndp) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, &Ks[st][kc * 16 + (lane % 8) + ((lane / 8) % 2) * 8][ndp * 16 + (lane / 16) * 8]);
          mma_bf16(dq[2 * ndp], pa, r[0], r[1]);
          mma_bf16(dq[2 * ndp + 1], pa, r[2], r[3]);
        }
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration's load
    if (kSweep && it == ktiles - 1) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        di[hh] += __shfl_xor_sync(0xffffffffu, di[hh], 1);
        di[hh] += __shfl_xor_sync(0xffffffffu, di[hh], 2);
        const int r = n0 + warp * 16 + g + 8 * hh;
        if (a.g_lse != nullptr && r < N) di[hh] -= a.g_lse[(static_cast<size_t>(b) * H + h) * N + r];
      }
    }
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = n0 + warp * 16 + g + 8 * hh;
    if (r < N) {
      const long long base = b * a.ldq.batch + h * a.ldq.head + r * a.ldq.row;
#pragma unroll
      for (int nd = 0; nd < 8; ++nd) {
        const float x0 = dq[nd][2 * hh] * kScale, x1 = dq[nd][2 * hh + 1] * kScale;
        if (a.dq32 != nullptr) store2(a.dq32 + base + nd * 8 + 2 * t, x0, x1);
        store2(a.dq + base + nd * 8 + 2 * t, x0, x1);
      }
      if (t == 0) a.di[(static_cast<size_t>(b) * H + h) * N + r] = di[hh];
    }
  }
}

// ------------------------------------------------ pass B (bf16): dK, dV
__global__ void __launch_bounds__(kBThreads) attn_bwd_dkdv_bf16(AttnBwdArgs<bf16> a) {
  __shared__ __align__(16) bf16 Rs[kBk][kDh + kPadB];  // stages K, then V
  __shared__ __align__(16) bf16 Qs[2][kBq][kDh + kPadB];
  __shared__ __align__(16) bf16 As[2][kBq][kDh + kPadB];
  __shared__ float lse_s[2][kBq], di_s[2][kBq];
  const int b = blockIdx.z, h = blockIdx.y, H = gridDim.y, m0 = blockIdx.x * kBk;
  const int N = a.N, M = a.M;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const bool dead = a.dead != nullptr && a.dead[b] != 0;
  const float lscale = dead ? 0.f : kScale, dead_lse = logf(static_cast<float>(M));
  const float ds_keep = dead && a.zero_dead_ds ? 0.f : 1.f;
  const bf16* __restrict__ qb = a.q + b * a.lq.batch + h * a.lq.head;
  const bf16* __restrict__ ab = a.g + b * a.lg.batch + h * a.lg.head;
  const float* __restrict__ lse = a.lse;
  const float* __restrict__ di = a.di;
  const long long ldq = a.lq.row, lda = a.lg.row;
  const size_t stat = (static_cast<size_t>(b) * H + h) * N;

  auto stage_rows = [&](const bf16* src, long long ld, uint32_t (&frag)[4][4]) {
    for (int i = tid; i < kBk * kDh / 8; i += kBThreads) {
      const int r = i / 8, c = (i % 8) * 8;
      const bool ok = m0 + r < M;
      cp_async16(&Rs[r][c], src + (ok ? m0 + r : 0) * ld + c, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      ldmatrix_x4(frag[kk], &Rs[warp * 16 + (lane % 16)][kk * 16 + (lane / 16) * 8]);
    __syncthreads();
  };
  uint32_t ka[4][4], va[4][4];
  stage_rows(a.k + b * a.lk.batch + h * a.lk.head, a.lk.row, ka);
  stage_rows(a.v + b * a.lv.batch + h * a.lv.head, a.lv.row, va);
  float madd_r[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) madd_r[hh] = key_add(a.mask, b, M, m0 + warp * 16 + g + 8 * hh, dead);

  auto load_q = [&](int stage, int q0) {
    for (int i = tid; i < kBq * kDh / 8; i += kBThreads) {
      const int r = i / 8, c = (i % 8) * 8;
      const bool ok = q0 + r < N;
      const long long row = ok ? q0 + r : 0;
      cp_async16(&Qs[stage][r][c], qb + row * ldq + c, ok);
      cp_async16(&As[stage][r][c], ab + row * lda + c, ok);
    }
    if (tid < kBq) {
      const bool ok = q0 + tid < N;
      lse_s[stage][tid] = ok ? (dead ? dead_lse : lse[stat + q0 + tid]) : INFINITY;  // padding: P = 0
      di_s[stage][tid] = ok ? di[stat + q0 + tid] : 0.f;
    }
    cp_async_commit();
  };

  float dk[8][4] = {}, dv[8][4] = {};
  const int qtiles = (N + kBq - 1) / kBq;
  load_q(0, 0);
  for (int qt = 0; qt < qtiles; ++qt) {
    const int st = qt & 1;
    if (qt + 1 < qtiles) {
      load_q(st ^ 1, (qt + 1) * kBq);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // transposed scores: rows are this warp's 16 keys, columns the 64 queries
    float s[8][4] = {}, dp[8][4] = {};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        const int row = np * 16 + (lane % 8) + (lane / 16) * 8, col = kk * 16 + ((lane / 8) % 2) * 8;
        uint32_t r[4];
        ldmatrix_x4(r, &Qs[st][row][col]);
        mma_bf16(s[2 * np], ka[kk], r[0], r[1]);
        mma_bf16(s[2 * np + 1], ka[kk], r[2], r[3]);
        ldmatrix_x4(r, &As[st][row][col]);
        mma_bf16(dp[2 * np], va[kk], r[0], r[1]);
        mma_bf16(dp[2 * np + 1], va[kk], r[2], r[3]);
      }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + 2 * t + (e & 1);
        const float p = expf(s[nt][e] * lscale + madd_r[e >> 1] - lse_s[st][c]);
        dp[nt][e] = ds_keep * p * (dp[nt][e] - di_s[st][c]);
        s[nt][e] = p;
      }
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t pa[4], sa[4];
      pack_a(pa, s[2 * kc], s[2 * kc + 1]);
      pack_a(sa, dp[2 * kc], dp[2 * kc + 1]);
#pragma unroll
      for (int ndp = 0; ndp < 4; ++ndp) {
        const int row = kc * 16 + (lane % 8) + ((lane / 8) % 2) * 8, col = ndp * 16 + (lane / 16) * 8;
        uint32_t r[4];
        ldmatrix_x4_trans(r, &As[st][row][col]);
        mma_bf16(dv[2 * ndp], pa, r[0], r[1]);
        mma_bf16(dv[2 * ndp + 1], pa, r[2], r[3]);
        ldmatrix_x4_trans(r, &Qs[st][row][col]);
        mma_bf16(dk[2 * ndp], sa, r[0], r[1]);
        mma_bf16(dk[2 * ndp + 1], sa, r[2], r[3]);
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration's load
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = m0 + warp * 16 + g + 8 * hh;
    if (r < M) {
      const long long at = b * a.ldkv.batch + h * a.ldkv.head + r * a.ldkv.row;
      const long long at32 = b * a.ldkv32.batch + h * a.ldkv32.head + r * a.ldkv32.row;
#pragma unroll
      for (int nd = 0; nd < 8; ++nd) {
        const int c = nd * 8 + 2 * t;
        const float k0 = dk[nd][2 * hh] * kScale, k1 = dk[nd][2 * hh + 1] * kScale;
        if (a.dk32 != nullptr) {
          store2(a.dk32 + at32 + c, k0, k1);
          store2(a.dv32 + at32 + c, dv[nd][2 * hh], dv[nd][2 * hh + 1]);
        }
        store2(a.dk + at + c, k0, k1);
        store2(a.dv + at + c, dv[nd][2 * hh], dv[nd][2 * hh + 1]);
      }
    }
  }
}

// ------------------------------------------------ pass A (f32): two threads per query row
// Each thread of a pair owns one contiguous half of the head dims: it forms
// half of every dot product, the pair adds the halves with one shuffle, and
// the thread accumulates its half of dQ in registers. Shared rows keep the
// halves 36 words apart, so that the pair's 16-byte loads fall in different
// banks.
constexpr int kFbq = 64, kFbk = 32, kFbThreads = 128, kHalf = kDh / 2, kRow = kDh + 4;

__device__ __forceinline__ int padded(int d) { return d + (d >= kHalf ? 4 : 0); }

// a [rows, 64] f32 tile of rows [r0, r0 + rows) of src (row stride ld) into
// shared rows of kRow words; rows past `limit` are zero
template <int ROWS>
__device__ __forceinline__ void load_tile(float (*dst)[kRow], const float* src, long long ld, int r0,
                                          int limit, int tid) {
  for (int i = tid; i < ROWS * kDh / 4; i += kFbThreads) {
    const int r = i / (kDh / 4), c = (i % (kDh / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < limit) x = *reinterpret_cast<const float4*>(src + (r0 + r) * ld + c);
    *reinterpret_cast<float4*>(&dst[r][padded(c)]) = x;
  }
}

// this thread's half of a shared row (16-byte loads) dotted with x
__device__ __forceinline__ float half_dot(const float* row, const float (&x)[kHalf]) {
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < kHalf; e += 4) {
    const float4 y = *reinterpret_cast<const float4*>(row + e);
    s = fmaf(x[e], y.x, s); s = fmaf(x[e + 1], y.y, s);
    s = fmaf(x[e + 2], y.z, s); s = fmaf(x[e + 3], y.w, s);
  }
  return s;
}

// acc += w * (this thread's half of a shared row)
__device__ __forceinline__ void half_axpy(float (&acc)[kHalf], float w, const float* row) {
#pragma unroll
  for (int e = 0; e < kHalf; e += 4) {
    const float4 y = *reinterpret_cast<const float4*>(row + e);
    acc[e] = fmaf(w, y.x, acc[e]); acc[e + 1] = fmaf(w, y.y, acc[e + 1]);
    acc[e + 2] = fmaf(w, y.z, acc[e + 2]); acc[e + 3] = fmaf(w, y.w, acc[e + 3]);
  }
}

template <bool kSweep>
__global__ void __launch_bounds__(kFbThreads) attn_bwd_dq_f32(AttnBwdArgs<float> a) {
  __shared__ __align__(16) float Ks[kFbk][kRow];
  __shared__ __align__(16) float Vs[kFbk][kRow];
  __shared__ float madd[kFbk];
  const int b = blockIdx.z, h = blockIdx.y, H = gridDim.y, tid = threadIdx.x, half = tid & 1;
  const int N = a.N, M = a.M;
  const int row = blockIdx.x * kFbq + tid / 2, col = half * (kHalf + 4);
  const bool dead = a.dead != nullptr && a.dead[b] != 0;
  const float lscale = dead ? 0.f : kScale, ds_keep = dead && a.zero_dead_ds ? 0.f : 1.f;
  const uint8_t* __restrict__ mask = a.mask;
  const float* __restrict__ kb = a.k + b * a.lk.batch + h * a.lk.head;
  const float* __restrict__ vb = a.v + b * a.lv.batch + h * a.lv.head;
  const long long src = row < N ? row : 0;
  const float* __restrict__ qrow = a.q + b * a.lq.batch + h * a.lq.head + src * a.lq.row + half * kHalf;
  const float* __restrict__ grow = a.g + b * a.lg.batch + h * a.lg.head + src * a.lg.row + half * kHalf;
  float qr[kHalf], da[kHalf], dq[kHalf];
#pragma unroll
  for (int e = 0; e < kHalf; ++e) {
    qr[e] = qrow[e];
    da[e] = grow[e];
    dq[e] = 0.f;
  }
  float lse_r = INFINITY;  // padding rows: P = 0
  if (row < N) lse_r = dead ? logf(static_cast<float>(M)) : a.lse[(static_cast<size_t>(b) * H + h) * N + row];
  float di = 0.f;
  if constexpr (!kSweep) {
    const float* orow = a.out + b * a.lo.batch + h * a.lo.head + src * a.lo.row + half * kHalf;
#pragma unroll
    for (int e = 0; e < kHalf; ++e) di = fmaf(da[e], orow[e], di);
    di += __shfl_xor_sync(0xffffffffu, di, 1);
  }
  const float g_lse = a.g_lse != nullptr && row < N ? a.g_lse[(static_cast<size_t>(b) * H + h) * N + row] : 0.f;
  if constexpr (!kSweep) di -= g_lse;

  for (int pass = kSweep ? 0 : 1; pass < 2; ++pass) {
    for (int k0 = 0; k0 < M; k0 += kFbk) {
      __syncthreads();
      load_tile<kFbk>(Ks, kb, a.lk.row, k0, M, tid);
      load_tile<kFbk>(Vs, vb, a.lv.row, k0, M, tid);
      if (tid < kFbk) madd[tid] = key_add(mask, b, M, k0 + tid, dead);
      __syncthreads();
#pragma unroll 1
      for (int j = 0; j < kFbk; ++j) {
        float s = half_dot(&Ks[j][col], qr), dp = half_dot(&Vs[j][col], da);
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        dp += __shfl_xor_sync(0xffffffffu, dp, 1);
        const float p = expf(s * lscale + madd[j] - lse_r);
        if (pass == 0) di = fmaf(p, dp, di);
        else half_axpy(dq, ds_keep * p * (dp - di), &Ks[j][col]);
      }
    }
    if (kSweep && pass == 0) di -= g_lse;
  }
  if (row < N) {
    const long long base = b * a.ldq.batch + h * a.ldq.head + row * a.ldq.row + half * kHalf;
#pragma unroll
    for (int e = 0; e < kHalf; ++e) {
      const float x = dq[e] * kScale;
      if (a.dq32 != nullptr) a.dq32[base + e] = x;
      a.dq[base + e] = x;
    }
    if (half == 0) a.di[(static_cast<size_t>(b) * H + h) * N + row] = di;
  }
}

// ------------------------------------------------ pass B (f32): two threads per key row
// The same split of the head dims; dK and dV accumulate in registers.
constexpr int kFbkey = 64, kFbqt = 32;

__global__ void __launch_bounds__(kFbThreads) attn_bwd_dkdv_f32(AttnBwdArgs<float> a) {
  __shared__ __align__(16) float Qs[kFbqt][kRow];
  __shared__ __align__(16) float As[kFbqt][kRow];
  __shared__ float lse_s[kFbqt], di_s[kFbqt];
  const int b = blockIdx.z, h = blockIdx.y, H = gridDim.y, tid = threadIdx.x, half = tid & 1;
  const int N = a.N, M = a.M;
  const int key = blockIdx.x * kFbkey + tid / 2, col = half * (kHalf + 4);
  const bool dead = a.dead != nullptr && a.dead[b] != 0;
  const float lscale = dead ? 0.f : kScale, dead_lse = logf(static_cast<float>(M));
  const float ds_keep = dead && a.zero_dead_ds ? 0.f : 1.f;
  const size_t stat = (static_cast<size_t>(b) * H + h) * N;
  const long long src = key < M ? key : 0;
  const float* __restrict__ qb = a.q + b * a.lq.batch + h * a.lq.head;
  const float* __restrict__ ab = a.g + b * a.lg.batch + h * a.lg.head;
  const float* __restrict__ krow = a.k + b * a.lk.batch + h * a.lk.head + src * a.lk.row + half * kHalf;
  const float* __restrict__ vrow = a.v + b * a.lv.batch + h * a.lv.head + src * a.lv.row + half * kHalf;
  const float* __restrict__ lse = a.lse;
  const float* __restrict__ di = a.di;
  float kr[kHalf], vr[kHalf], dk[kHalf], dv[kHalf];
#pragma unroll
  for (int e = 0; e < kHalf; ++e) {
    kr[e] = krow[e];
    vr[e] = vrow[e];
    dk[e] = dv[e] = 0.f;
  }
  const float madd_k = key_add(a.mask, b, M, key, dead);

  for (int q0 = 0; q0 < N; q0 += kFbqt) {
    __syncthreads();
    load_tile<kFbqt>(Qs, qb, a.lq.row, q0, N, tid);
    load_tile<kFbqt>(As, ab, a.lg.row, q0, N, tid);
    if (tid < kFbqt) {
      const bool ok = q0 + tid < N;
      lse_s[tid] = ok ? (dead ? dead_lse : lse[stat + q0 + tid]) : INFINITY;  // padding: P = 0
      di_s[tid] = ok ? di[stat + q0 + tid] : 0.f;
    }
    __syncthreads();
#pragma unroll 1
    for (int i = 0; i < kFbqt; ++i) {
      float s = half_dot(&Qs[i][col], kr), dp = half_dot(&As[i][col], vr);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      dp += __shfl_xor_sync(0xffffffffu, dp, 1);
      const float p = expf(s * lscale + madd_k - lse_s[i]);
      half_axpy(dv, p, &As[i][col]);
      half_axpy(dk, ds_keep * p * (dp - di_s[i]), &Qs[i][col]);
    }
  }
  if (key < M) {
    const long long at = b * a.ldkv.batch + h * a.ldkv.head + key * a.ldkv.row + half * kHalf;
    const long long at32 = b * a.ldkv32.batch + h * a.ldkv32.head + key * a.ldkv32.row + half * kHalf;
#pragma unroll
    for (int e = 0; e < kHalf; ++e) {
      const float dkx = dk[e] * kScale;
      if (a.dk32 != nullptr) {
        a.dk32[at32 + e] = dkx;
        a.dv32[at32 + e] = dv[e];
      }
      a.dk[at + e] = dkx;
      a.dv[at + e] = dv[e];
    }
  }
}

// pass A, then pass B, on one stream
template <typename T, bool kSweep>
cudaError_t attention_backward_passes(const AttnBwdArgs<T>& a, int B, int H, cudaStream_t s) {
  cudaError_t err;
  if constexpr (sizeof(T) == 2) {
    attn_bwd_dq_bf16<kSweep><<<dim3((a.N + kBq - 1) / kBq, H, B), kBThreads, 0, s>>>(a);
    if ((err = cudaGetLastError())) return err;
    attn_bwd_dkdv_bf16<<<dim3((a.M + kBk - 1) / kBk, H, B), kBThreads, 0, s>>>(a);
  } else {
    attn_bwd_dq_f32<kSweep><<<dim3((a.N + kFbq - 1) / kFbq, H, B), kFbThreads, 0, s>>>(a);
    if ((err = cudaGetLastError())) return err;
    attn_bwd_dkdv_f32<<<dim3((a.M + kFbkey - 1) / kFbkey, H, B), kFbThreads, 0, s>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace
