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
// di comes from the forward's output o as rowsum(g o o) (sum_j P_ij g_i . v_j
// = g_i . o_i) times the mass of P on the row (1, or M in a dead element
// whose P is 1 on every key, below), or, in bf16 with kSweep, from a first
// sweep of pass A over the key tiles. The bf16 message backward keeps the
// sweep: its attn is rounded to bf16, and rowsum(g o attn) moves every row's
// dS by the rounding (dWq 3.9e-2 from the plain version at B=12 N=1024
// without the sweep, against a bar of 2^-6).
//
// Every operand is a [B, H, L, dh] view given by its HeadLayout, so that the
// passes read projections stored [B, L, D] (head h in columns h*dh..) and
// tensors stored [B, H, L, dh] alike; dh, 32 or 64, is a template parameter.
// bf16 uses mma.sync with cp.async double buffering. f32 runs every product
// in 3xTF32 on the tensor cores (tf32_tiles.cuh), with the tiles staged by a
// cp.async ring and split into hi/lo fragments once per tile.
//
// `dead` [B] (or null) marks batch elements whose keys are all masked. Their
// forward is the uniform average over the M keys (every logit is absorbed by
// the -1e9 it is added to), and no f32 LSE near -1e9 can say so: for them the
// passes take logits of 0 and an LSE of log(M). With `dead_p_one` they take
// an LSE of 0 instead, so P = 1 on every key: the message backward's TPU
// kernel rebuilds P from an f32 LSE at -1e9, which has lost log M. With
// `zero_dead_ds` they also take dS = 0 there (dQ = dK = 0, dV = P^T g): the
// gradient of logits that a `where` replaced by -1e9, as the XLA backward of
// the LSE-emitting attention differentiates them; without it, dS of the
// softmax they rebuild, as the TPU backward kernels do.

#pragma once

#include "tf32_tiles.cuh"

namespace {

template <typename T>
struct AttnBwdArgs {
  const T *q, *g, *k, *v;
  const T* out;  // the forward's output: read unless kSweep
  HeadLayout lq, lg, lk, lv, lo;
  const uint8_t* mask;  // [B, M] (1 valid, 0 masked) or null
  const uint8_t* dead;  // [B] or null
  const float* lse;     // [B, H, N]
  float* di;            // [B, H, N]: written by pass A, read by pass B
  const float* g_lse;   // [B, H, N] or null
  int zero_dead_ds;     // dS = 0 in dead elements
  int dead_p_one;       // P = 1 (else 1/M) on every key of dead elements
  int N, M;
  T* dq; float* dq32; HeadLayout ldq;        // pass A; dq32 may be null
  T *dk, *dv; HeadLayout ldkv;               // pass B, in the compute type
  float *dk32, *dv32; HeadLayout ldkv32;     // pass B, f32 copies; may be null
};

__device__ __forceinline__ float key_add(const uint8_t* mask, int b, int M, int key, bool dead) {
  return dead && key < M ? 0.f : mask_add(mask, b, M, key);
}

// The LSE a dead element's rows take, and the mass of P on such a row
template <typename T>
__device__ __forceinline__ float dead_lse(const AttnBwdArgs<T>& a) {
  return a.dead_p_one ? 0.f : logf(static_cast<float>(a.M));
}
template <typename T>
__device__ __forceinline__ float row_mass(const AttnBwdArgs<T>& a, bool dead) {
  return dead && a.dead_p_one ? static_cast<float>(a.M) : 1.f;
}

constexpr int kBq = 64, kBk = 64, kBThreads = 128, kPadB = 8;

// ------------------------------------------------ pass A (bf16): dQ (and di)
template <int DH, bool kSweep>
__global__ void __launch_bounds__(kBThreads) attn_bwd_dq_bf16(AttnBwdArgs<bf16> a) {
  constexpr int kChunks = DH / 8, kSteps = DH / 16;  // 16-byte chunks per row; k-steps over dh
  constexpr float kScale = Head<DH>::scale;
  __shared__ __align__(16) bf16 Rs[kBq][DH + kPadB];  // stages Q, then g
  __shared__ __align__(16) bf16 Ks[2][kBk][DH + kPadB];
  __shared__ __align__(16) bf16 Vs[2][kBk][DH + kPadB];
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

  auto stage_rows = [&](const bf16* src, long long ld, uint32_t (&frag)[kSteps][4]) {
    for (int i = tid; i < kBq * kChunks; i += kBThreads) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      const bool ok = n0 + r < N;
      cp_async16(&Rs[r][c], src + (ok ? n0 + r : 0) * ld + c, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk)
      ldmatrix_x4(frag[kk], &Rs[warp * 16 + (lane % 16)][kk * 16 + (lane / 16) * 8]);
    __syncthreads();
  };
  uint32_t qa[kSteps][4], da[kSteps][4];
  const bf16* gb = a.g + b * a.lg.batch + h * a.lg.head;
  stage_rows(a.q + b * a.lq.batch + h * a.lq.head, a.lq.row, qa);
  stage_rows(gb, a.lg.row, da);

  float lse_r[2];
  float di[2] = {0.f, 0.f};
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = n0 + warp * 16 + g + 8 * hh;
    lse_r[hh] = INFINITY;  // padding rows: P = 0
    if (r < N) lse_r[hh] = dead ? dead_lse(a) : a.lse[(static_cast<size_t>(b) * H + h) * N + r];
    if constexpr (!kSweep) {
      float s = 0.f;
      if (r < N) {
        const bf16* grow = gb + r * a.lg.row;
        const bf16* orow = a.out + b * a.lo.batch + h * a.lo.head + r * a.lo.row;
#pragma unroll
        for (int nd = 0; nd < DH / 8; ++nd) {
          const float2 x = load2(grow + nd * 8 + 2 * t), y = load2(orow + nd * 8 + 2 * t);
          s = fmaf(x.x, y.x, s);
          s = fmaf(x.y, y.y, s);
        }
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      di[hh] = s * row_mass(a, dead) - (a.g_lse != nullptr && r < N ? a.g_lse[(static_cast<size_t>(b) * H + h) * N + r] : 0.f);
    }
  }

  auto load_kv = [&](int stage, int k0) {
    for (int i = tid; i < kBk * kChunks; i += kBThreads) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      const bool ok = k0 + r < M;
      const long long row = ok ? k0 + r : 0;
      cp_async16(&Ks[stage][r][c], kb + row * ldk + c, ok);
      cp_async16(&Vs[stage][r][c], vb + row * ldv + c, ok);
    }
    if (tid < kBk) madd[stage][tid] = key_add(mask, b, M, k0 + tid, dead);
    cp_async_commit();
  };

  float dq[DH / 8][4] = {};
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
    for (int kk = 0; kk < kSteps; ++kk)
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
        for (int ndp = 0; ndp < kSteps; ++ndp) {
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
      for (int nd = 0; nd < DH / 8; ++nd) {
        const float x0 = dq[nd][2 * hh] * kScale, x1 = dq[nd][2 * hh + 1] * kScale;
        if (a.dq32 != nullptr) store2(a.dq32 + base + nd * 8 + 2 * t, x0, x1);
        store2(a.dq + base + nd * 8 + 2 * t, x0, x1);
      }
      if (t == 0) a.di[(static_cast<size_t>(b) * H + h) * N + r] = di[hh];
    }
  }
}

// ------------------------------------------------ pass B (bf16): dK, dV
template <int DH>
__global__ void __launch_bounds__(kBThreads) attn_bwd_dkdv_bf16(AttnBwdArgs<bf16> a) {
  constexpr int kChunks = DH / 8, kSteps = DH / 16;
  constexpr float kScale = Head<DH>::scale;
  __shared__ __align__(16) bf16 Rs[kBk][DH + kPadB];  // stages K, then V
  __shared__ __align__(16) bf16 Qs[2][kBq][DH + kPadB];
  __shared__ __align__(16) bf16 As[2][kBq][DH + kPadB];
  __shared__ float lse_s[2][kBq], di_s[2][kBq];
  const int b = blockIdx.z, h = blockIdx.y, H = gridDim.y, m0 = blockIdx.x * kBk;
  const int N = a.N, M = a.M;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const bool dead = a.dead != nullptr && a.dead[b] != 0;
  const float lscale = dead ? 0.f : kScale, lse_dead = dead_lse(a);
  const float ds_keep = dead && a.zero_dead_ds ? 0.f : 1.f;
  const bf16* __restrict__ qb = a.q + b * a.lq.batch + h * a.lq.head;
  const bf16* __restrict__ ab = a.g + b * a.lg.batch + h * a.lg.head;
  const float* __restrict__ lse = a.lse;
  const float* __restrict__ di = a.di;
  const long long ldq = a.lq.row, lda = a.lg.row;
  const size_t stat = (static_cast<size_t>(b) * H + h) * N;

  auto stage_rows = [&](const bf16* src, long long ld, uint32_t (&frag)[kSteps][4]) {
    for (int i = tid; i < kBk * kChunks; i += kBThreads) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      const bool ok = m0 + r < M;
      cp_async16(&Rs[r][c], src + (ok ? m0 + r : 0) * ld + c, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk)
      ldmatrix_x4(frag[kk], &Rs[warp * 16 + (lane % 16)][kk * 16 + (lane / 16) * 8]);
    __syncthreads();
  };
  uint32_t ka[kSteps][4], va[kSteps][4];
  stage_rows(a.k + b * a.lk.batch + h * a.lk.head, a.lk.row, ka);
  stage_rows(a.v + b * a.lv.batch + h * a.lv.head, a.lv.row, va);
  float madd_r[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) madd_r[hh] = key_add(a.mask, b, M, m0 + warp * 16 + g + 8 * hh, dead);

  auto load_q = [&](int stage, int q0) {
    for (int i = tid; i < kBq * kChunks; i += kBThreads) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      const bool ok = q0 + r < N;
      const long long row = ok ? q0 + r : 0;
      cp_async16(&Qs[stage][r][c], qb + row * ldq + c, ok);
      cp_async16(&As[stage][r][c], ab + row * lda + c, ok);
    }
    if (tid < kBq) {
      const bool ok = q0 + tid < N;
      lse_s[stage][tid] = ok ? (dead ? lse_dead : lse[stat + q0 + tid]) : INFINITY;  // padding: P = 0
      di_s[stage][tid] = ok ? di[stat + q0 + tid] : 0.f;
    }
    cp_async_commit();
  };

  float dk[DH / 8][4] = {}, dv[DH / 8][4] = {};
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
    for (int kk = 0; kk < kSteps; ++kk)
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
      for (int ndp = 0; ndp < kSteps; ++ndp) {
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
      for (int nd = 0; nd < DH / 8; ++nd) {
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

// ------------------------------------------------ pass A (f32): dQ, 3xTF32
// Four warps of 16 query rows; every product in 3xTF32 on the tensor cores
// (tf32_tiles.cuh). Each warp keeps its rows of q and g in registers as raw
// f32. K and V tiles of kFbk keys come through a two-stage cp.async ring of
// raw rows and are split once per tile into three fragment sets: K in kd
// order (S = q K^T), V in kd order (dP = g V^T) and K in kr order (dQ += dS
// K, with dS taken straight from the accumulators). di comes from the
// forward's output (rowsum(g o out) times the row's mass of P, less g_lse).
constexpr int kFbq = 64, kFbk = 32, kFbThreads = 128, kFbStages = 2;

template <int DH>
struct F32BwdA {  // dynamic shared memory of pass A
  static constexpr int raw = kFbk * raw_ld<DH>();  // one raw K or V tile, floats
  static constexpr int frag = kFbk * DH / 2;        // float4 slots of one split tile
  static constexpr size_t bytes = (kFbStages * (2 * raw + kFbk) + kFbk) * sizeof(float) + 3 * frag * sizeof(float4);
};

template <int DH>
__global__ void __launch_bounds__(kFbThreads, x_min_blocks<DH>()) attn_bwd_dq_f32(AttnBwdArgs<float> a) {
  using S = F32BwdA<DH>;
  constexpr int per = DH / 8, ntiles = kFbk / 8;
  constexpr float kScale = Head<DH>::scale;
  extern __shared__ __align__(16) float smem[];
  float* raw = smem;                               // [stage][K, V][kFbk][raw_ld]
  float* madd_raw = raw + kFbStages * 2 * S::raw;  // [stage][kFbk]
  float* madd = madd_raw + kFbStages * kFbk;       // [kFbk], the current tile's
  float4* kd = reinterpret_cast<float4*>(madd + kFbk);
  float4* vd = kd + S::frag;
  float4* kr = vd + S::frag;
  const int b = blockIdx.z, h = blockIdx.y, H = gridDim.y, r0 = blockIdx.x * kFbq + (threadIdx.x / 32) * 16;
  const int N = a.N, M = a.M;
  const int tid = threadIdx.x, lane = tid % 32, g = lane / 4, t = lane % 4;
  const bool dead = a.dead != nullptr && a.dead[b] != 0;
  const float lscale = dead ? 0.f : kScale, ds_keep = dead && a.zero_dead_ds ? 0.f : 1.f;
  const float* __restrict__ kb = a.k + b * a.lk.batch + h * a.lk.head;
  const float* __restrict__ vb = a.v + b * a.lv.batch + h * a.lv.head;
  const size_t stat = (static_cast<size_t>(b) * H + h) * N;
  const int ktiles = (M + kFbk - 1) / kFbk;

  auto issue = [&](int it) {  // one commit group per tile, empty past the last
    if (it < ktiles) {
      const int st = it % kFbStages, k0 = it * kFbk;
      stage_raw<kFbk, DH, kFbThreads>(raw + (2 * st) * S::raw, kb, a.lk.row, k0, M, tid);
      stage_raw<kFbk, DH, kFbThreads>(raw + (2 * st + 1) * S::raw, vb, a.lv.row, k0, M, tid);
      if (tid < kFbk) madd_raw[st * kFbk + tid] = key_add(a.mask, b, M, k0 + tid, dead);
    }
    cp_async_commit();
  };
  for (int it = 0; it < kFbStages - 1; ++it) issue(it);

  float qx[per][4], gx[per][4];
  load_a_rows<DH>(qx, a.q + b * a.lq.batch + h * a.lq.head, a.lq.row, r0, N, lane);
  load_a_rows<DH>(gx, a.g + b * a.lg.batch + h * a.lg.head, a.lg.row, r0, N, lane);
  float lse_r[2], di[2] = {0.f, 0.f};
  {
    float ox[per][4];
    load_a_rows<DH>(ox, a.out + b * a.lo.batch + h * a.lo.head, a.lo.row, r0, N, lane);
#pragma unroll
    for (int kk = 0; kk < per; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) di[e & 1] = fmaf(gx[kk][e], ox[kk][e], di[e & 1]);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {  // the quad's column sums, less the LSE's cotangent
    di[hh] += __shfl_xor_sync(0xffffffffu, di[hh], 1);
    di[hh] += __shfl_xor_sync(0xffffffffu, di[hh], 2);
    di[hh] *= row_mass(a, dead);
    const int r = r0 + g + 8 * hh;
    if (a.g_lse != nullptr && r < N) di[hh] -= a.g_lse[stat + r];
    lse_r[hh] = INFINITY;  // padding rows: P = 0
    if (r < N) lse_r[hh] = dead ? dead_lse(a) : a.lse[stat + r];
  }

  float dq[per][4] = {};
  for (int it = 0; it < ktiles; ++it) {
    cp_async_wait<kFbStages - 2>();
    __syncthreads();
    issue(it + kFbStages - 1);
    const int st = it % kFbStages;
    const float* ks = raw + (2 * st) * S::raw;
    split_tile<kFbk, DH, kFbThreads, false>(kd, ks, tid);
    split_tile<kFbk, DH, kFbThreads, false>(vd, raw + (2 * st + 1) * S::raw, tid);
    split_tile<kFbk, DH, kFbThreads, true>(kr, ks, tid);
    if (tid < kFbk) madd[tid] = madd_raw[st * kFbk + tid];
    __syncthreads();

    float s[ntiles][4], dp[ntiles][4];
    head_product<ntiles, per>(s, qx, kd, lane);
    head_product<ntiles, per>(dp, gx, vd, lane);
#pragma unroll
    for (int nt = 0; nt < ntiles; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(s[nt][e] * lscale + madd[nt * 8 + 2 * t + (e & 1)] - lse_r[e >> 1]);
        s[nt][e] = ds_keep * p * (dp[nt][e] - di[e >> 1]);
      }
    tile_product<ntiles, per>(dq, s, kr, lane);
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + g + 8 * hh;
    if (r < N) {
      const long long base = b * a.ldq.batch + h * a.ldq.head + r * a.ldq.row;
#pragma unroll
      for (int nd = 0; nd < per; ++nd) {
        const float x0 = dq[nd][2 * hh] * kScale, x1 = dq[nd][2 * hh + 1] * kScale;
        if (a.dq32 != nullptr) store2(a.dq32 + base + nd * 8 + 2 * t, x0, x1);
        store2(a.dq + base + nd * 8 + 2 * t, x0, x1);
      }
      if (t == 0) a.di[stat + r] = di[hh];
    }
  }
}

// ------------------------------------------------ pass B (f32): dK, dV, 3xTF32
// Four warps of 16 key rows, the transposed products formed directly (keys
// are the M dimension): S^T = K q^T, dP^T = V g^T, dV += P^T g, dK += dS^T q.
// Each warp keeps its rows of K and V in registers; query tiles of kFbqt rows
// of q and g come through the cp.async ring with their LSE and di, and are
// split once per tile into q and g in kd order (the first two products) and
// in kr order (the last two, P^T and dS^T straight from the accumulators).
constexpr int kFbkey = 64, kFbqt = 32;

template <int DH>
struct F32BwdB {  // dynamic shared memory of pass B
  static constexpr int raw = kFbqt * raw_ld<DH>();
  static constexpr int frag = kFbqt * DH / 2;
  static constexpr size_t bytes =
      (kFbStages * (2 * raw + 2 * kFbqt) + 2 * kFbqt) * sizeof(float) + 4 * frag * sizeof(float4);
};

template <int DH>
__global__ void __launch_bounds__(kFbThreads) attn_bwd_dkdv_f32(AttnBwdArgs<float> a) {
  using S = F32BwdB<DH>;
  constexpr int per = DH / 8, ntiles = kFbqt / 8;
  constexpr float kScale = Head<DH>::scale;
  extern __shared__ __align__(16) float smem[];
  float* raw = smem;                                  // [stage][q, g][kFbqt][raw_ld]
  float* stat_raw = raw + kFbStages * 2 * S::raw;     // [stage][lse, di][kFbqt]
  float* lse_s = stat_raw + kFbStages * 2 * kFbqt;    // [kFbqt], the current tile's
  float* di_s = lse_s + kFbqt;
  float4* qd = reinterpret_cast<float4*>(di_s + kFbqt);
  float4* gd = qd + S::frag;
  float4* qr = gd + S::frag;
  float4* gr = qr + S::frag;
  const int b = blockIdx.z, h = blockIdx.y, H = gridDim.y, r0 = blockIdx.x * kFbkey + (threadIdx.x / 32) * 16;
  const int N = a.N, M = a.M;
  const int tid = threadIdx.x, lane = tid % 32, g = lane / 4, t = lane % 4;
  const bool dead = a.dead != nullptr && a.dead[b] != 0;
  const float lscale = dead ? 0.f : kScale, lse_dead = dead_lse(a);
  const float ds_keep = dead && a.zero_dead_ds ? 0.f : 1.f;
  const float* __restrict__ qb = a.q + b * a.lq.batch + h * a.lq.head;
  const float* __restrict__ gb = a.g + b * a.lg.batch + h * a.lg.head;
  const size_t stat = (static_cast<size_t>(b) * H + h) * N;
  const int qtiles = (N + kFbqt - 1) / kFbqt;

  auto issue = [&](int qt) {
    if (qt < qtiles) {
      const int st = qt % kFbStages, q0 = qt * kFbqt;
      stage_raw<kFbqt, DH, kFbThreads>(raw + (2 * st) * S::raw, qb, a.lq.row, q0, N, tid);
      stage_raw<kFbqt, DH, kFbThreads>(raw + (2 * st + 1) * S::raw, gb, a.lg.row, q0, N, tid);
      if (tid < kFbqt) {
        const bool ok = q0 + tid < N;
        stat_raw[(2 * st) * kFbqt + tid] = ok ? (dead ? lse_dead : a.lse[stat + q0 + tid]) : INFINITY;  // padding: P = 0
        stat_raw[(2 * st + 1) * kFbqt + tid] = ok ? a.di[stat + q0 + tid] : 0.f;
      }
    }
    cp_async_commit();
  };
  for (int qt = 0; qt < kFbStages - 1; ++qt) issue(qt);

  float kx[per][4], vx[per][4];
  load_a_rows<DH>(kx, a.k + b * a.lk.batch + h * a.lk.head, a.lk.row, r0, M, lane);
  load_a_rows<DH>(vx, a.v + b * a.lv.batch + h * a.lv.head, a.lv.row, r0, M, lane);
  float madd_r[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) madd_r[hh] = key_add(a.mask, b, M, r0 + g + 8 * hh, dead);

  float dk[per][4] = {}, dv[per][4] = {};
  for (int qt = 0; qt < qtiles; ++qt) {
    cp_async_wait<kFbStages - 2>();
    __syncthreads();
    issue(qt + kFbStages - 1);
    const int st = qt % kFbStages;
    const float* qs = raw + (2 * st) * S::raw;
    const float* gs = raw + (2 * st + 1) * S::raw;
    split_tile<kFbqt, DH, kFbThreads, false>(qd, qs, tid);
    split_tile<kFbqt, DH, kFbThreads, false>(gd, gs, tid);
    split_tile<kFbqt, DH, kFbThreads, true>(qr, qs, tid);
    split_tile<kFbqt, DH, kFbThreads, true>(gr, gs, tid);
    if (tid < kFbqt) {
      lse_s[tid] = stat_raw[(2 * st) * kFbqt + tid];
      di_s[tid] = stat_raw[(2 * st + 1) * kFbqt + tid];
    }
    __syncthreads();

    // transposed scores: rows are this warp's 16 keys, columns the tile's queries
    float s[ntiles][4], dp[ntiles][4];
    head_product<ntiles, per>(s, kx, qd, lane);
    head_product<ntiles, per>(dp, vx, gd, lane);
#pragma unroll
    for (int nt = 0; nt < ntiles; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + 2 * t + (e & 1);
        const float p = __expf(s[nt][e] * lscale + madd_r[e >> 1] - lse_s[c]);
        dp[nt][e] = ds_keep * p * (dp[nt][e] - di_s[c]);
        s[nt][e] = p;
      }
    tile_product<ntiles, per, 4>(dv, s, gr, lane);  // quarters: dK and dV both live here
    tile_product<ntiles, per, 4>(dk, dp, qr, lane);
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + g + 8 * hh;
    if (r < M) {
      const long long at = b * a.ldkv.batch + h * a.ldkv.head + r * a.ldkv.row;
      const long long at32 = b * a.ldkv32.batch + h * a.ldkv32.head + r * a.ldkv32.row;
#pragma unroll
      for (int nd = 0; nd < per; ++nd) {
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

// pass A, then pass B, on one stream, for heads of width dh (32 or 64)
template <typename T, bool kSweep = false>
cudaError_t attention_backward_passes(const AttnBwdArgs<T>& a, int B, int H, int dh, cudaStream_t s) {
  return with_head_width(dh, [&](auto width) -> cudaError_t {
    constexpr int DH = decltype(width)::value;
    cudaError_t err;
    if constexpr (sizeof(T) == 2) {
      attn_bwd_dq_bf16<DH, kSweep><<<dim3((a.N + kBq - 1) / kBq, H, B), kBThreads, 0, s>>>(a);
      if ((err = cudaGetLastError())) return err;
      attn_bwd_dkdv_bf16<DH><<<dim3((a.M + kBk - 1) / kBk, H, B), kBThreads, 0, s>>>(a);
    } else {
      const size_t smem_a = F32BwdA<DH>::bytes, smem_b = F32BwdB<DH>::bytes;
      if ((err = cudaFuncSetAttribute(attn_bwd_dq_f32<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      static_cast<int>(smem_a)))) return err;
      if ((err = cudaFuncSetAttribute(attn_bwd_dkdv_f32<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      static_cast<int>(smem_b)))) return err;
      attn_bwd_dq_f32<DH><<<dim3((a.N + kFbq - 1) / kFbq, H, B), kFbThreads, smem_a, s>>>(a);
      if ((err = cudaGetLastError())) return err;
      attn_bwd_dkdv_f32<DH><<<dim3((a.M + kFbkey - 1) / kFbkey, H, B), kFbThreads, smem_b, s>>>(a);
    }
    return cudaGetLastError();
  });
}

}  // namespace
