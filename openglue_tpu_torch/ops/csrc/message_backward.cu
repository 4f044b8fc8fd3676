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
// the tensor cores bound it (about 50 us at 989 TFLOP/s bf16). Per element it
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
// * attention backward in two passes. Pass A takes one 64-query block per
//   CTA (and head): a first sweep over the key tiles sums rowsum(dP o P), a
//   second recomputes P and dP, forms dS and accumulates dQ in registers.
//   Pass B takes one 64-key block per CTA: it sweeps the query tiles with the
//   saved LSE and pass A's row sums and accumulates dK and dV in registers.
//   S and dP are recomputed in each pass (9 N x M x dh products per head
//   against the TPU kernel's 5); that keeps every sum inside one CTA;
// * dx_q = dQ Wq and dx_kv = [dK | dV] [Wk; Wv], the stacked weight read
//   from its two parts;
// * the weight gradients are one batched split-K GEMM (X^T Y over the B*N or
//   B*M rows) into per-split f32 partials, summed in a fixed order by a second
//   kernel; the bias gradients are column sums done the same way.
// bf16 uses mma.sync with cp.async double buffering. f32 uses FMA: two
// threads per query (pass A) or key (pass B) row, each owning half of the
// head dims, with the accumulators in registers.

#include "gemm.cuh"

namespace {

constexpr int kBq = 64, kBk = 64, kBThreads = 128, kPadB = 8;

// ------------------------------------------------ pass A (bf16): rowsum, dQ
// q [B, N, ldq], dA [B, N, lda] (head h at column h*64), k/v [B, M, ldkv];
// lse, di [B, H, N]; dq32 f32 and dqc bf16 [B, N, D]
__global__ void __launch_bounds__(kBThreads)
attn_bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ dA,
                 const bf16* __restrict__ k, const bf16* __restrict__ v,
                 const uint8_t* __restrict__ mask, const float* __restrict__ lse,
                 float* __restrict__ di_out, float* __restrict__ dq32, bf16* __restrict__ dqc,
                 int N, int M, int D, int ldq, int lda, int ldkv) {
  __shared__ __align__(16) bf16 Rs[kBq][kDh + kPadB];  // stages Q, then dA
  __shared__ __align__(16) bf16 Ks[2][kBk][kDh + kPadB];
  __shared__ __align__(16) bf16 Vs[2][kBk][kDh + kPadB];
  __shared__ float madd[2][kBk];
  const int b = blockIdx.z, h = blockIdx.y, H = gridDim.y, n0 = blockIdx.x * kBq;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const bf16* kb = k + static_cast<size_t>(b) * M * ldkv + h * kDh;
  const bf16* vb = v + static_cast<size_t>(b) * M * ldkv + h * kDh;

  auto stage_rows = [&](const bf16* src, int ld, uint32_t (&frag)[4][4]) {
    for (int i = tid; i < kBq * kDh / 8; i += kBThreads) {
      const int r = i / 8, c = (i % 8) * 8;
      const bool ok = n0 + r < N;
      cp_async16(&Rs[r][c], src + static_cast<size_t>(ok ? n0 + r : 0) * ld + c, ok);
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
  stage_rows(q + static_cast<size_t>(b) * N * ldq + h * kDh, ldq, qa);
  stage_rows(dA + static_cast<size_t>(b) * N * lda + h * kDh, lda, da);

  float lse_r[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = n0 + warp * 16 + g + 8 * hh;
    lse_r[hh] = r < N ? lse[(static_cast<size_t>(b) * H + h) * N + r] : INFINITY;
  }

  auto load_kv = [&](int stage, int k0) {
    for (int i = tid; i < kBk * kDh / 8; i += kBThreads) {
      const int r = i / 8, c = (i % 8) * 8;
      const bool ok = k0 + r < M;
      const size_t row = static_cast<size_t>(ok ? k0 + r : 0) * ldkv + c;
      cp_async16(&Ks[stage][r][c], kb + row, ok);
      cp_async16(&Vs[stage][r][c], vb + row, ok);
    }
    if (tid < kBk) madd[stage][tid] = mask_add(mask, b, M, k0 + tid);
    cp_async_commit();
  };

  float di[2] = {0.f, 0.f};
  float dq[8][4] = {};
  const int ktiles = (M + kBk - 1) / kBk, total = 2 * ktiles;
  load_kv(0, 0);
  for (int it = 0; it < total; ++it) {
    const int st = it & 1;
    const bool second = it >= ktiles;  // the sweep that forms dS and dQ
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
        const float p = expf(s[nt][e] * kScale + madd[st][nt * 8 + 2 * t + (e & 1)] - lse_r[e >> 1]);
        if (second) s[nt][e] = p * (dp[nt][e] - di[e >> 1]);
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
    if (it == ktiles - 1) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        di[hh] += __shfl_xor_sync(0xffffffffu, di[hh], 1);
        di[hh] += __shfl_xor_sync(0xffffffffu, di[hh], 2);
      }
    }
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = n0 + warp * 16 + g + 8 * hh;
    if (r < N) {
      const size_t base = (static_cast<size_t>(b) * N + r) * D + h * kDh;
#pragma unroll
      for (int nd = 0; nd < 8; ++nd) {
        const float x0 = dq[nd][2 * hh] * kScale, x1 = dq[nd][2 * hh + 1] * kScale;
        store2(dq32 + base + nd * 8 + 2 * t, x0, x1);
        store2(dqc + base + nd * 8 + 2 * t, x0, x1);
      }
      if (t == 0) di_out[(static_cast<size_t>(b) * H + h) * N + r] = di[hh];
    }
  }
}

// ------------------------------------------------ pass B (bf16): dK, dV
// dk32, dv32 f32 [B, M, D]; dkvc bf16 [B, M, 2D] (dK in columns [0, D), dV
// in [D, 2D))
__global__ void __launch_bounds__(kBThreads)
attn_bwd_dkdv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ dA,
                   const bf16* __restrict__ k, const bf16* __restrict__ v,
                   const uint8_t* __restrict__ mask, const float* __restrict__ lse,
                   const float* __restrict__ di, float* __restrict__ dk32,
                   float* __restrict__ dv32, bf16* __restrict__ dkvc, int N, int M, int D,
                   int ldq, int lda, int ldkv) {
  __shared__ __align__(16) bf16 Rs[kBk][kDh + kPadB];  // stages K, then V
  __shared__ __align__(16) bf16 Qs[2][kBq][kDh + kPadB];
  __shared__ __align__(16) bf16 As[2][kBq][kDh + kPadB];
  __shared__ float lse_s[2][kBq], di_s[2][kBq];
  const int b = blockIdx.z, h = blockIdx.y, H = gridDim.y, m0 = blockIdx.x * kBk;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const bf16* qb = q + static_cast<size_t>(b) * N * ldq + h * kDh;
  const bf16* ab = dA + static_cast<size_t>(b) * N * lda + h * kDh;
  const size_t stat = (static_cast<size_t>(b) * H + h) * N;

  auto stage_rows = [&](const bf16* src, uint32_t (&frag)[4][4]) {
    for (int i = tid; i < kBk * kDh / 8; i += kBThreads) {
      const int r = i / 8, c = (i % 8) * 8;
      const bool ok = m0 + r < M;
      cp_async16(&Rs[r][c], src + static_cast<size_t>(ok ? m0 + r : 0) * ldkv + c, ok);
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
  stage_rows(k + static_cast<size_t>(b) * M * ldkv + h * kDh, ka);
  stage_rows(v + static_cast<size_t>(b) * M * ldkv + h * kDh, va);
  float madd_r[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) madd_r[hh] = mask_add(mask, b, M, m0 + warp * 16 + g + 8 * hh);

  auto load_q = [&](int stage, int q0) {
    for (int i = tid; i < kBq * kDh / 8; i += kBThreads) {
      const int r = i / 8, c = (i % 8) * 8;
      const bool ok = q0 + r < N;
      const size_t row = static_cast<size_t>(ok ? q0 + r : 0);
      cp_async16(&Qs[stage][r][c], qb + row * ldq + c, ok);
      cp_async16(&As[stage][r][c], ab + row * lda + c, ok);
    }
    if (tid < kBq) {
      const bool ok = q0 + tid < N;
      lse_s[stage][tid] = ok ? lse[stat + q0 + tid] : INFINITY;  // padding: P = 0
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
        const float p = expf(s[nt][e] * kScale + madd_r[e >> 1] - lse_s[st][c]);
        dp[nt][e] = p * (dp[nt][e] - di_s[st][c]);
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
      const size_t row = static_cast<size_t>(b) * M + r;
#pragma unroll
      for (int nd = 0; nd < 8; ++nd) {
        const int c = h * kDh + nd * 8 + 2 * t;
        const float k0 = dk[nd][2 * hh] * kScale, k1 = dk[nd][2 * hh + 1] * kScale;
        store2(dk32 + row * D + c, k0, k1);
        store2(dv32 + row * D + c, dv[nd][2 * hh], dv[nd][2 * hh + 1]);
        store2(dkvc + row * 2 * D + c, k0, k1);
        store2(dkvc + row * 2 * D + D + c, dv[nd][2 * hh], dv[nd][2 * hh + 1]);
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
__device__ __forceinline__ void load_tile(float (*dst)[kRow], const float* src, size_t ld, int r0,
                                          int limit, int tid) {
  for (int i = tid; i < ROWS * kDh / 4; i += kFbThreads) {
    const int r = i / (kDh / 4), c = (i % (kDh / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < limit) x = *reinterpret_cast<const float4*>(src + static_cast<size_t>(r0 + r) * ld + c);
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

__global__ void __launch_bounds__(kFbThreads)
attn_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ dA,
                const float* __restrict__ k, const float* __restrict__ v,
                const uint8_t* __restrict__ mask, const float* __restrict__ lse,
                float* __restrict__ di_out, float* __restrict__ dq32, float* __restrict__ dqc,
                int N, int M, int D, int ldq, int lda, int ldkv) {
  __shared__ __align__(16) float Ks[kFbk][kRow];
  __shared__ __align__(16) float Vs[kFbk][kRow];
  __shared__ float madd[kFbk];
  const int b = blockIdx.z, h = blockIdx.y, H = gridDim.y, tid = threadIdx.x, half = tid & 1;
  const int row = blockIdx.x * kFbq + tid / 2, col = half * (kHalf + 4);
  const float* kb = k + static_cast<size_t>(b) * M * ldkv + h * kDh;
  const float* vb = v + static_cast<size_t>(b) * M * ldkv + h * kDh;
  const size_t src = static_cast<size_t>(b) * N + (row < N ? row : 0);
  float qr[kHalf], da[kHalf], dq[kHalf];
#pragma unroll
  for (int e = 0; e < kHalf; ++e) {
    qr[e] = q[src * ldq + h * kDh + half * kHalf + e];
    da[e] = dA[src * lda + h * kDh + half * kHalf + e];
    dq[e] = 0.f;
  }
  const float lse_r = row < N ? lse[(static_cast<size_t>(b) * H + h) * N + row] : INFINITY;
  float di = 0.f;

  for (int pass = 0; pass < 2; ++pass) {
    for (int k0 = 0; k0 < M; k0 += kFbk) {
      __syncthreads();
      load_tile<kFbk>(Ks, kb, ldkv, k0, M, tid);
      load_tile<kFbk>(Vs, vb, ldkv, k0, M, tid);
      if (tid < kFbk) madd[tid] = mask_add(mask, b, M, k0 + tid);
      __syncthreads();
#pragma unroll 1
      for (int j = 0; j < kFbk; ++j) {
        float s = half_dot(&Ks[j][col], qr), dp = half_dot(&Vs[j][col], da);
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        dp += __shfl_xor_sync(0xffffffffu, dp, 1);
        const float p = expf(s * kScale + madd[j] - lse_r);
        if (pass == 0) di = fmaf(p, dp, di);
        else half_axpy(dq, p * (dp - di), &Ks[j][col]);
      }
    }
  }
  if (row < N) {
    const size_t base = (static_cast<size_t>(b) * N + row) * D + h * kDh + half * kHalf;
#pragma unroll
    for (int e = 0; e < kHalf; ++e) {
      const float x = dq[e] * kScale;
      dq32[base + e] = x;
      dqc[base + e] = x;
    }
    if (half == 0) di_out[(static_cast<size_t>(b) * H + h) * N + row] = di;
  }
}

// ------------------------------------------------ pass B (f32): two threads per key row
// The same split of the head dims; dK and dV accumulate in registers.
constexpr int kFbkey = 64, kFbqt = 32;

__global__ void __launch_bounds__(kFbThreads)
attn_bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ dA,
                  const float* __restrict__ k, const float* __restrict__ v,
                  const uint8_t* __restrict__ mask, const float* __restrict__ lse,
                  const float* __restrict__ di, float* __restrict__ dk32,
                  float* __restrict__ dv32, float* __restrict__ dkvc, int N, int M, int D,
                  int ldq, int lda, int ldkv) {
  __shared__ __align__(16) float Qs[kFbqt][kRow];
  __shared__ __align__(16) float As[kFbqt][kRow];
  __shared__ float lse_s[kFbqt], di_s[kFbqt];
  const int b = blockIdx.z, h = blockIdx.y, H = gridDim.y, tid = threadIdx.x, half = tid & 1;
  const int key = blockIdx.x * kFbkey + tid / 2, col = half * (kHalf + 4);
  const size_t stat = (static_cast<size_t>(b) * H + h) * N;
  const size_t src = static_cast<size_t>(b) * M + (key < M ? key : 0);
  const float* qb = q + static_cast<size_t>(b) * N * ldq + h * kDh;
  const float* ab = dA + static_cast<size_t>(b) * N * lda + h * kDh;
  float kr[kHalf], vr[kHalf], dk[kHalf], dv[kHalf];
#pragma unroll
  for (int e = 0; e < kHalf; ++e) {
    kr[e] = k[src * ldkv + h * kDh + half * kHalf + e];
    vr[e] = v[src * ldkv + h * kDh + half * kHalf + e];
    dk[e] = dv[e] = 0.f;
  }
  const float madd_k = mask_add(mask, b, M, key);

  for (int q0 = 0; q0 < N; q0 += kFbqt) {
    __syncthreads();
    load_tile<kFbqt>(Qs, qb, ldq, q0, N, tid);
    load_tile<kFbqt>(As, ab, lda, q0, N, tid);
    if (tid < kFbqt) {
      const bool ok = q0 + tid < N;
      lse_s[tid] = ok ? lse[stat + q0 + tid] : INFINITY;  // padding: P = 0
      di_s[tid] = ok ? di[stat + q0 + tid] : 0.f;
    }
    __syncthreads();
#pragma unroll 1
    for (int i = 0; i < kFbqt; ++i) {
      float s = half_dot(&Qs[i][col], kr), dp = half_dot(&As[i][col], vr);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      dp += __shfl_xor_sync(0xffffffffu, dp, 1);
      const float p = expf(s * kScale + madd_k - lse_s[i]);
      half_axpy(dv, p, &As[i][col]);
      half_axpy(dk, p * (dp - di_s[i]), &Qs[i][col]);
    }
  }
  if (key < M) {
    const size_t row = static_cast<size_t>(b) * M + key;
#pragma unroll
    for (int e = 0; e < kHalf; ++e) {
      const int c = h * kDh + half * kHalf + e;
      const float dkx = dk[e] * kScale;
      dk32[row * D + c] = dkx;
      dv32[row * D + c] = dv[e];
      dkvc[row * 2 * D + c] = dkx;
      dkvc[row * 2 * D + D + c] = dv[e];
    }
  }
}

// ------------------------------------------------ weight gradients: C = X^T Y
// Up to four problems per launch; each is split over row chunks into f32
// partials [problem][split][P][Q] that reduce_partials sums in order.

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

__global__ void __launch_bounds__(128) tn_gemm_f32(TnArgs a) {
  __shared__ __align__(16) float Xs[kTk][kTn + 4];
  __shared__ __align__(16) float Ys[kTk][kTn + 4];
  const int prob = blockIdx.z / a.splits, split = blockIdx.z % a.splits;
  const TnProblem pr = a.p[prob];
  const float* X = static_cast<const float*>(pr.X);
  const float* Y = static_cast<const float*>(pr.Y);
  const int i0 = blockIdx.y * kTn, j0 = blockIdx.x * kTn;
  const int r_begin = split * a.chunk, r_end = min(pr.rows, r_begin + a.chunk);
  const int tid = threadIdx.x, ty = tid / 8, tx = tid % 8;
  float acc[4][8] = {};  // rows ty + 16i; columns 2tx + 16(j/2) + j%2

  for (int r0 = r_begin; r0 < r_end; r0 += kTk) {
    for (int i = tid; i < kTk * kTn / 4; i += 128) {
      const int r = i / (kTn / 4), c = (i % (kTn / 4)) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
      if (r0 + r < r_end) {
        x = *reinterpret_cast<const float4*>(X + static_cast<size_t>(r0 + r) * pr.ldx + i0 + c);
        y = *reinterpret_cast<const float4*>(Y + static_cast<size_t>(r0 + r) * pr.ldy + j0 + c);
      }
      *reinterpret_cast<float4*>(&Xs[r][c]) = x;
      *reinterpret_cast<float4*>(&Ys[r][c]) = y;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kTk; ++kk) {
      float xa[4], yb[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) xa[i] = Xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) yb[j] = Ys[kk][2 * tx + 16 * (j / 2) + j % 2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xa[i], yb[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = a.partial + static_cast<size_t>(blockIdx.z) * a.P * a.Q;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; j += 2)
      store2(out + static_cast<size_t>(i0 + ty + 16 * i) * a.Q + j0 + 2 * tx + 8 * j, acc[i][j], acc[i][j + 1]);
}

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

// ------------------------------------------------ host side
struct Plan {
  int tn_splits, tn_chunk, col_splits, col_chunk;
};

Plan plan(int B, int N, int M) {
  const int rows = B * (N > M ? N : M);
  Plan p;
  p.tn_splits = (rows + 1023) / 1024;
  if (p.tn_splits > 64) p.tn_splits = 64;
  p.tn_chunk = ((rows + p.tn_splits - 1) / p.tn_splits + kTk - 1) / kTk * kTk;
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
  b.tn_partial = ws.take<float>(static_cast<size_t>(4) * pl.tn_splits * D * D);
  b.col_partial = ws.take<float>(static_cast<size_t>(4) * pl.col_splits * D);
  return b;
}

template <typename T>
int message_backward(int B, int N, int M, int D, int H, const void* xq_, const void* xkv_,
                     const void* mask_, const void* g_, const void* attn_, const float* lse,
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
  const Plan pl = plan(B, N, M);
  Carve ws{static_cast<char*>(ws_)};
  const Buffers<T> bf = carve<T>(ws, B, N, M, D, H, pl);
  const int nq = B * N, nk = B * M;
  cudaError_t err;

  // recompute k, v and q; dattn = T(g Wo)
  if ((err = gemm<T, kBias>({xkv, D, wk, bk, nk, 2 * D, D, bf.kv, 2 * D, nullptr, 0, nullptr, nullptr, 0, wv, bv, D}, s))) return err;
  if ((err = gemm<T, kBias>({xq, D, wq, bq, nq, D, D, bf.q, D, nullptr, 0, nullptr, nullptr, 0}, s))) return err;
  if ((err = gemm<T, kBias, true>({g, D, wo, nullptr, nq, D, D, bf.dA, D, nullptr, 0, nullptr, nullptr, 0}, s))) return err;

  // attention backward: pass A (row sums, dQ), then pass B (dK, dV)
  const T* k = bf.kv;
  const T* v = bf.kv + D;
  if constexpr (sizeof(T) == 2) {
    attn_bwd_dq_bf16<<<dim3((N + kBq - 1) / kBq, H, B), kBThreads, 0, s>>>(
        bf.q, bf.dA, k, v, mask, lse, bf.di, bf.dq32, bf.dqc, N, M, D, D, D, 2 * D);
    if ((err = cudaGetLastError())) return err;
    attn_bwd_dkdv_bf16<<<dim3((M + kBk - 1) / kBk, H, B), kBThreads, 0, s>>>(
        bf.q, bf.dA, k, v, mask, lse, bf.di, bf.dk32, bf.dv32, bf.dkvc, N, M, D, D, D, 2 * D);
  } else {
    attn_bwd_dq_f32<<<dim3((N + kFbq - 1) / kFbq, H, B), kFbThreads, 0, s>>>(
        bf.q, bf.dA, k, v, mask, lse, bf.di, bf.dq32, bf.dqc, N, M, D, D, D, 2 * D);
    if ((err = cudaGetLastError())) return err;
    attn_bwd_dkdv_f32<<<dim3((M + kFbkey - 1) / kFbkey, H, B), kFbThreads, 0, s>>>(
        bf.q, bf.dA, k, v, mask, lse, bf.di, bf.dk32, bf.dv32, bf.dkvc, N, M, D, D, D, 2 * D);
  }
  if ((err = cudaGetLastError())) return err;

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
  tn.P = D; tn.Q = D; tn.chunk = pl.tn_chunk; tn.splits = pl.tn_splits; tn.partial = bf.tn_partial;
  const dim3 tgrid(D / kTn, D / kTn, 4 * pl.tn_splits);
  if constexpr (sizeof(T) == 2) tn_gemm_bf16<<<tgrid, 128, 0, s>>>(tn);
  else tn_gemm_f32<<<tgrid, 128, 0, s>>>(tn);
  if ((err = cudaGetLastError())) return err;
  Outputs4 dw = {{static_cast<float*>(o[2]), static_cast<float*>(o[3]), static_cast<float*>(o[4]),
                  static_cast<float*>(o[5])}};
  reduce_partials<<<dim3((D * D + 255) / 256, 4), 256, 0, s>>>(bf.tn_partial, pl.tn_splits, D * D, dw);
  if ((err = cudaGetLastError())) return err;

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
  const Plan pl = plan(B, N, M);
  if (is_bf16) carve<bf16>(ws, B, N, M, D, H, pl);
  else carve<float>(ws, B, N, M, D, H, pl);
  return ws.used;
}

// The backward of og_message_forward. is_bf16 selects the compute type T of
// x_q, x_kv, g (the cotangent of msg), attn and the weights; lse f32 [B, H, N].
// weights (T): wq, wk, wv, wo (torch layout [out, in], [D, D]); f32 biases
// bq, bk, bv [D].
// outputs: dx_q (T, [B, N, D]), dx_kv (T, [B, M, D]), then f32 dWq, dWk, dWv,
// dWo ([D, D], torch layout) and dbq, dbk, dbv, dbo ([D]). D = 64 * H.
// Returns the CUDA error code of the launches (0 on success).
extern "C" int og_message_backward(int is_bf16, int B, int N, int M, int D, int H,
                                   const void* xq, const void* xkv, const void* mask,
                                   const void* g, const void* attn, const void* lse,
                                   const void* const* weights, const void* const* biases,
                                   void* const* outputs, void* workspace, void* stream) {
  if (D != H * kDh || M <= 0 || N <= 0 || B <= 0) return cudaErrorInvalidValue;
  const float* const* f = reinterpret_cast<const float* const*>(biases);
  const float* l = static_cast<const float*>(lse);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return message_backward<bf16>(B, N, M, D, H, xq, xkv, mask, g, attn, l, weights, f, outputs, workspace, s);
  return message_backward<float>(B, N, M, D, H, xq, xkv, mask, g, attn, l, weights, f, outputs, workspace, s);
}
