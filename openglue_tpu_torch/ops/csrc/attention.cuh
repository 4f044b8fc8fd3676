// Flash-style masked softmax attention forward, shared by the layer, message
// and standalone attention kernels, for heads of width dh = 32 or 64 (a
// template parameter). q and out are [B, H, N, dh] views, k and v
// [B, H, M, dh] views, each given by its HeadLayout (for the layer kernels:
// q [B, N, ldq], k/v [B, M, ldkv] with head h in columns [h*dh, h*dh+dh), k
// and v column blocks of one buffer, out [B, N, D]); mask [B, M] (1 valid, 0
// masked) or null; out in the compute type (the bf16 kernel can also write
// f32); lse [B, H, N] f32 (max + log(sum exp)) or null. The row max and sum
// run online in f32; the division comes after P.V.

#pragma once

#include "tf32_tiles.cuh"

namespace {

constexpr int kAq = 64, kAk = 64, kAttnThreads = 128;

// bf16: 4 warps, 16 query rows each; S, P and O stay in mma registers; K/V
// tiles double-buffered with cp.async
template <int DH, typename O>
__global__ void __launch_bounds__(kAttnThreads)
attention_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
               O* __restrict__ out, float* __restrict__ lse, int N, int M, HeadLayout lq,
               HeadLayout lk, HeadLayout lv, HeadLayout lo) {
  constexpr int kPad = 8;
  constexpr int kChunks = DH / 8, kSteps = DH / 16;  // 16-byte chunks per row; k-steps over dh
  __shared__ __align__(16) bf16 Qs[kAq][DH + kPad];
  __shared__ __align__(16) bf16 Ks[2][kAk][DH + kPad];
  __shared__ __align__(16) bf16 Vs[2][kAk][DH + kPad];
  __shared__ float madd[2][kAk];
  const int b = blockIdx.z, h = blockIdx.y, n0 = blockIdx.x * kAq;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const bf16* qb = q + b * lq.batch + h * lq.head;
  const bf16* kb = k + b * lk.batch + h * lk.head;
  const bf16* vb = v + b * lv.batch + h * lv.head;

  auto load_kv = [&](int stage, int k0) {
    for (int i = tid; i < kAk * kChunks; i += kAttnThreads) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      const bool ok = k0 + r < M;
      const long long row = ok ? k0 + r : 0;
      cp_async16(&Ks[stage][r][c], kb + row * lk.row + c, ok);
      cp_async16(&Vs[stage][r][c], vb + row * lv.row + c, ok);
    }
    if (tid < kAk) madd[stage][tid] = mask_add(mask, b, M, k0 + tid);
    cp_async_commit();
  };

  for (int i = tid; i < kAq * kChunks; i += kAttnThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool ok = n0 + r < N;
    cp_async16(&Qs[r][c], qb + (ok ? n0 + r : 0) * lq.row + c, ok);
  }
  load_kv(0, 0);  // commits Q's copies with the first tile's
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qa[kSteps][4];
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk)
    ldmatrix_x4(qa[kk], &Qs[warp * 16 + (lane % 16)][kk * 16 + (lane / 16) * 8]);

  float o[DH / 8][4] = {};
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
    for (int kk = 0; kk < kSteps; ++kk)
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
        s[nt][e] = s[nt][e] * Head<DH>::scale + madd[st][nt * 8 + 2 * t + (e & 1)];
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
    for (int nd = 0; nd < DH / 8; ++nd) {
      o[nd][0] *= alpha[0]; o[nd][1] *= alpha[0];
      o[nd][2] *= alpha[1]; o[nd][3] *= alpha[1];
    }
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t pa[4];
      pack_a(pa, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
      for (int ndp = 0; ndp < kSteps; ++ndp) {
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
      for (int nd = 0; nd < DH / 8; ++nd)
        store2(ob + r * lo.row + nd * 8 + 2 * t, o[nd][2 * hh] / row_sum[hh],
               o[nd][2 * hh + 1] / row_sum[hh]);
      if (lse != nullptr && t == 0)
        lse[(static_cast<size_t>(b) * gridDim.y + h) * N + r] = row_max[hh] + logf(row_sum[hh]);
    }
  }
}

constexpr int kXq = 64, kXk = 32, kXThreads = 128, kXStages = 2;

// The f32 kernel's dynamic shared memory, in floats: a kXStages ring of raw K
// and V tiles with their additive masks, then the current tile's K (kd order)
// and V (kr order) fragments and its mask
template <int DH>
struct F32Attn {
  static constexpr int raw = kXk * raw_ld<DH>();  // one raw K or V tile
  static constexpr int frag = kXk * DH / 2;        // float4 slots of one split tile
  static constexpr size_t bytes = (kXStages * (2 * raw + kXk) + kXk) * sizeof(float) + 2 * frag * sizeof(float4);
};

// f32: four warps of 16 query rows, every product in 3xTF32 on the tensor
// cores (tf32_tiles.cuh). K/V tiles of kXk keys arrive through a cp.async ring
// of raw rows; one split pass per tile writes their hi/lo fragments, which
// all four warps read; each warp's Q rows stay in registers for the whole key
// sweep. S and P stay in registers: V's kr order makes S's accumulator tile
// P's A operand. Each tile's P V starts from zero and is added to the running
// output in f32. The mask is added to the f32 logits after the product.
template <int DH>
__global__ void __launch_bounds__(kXThreads, x_min_blocks<DH>())
attention_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
              const uint8_t* __restrict__ mask, float* __restrict__ out, float* __restrict__ lse, int N, int M,
              HeadLayout lq, HeadLayout lk, HeadLayout lv, HeadLayout lo) {
  using S = F32Attn<DH>;
  constexpr int per = DH / 8, ntiles = kXk / 8;
  extern __shared__ __align__(16) float smem[];
  float* raw = smem;                                 // [stage][K, V][kXk][raw_ld]
  float* madd_raw = raw + kXStages * 2 * S::raw;     // [stage][kXk]
  float* madd = madd_raw + kXStages * kXk;           // [kXk], the current tile's
  float4* kd = reinterpret_cast<float4*>(madd + kXk);
  float4* vr = kd + S::frag;
  const int b = blockIdx.z, h = blockIdx.y, n0 = blockIdx.x * kXq;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const float* kb = k + b * lk.batch + h * lk.head;
  const float* vb = v + b * lv.batch + h * lv.head;
  const int ktiles = (M + kXk - 1) / kXk;

  auto issue = [&](int kt) {  // one commit group per tile, empty past the last
    if (kt < ktiles) {
      const int st = kt % kXStages, k0 = kt * kXk;
      stage_raw<kXk, DH, kXThreads>(raw + (2 * st) * S::raw, kb, lk.row, k0, M, tid);
      stage_raw<kXk, DH, kXThreads>(raw + (2 * st + 1) * S::raw, vb, lv.row, k0, M, tid);
      if (tid < kXk) madd_raw[st * kXk + tid] = mask_add(mask, b, M, k0 + tid);
    }
    cp_async_commit();
  };
  for (int kt = 0; kt < kXStages - 1; ++kt) issue(kt);

  float qx[per][4];
  load_a_rows<DH>(qx, q + b * lq.batch + h * lq.head, lq.row, n0 + warp * 16, N, lane);
  float o[per][4] = {};
  float row_max[2] = {-INFINITY, -INFINITY};
  float row_sum[2] = {0.f, 0.f};

  for (int kt = 0; kt < ktiles; ++kt) {
    // tile kt has landed; every warp is done with the previous tile's fragments
    cp_async_wait<kXStages - 2>();
    __syncthreads();
    issue(kt + kXStages - 1);  // into the stage whose split ended before the last barrier
    const int st = kt % kXStages;
    split_tile<kXk, DH, kXThreads, false>(kd, raw + (2 * st) * S::raw, tid);
    split_tile<kXk, DH, kXThreads, true>(vr, raw + (2 * st + 1) * S::raw, tid);
    if (tid < kXk) madd[tid] = madd_raw[st * kXk + tid];
    __syncthreads();

    float s[ntiles][4];
    head_product<ntiles, per>(s, qx, kd, lane);

    float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < ntiles; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = s[nt][e] * Head<DH>::scale + madd[nt * 8 + 2 * t + (e & 1)];
        tile_max[e >> 1] = fmaxf(tile_max[e >> 1], s[nt][e]);
      }
    float alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = tile_max[hh];
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(row_max[hh], mx);
      alpha[hh] = __expf(row_max[hh] - m_new);
      row_max[hh] = m_new;
      row_sum[hh] *= alpha[hh];
    }
#pragma unroll
    for (int nt = 0; nt < ntiles; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = __expf(s[nt][e] - row_max[e >> 1]);
        s[nt][e] = pe;
        row_sum[e >> 1] += pe;
      }
#pragma unroll
    for (int nd = 0; nd < per; ++nd) {
      o[nd][0] *= alpha[0]; o[nd][1] *= alpha[0];
      o[nd][2] *= alpha[1]; o[nd][3] *= alpha[1];
    }
    tile_product<ntiles, per>(o, s, vr, lane);
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    row_sum[hh] += __shfl_xor_sync(0xffffffffu, row_sum[hh], 1);
    row_sum[hh] += __shfl_xor_sync(0xffffffffu, row_sum[hh], 2);
  }
  float* ob = out + b * lo.batch + h * lo.head;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = n0 + warp * 16 + g + 8 * hh;
    if (r < N) {
#pragma unroll
      for (int nd = 0; nd < per; ++nd)
        store2(ob + r * lo.row + nd * 8 + 2 * t, o[nd][2 * hh] / row_sum[hh], o[nd][2 * hh + 1] / row_sum[hh]);
      if (lse != nullptr && t == 0)
        lse[(static_cast<size_t>(b) * gridDim.y + h) * N + r] = row_max[hh] + logf(row_sum[hh]);
    }
  }
}

// operands by their layouts, heads of width dh (32 or 64)
template <typename T, typename O = T>
cudaError_t attention_views(const T* q, const T* k, const T* v, const uint8_t* mask, O* out,
                            float* lse, int B, int N, int M, int H, int dh, HeadLayout lq, HeadLayout lk,
                            HeadLayout lv, HeadLayout lo, cudaStream_t stream) {
  return with_head_width(dh, [&](auto width) -> cudaError_t {
    constexpr int DH = decltype(width)::value;
    if constexpr (sizeof(T) == 2) {
      const dim3 grid((N + kAq - 1) / kAq, H, B);
      attention_bf16<DH, O><<<grid, kAttnThreads, 0, stream>>>(q, k, v, mask, out, lse, N, M, lq, lk, lv, lo);
    } else {
      const size_t smem = F32Attn<DH>::bytes;
      const cudaError_t err = cudaFuncSetAttribute(attention_f32<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   static_cast<int>(smem));
      if (err != cudaSuccess) return err;
      const dim3 grid((N + kXq - 1) / kXq, H, B);
      attention_f32<DH><<<grid, kXThreads, smem, stream>>>(q, k, v, mask, out, lse, N, M, lq, lk, lv, lo);
    }
    return cudaGetLastError();
  });
}

// q [B, N, ldq], k/v [B, M, ldkv], out [B, N, D], head h in columns h*dh..
template <typename T, typename O = T>
cudaError_t attention(const T* q, const T* k, const T* v, const uint8_t* mask, O* out, float* lse,
                      int B, int N, int M, int D, int H, int ldq, int ldkv, cudaStream_t stream) {
  const int dh = D / H;
  const HeadLayout lkv = column_heads(M, ldkv, dh);
  return attention_views<T, O>(q, k, v, mask, out, lse, B, N, M, H, dh, column_heads(N, ldq, dh), lkv, lkv,
                               column_heads(N, D, dh), stream);
}

}  // namespace
