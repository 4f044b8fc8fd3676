// Flash-style masked softmax attention forward, shared by the layer, message
// and standalone attention kernels, for heads of width dh = 32 or 64 (a
// template parameter). q and out are [B, H, N, dh] views, k and v
// [B, H, M, dh] views, each given by its HeadLayout (for the layer kernels:
// q [B, N, ldq], k/v [B, M, ldkv] with head h in columns [h*dh, h*dh+dh), k
// and v column blocks of one buffer, out [B, N, D]); mask [B, M] (1 valid, 0
// masked) or null; out in the compute type (the bf16 kernel can also write
// f32); lse [B, H, N] f32 (max + log(sum exp)) or null. The row max and sum
// run online in f32; the division comes after P.V. bf16: wgmma on TMA tiles
// in FlashAttention-3's shape (below); every view's base and strides are
// multiples of 16 bytes, as TMA needs. f32: 3xTF32 mma.sync (tf32_tiles.cuh).

#pragma once

#include "hopper.cuh"
#include "tf32_tiles.cuh"

namespace {

// ---------------------------------------------------------------- bf16
// wgmma on TMA tiles (hopper.cuh), in the shape of FlashAttention-3. A CTA
// is a producer warp and two consumer warpgroups of 64 query rows, persistent
// over tiles of 128 queries of one (batch element, head), the query blocks of
// one head next to each other (they share K and V in L2). The producer loads
// each tile's Q into one of two Q buffers, then keeps 128-key K and V tiles
// in a ring of kHStages stages guarded by mbarriers, with each key tile's
// additive mask (log2 units: 0, -1e9 log2(e), or -inf for keys at or past M,
// whose rows TMA fills with zeros), which its 32 lanes read a tile ahead and
// write. Each consumer computes S = Q K^T (m64n128k16, Q and K from shared
// memory), the online softmax in registers with exp2 and the scale dh^-1/2
// log2(e) folded into one multiply, then O += P V with P, rounded to bf16,
// as the register A operand and V (MN-major) from shared memory. The row max
// and sum stay f32; the division comes after P V.
//
// What bounds it: 4 N M dh FLOP against exp on every score. At dh=64 the
// exps (one MUFU op each, 16 per SM per clock) take as long as the products
// at the tensor cores' rate. The two consumers take turns issuing S on named
// barriers, so one's softmax runs while the other's products do
// (FlashAttention-3's ping-pong); being persistent, a CTA's next tile loads
// while it finishes this one. Issuing the next tile's S ahead of this tile's
// P V within a warpgroup (FlashAttention-3's other overlap) measured slower
// here (PERF.md), and is not done.

constexpr int kHq = 128, kHk = 128, kHStages = 3, kHThreads = 384;
constexpr float kLn2 = 0.6931471805599453f;

template <int DH>
struct Bf16Attn {
  static constexpr int row_bytes = 2 * DH;  // 128 or 64: the swizzle
  static constexpr int q_bytes = kHq * row_bytes, kv_bytes = kHk * row_bytes;
  static constexpr int sbo = 8 * row_bytes;  // between groups of 8 rows
  // slack to align to the swizzle period, two Q tiles, the K/V ring, the
  // masks and the barriers
  static constexpr size_t bytes =
      1024 + 2 * q_bytes + 2 * kHStages * kv_bytes + kHStages * kHk * sizeof(float) + (4 + 2 * kHStages) * 8;
};

// The online softmax of one tile's scores s (entry (j, e): row 16 warp + g,
// + 8 for e >= 2, key 8 j + 2 t + (e & 1)) with its additive mask ma (log2
// units): the scores become log2-unit logits, the running row max moves
// (alpha: the factor for what was summed before), the row sums take the
// tile's exps, and p gets them rounded to bf16 as P's A fragments.
template <int DH>
__device__ __forceinline__ void online_softmax(float (&s)[64], const float* ma, int t, float (&row_max)[2],
                                               float (&row_sum)[2], float (&alpha)[2], uint32_t (&p)[8][4]) {
  constexpr float kScale = Head<DH>::scale * kLog2e;
  float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * j + e] = s[4 * j + e] * kScale + ma[8 * j + 2 * t + (e & 1)];
      tile_max[e >> 1] = fmaxf(tile_max[e >> 1], s[4 * j + e]);
    }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float mx = tile_max[hh];
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(row_max[hh], mx);
    alpha[hh] = exp2_approx(row_max[hh] - m_new);
    row_max[hh] = m_new;
    row_sum[hh] *= alpha[hh];
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const float pe = exp2_approx(s[i] - row_max[(i >> 1) & 1]);
    s[i] = pe;
    row_sum[(i >> 1) & 1] += pe;
  }
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) p[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
}

// S = Q K^T (Q and K at shared addresses q and k) into s, issued and committed
template <int DH>
__device__ __forceinline__ void issue_scores(float (&s)[64], uint32_t q, uint32_t k) {
  using S = Bf16Attn<DH>;
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0.f;
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    wgmma_ss_n128<0>(s, smem_desc(q + 32 * kk, 16, S::sbo, S::row_bytes),
                     smem_desc(k + 32 * kk, 16, S::sbo, S::row_bytes));
  wgmma_commit();
}

template <int DH, typename O>
__global__ void __launch_bounds__(kHThreads, 1)
    attention_bf16(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v, const uint8_t* __restrict__ mask,
                   O* __restrict__ out, float* __restrict__ lse, int B, int H, int N, int M, HeadLayout lo) {
  using S = Bf16Attn<DH>;
  extern __shared__ uint8_t attn_smem[];
  uint8_t* const qs = attn_smem + ((1024 - (smem_addr(attn_smem) & 1023)) & 1023);  // [2][kHq][DH]
  uint8_t* const ks = qs + 2 * S::q_bytes;  // [stage][kHk][DH], as are vs
  uint8_t* const vs = ks + kHStages * S::kv_bytes;
  float* const madd = reinterpret_cast<float*>(vs + kHStages * S::kv_bytes);  // [stage][kHk]
  uint64_t* const q_full = reinterpret_cast<uint64_t*>(madd + kHStages * kHk);
  uint64_t* const q_empty = q_full + 2;
  uint64_t* const full = q_empty + 2;
  uint64_t* const empty = full + kHStages;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int qblocks = (N + kHq - 1) / kHq, tiles = qblocks * H * B, ktiles = (M + kHk - 1) / kHk;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], 8);  // the consumers' warps
    }
    for (int s = 0; s < kHStages; ++s) {
      mbar_init(&full[s], 32);  // the producer's lanes, after their mask entries
      mbar_init(&empty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {  // the producer: its first warp
    regs_release<24>();
    if (warp != 0) return;
    int stage = 0, qbuf = 0;
    uint32_t phase = 0, qphase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int n0 = tile % qblocks * kHq, h = tile / qblocks % H, b = tile / qblocks / H;
      if (lane == 0) {
        mbar_wait(&q_empty[qbuf], qphase ^ 1);
        mbar_arrive_tx(&q_full[qbuf], S::q_bytes);
        tma_load_4d(qs + qbuf * S::q_bytes, &map_q, &q_full[qbuf], 0, n0, h, b);
      }
      if (++qbuf == 2) qbuf = 0, qphase ^= 1;
      float next[kHk / 32];  // this lane's mask entries of the next key tile, read a tile ahead
#pragma unroll
      for (int j = 0; j < kHk / 32; ++j) next[j] = mask_add(mask, b, M, lane + 32 * j) * kLog2e;
      for (int kt = 0; kt < ktiles; ++kt) {
        const int k0 = kt * kHk;
        mbar_wait(&empty[stage], phase ^ 1);
        if (lane == 0) {
          mbar_expect_tx(&full[stage], 2 * S::kv_bytes);
          tma_load_4d(ks + stage * S::kv_bytes, &map_k, &full[stage], 0, k0, h, b);
          tma_load_4d(vs + stage * S::kv_bytes, &map_v, &full[stage], 0, k0, h, b);
        }
#pragma unroll
        for (int j = 0; j < kHk / 32; ++j) madd[stage * kHk + lane + 32 * j] = next[j];
        mbar_arrive(&full[stage]);
#pragma unroll
        for (int j = 0; j < kHk / 32; ++j) next[j] = mask_add(mask, b, M, k0 + kHk + lane + 32 * j) * kLog2e;
        if (++stage == kHStages) stage = 0, phase ^= 1;
      }
    }
    return;
  }

  // a consumer warpgroup: query rows [64 cw, 64 cw + 64) of each tile. The
  // two take turns issuing S (named barrier 1 + cw, then passing the turn on
  // 2 - cw); the second passes none after its very last turn.
  regs_acquire<240>();
  const int cw = wg - 1, g = lane / 4, t = lane % 4;
  float o[DH / 2], s[64], row_max[2], row_sum[2], alpha[2];
  uint32_t p[8][4];
  int stage = 0, qbuf = 0;
  uint32_t phase = 0, qphase = 0;
  if (cw == 1) named_arrive(1, 256);  // the first turn is warpgroup 0's
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int n0 = tile % qblocks * kHq, h = tile / qblocks % H, b = tile / qblocks / H;
    const bool last_tile = tile + static_cast<int>(gridDim.x) >= tiles;
    mbar_wait(&q_full[qbuf], qphase);
    const uint32_t q_addr = smem_addr(qs + qbuf * S::q_bytes + cw * 64 * S::row_bytes);
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
    row_max[0] = row_max[1] = -INFINITY;  // log2 units
    row_sum[0] = row_sum[1] = 0.f;
    for (int kt = 0; kt < ktiles; ++kt) {
      mbar_wait(&full[stage], phase);
      named_sync(1 + cw, 256);
      issue_scores<DH>(s, q_addr, smem_addr(ks + stage * S::kv_bytes));
      if (cw == 0 || !last_tile || kt + 1 < ktiles) named_arrive(2 - cw, 256);
      wgmma_wait<0>();
      fence_regs(s);
      online_softmax<DH>(s, madd + stage * kHk, t, row_max, row_sum, alpha, p);
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      fence_regs(o);
      wgmma_fence();
      const uint32_t v_addr = smem_addr(vs + stage * S::kv_bytes);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_pv<DH>(o, p[kk], smem_desc(v_addr + 16 * kk * S::row_bytes, 8192, S::sbo, S::row_bytes));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == kHStages) stage = 0, phase ^= 1;
    }
    if (lane == 0) mbar_arrive(&q_empty[qbuf]);
    if (++qbuf == 2) qbuf = 0, qphase ^= 1;

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      row_sum[hh] += __shfl_xor_sync(0xffffffffu, row_sum[hh], 1);
      row_sum[hh] += __shfl_xor_sync(0xffffffffu, row_sum[hh], 2);
    }
    O* ob = out + b * lo.batch + h * lo.head;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = n0 + 64 * cw + 16 * warp + g + 8 * hh;
      if (r < N) {
#pragma unroll
        for (int j = 0; j < DH / 8; ++j)
          store2(ob + r * lo.row + 8 * j + 2 * t, o[4 * j + 2 * hh] / row_sum[hh],
                 o[4 * j + 2 * hh + 1] / row_sum[hh]);
        if (lse != nullptr && t == 0)
          lse[(static_cast<size_t>(b) * H + h) * N + r] = row_max[hh] * kLn2 + logf(row_sum[hh]);
      }
    }
  }
}

// The launches of attention_bf16 this library made, counted on the host where
// each is launched; og_attention_launches reads them
unsigned long long attention_launches[1] = {0};

template <int DH, typename O>
cudaError_t launch_attention_bf16(const bf16* q, const bf16* k, const bf16* v, const uint8_t* mask, O* out,
                                  float* lse, int B, int N, int M, int H, HeadLayout lq, HeadLayout lk,
                                  HeadLayout lv, HeadLayout lo, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  if (!head_map<DH>(&mq, q, B, H, N, lq, kHq) || !head_map<DH>(&mk, k, B, H, M, lk, kHk) ||
      !head_map<DH>(&mv, v, B, H, M, lv, kHk))
    return cudaErrorInvalidValue;
  const size_t smem = Bf16Attn<DH>::bytes;
  const cudaError_t err = cudaFuncSetAttribute(attention_bf16<DH, O>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int tiles = (N + kHq - 1) / kHq * H * B;
  attention_bf16<DH, O><<<tiles < sm_count() ? tiles : sm_count(), kHThreads, smem, stream>>>(mq, mk, mv, mask, out,
                                                                                             lse, B, H, N, M, lo);
  const cudaError_t launched = cudaGetLastError();
  if (launched == cudaSuccess) ++attention_launches[0];
  return launched;
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
      return launch_attention_bf16<DH, O>(q, k, v, mask, out, lse, B, N, M, H, lq, lk, lv, lo, stream);
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

// The launches of attention_bf16 (which 0) this library has made since it was
// loaded or since that count was last reset; with reset, sets the count to 0
// after reading it.
extern "C" unsigned long long og_attention_launches(int which, int reset) {
  if (which != 0) return 0;
  const unsigned long long launches = attention_launches[0];
  if (reset) attention_launches[0] = 0;
  return launches;
}
