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
// Pass A takes a block of queries (and head): it forms dS over the key tiles
// and accumulates dQ in registers. Pass B takes a block of keys: it sweeps
// the query tiles with the LSE and pass A's row sums and accumulates dK and
// dV in registers. S and dP are recomputed in each pass; that keeps every
// sum inside one CTA: no atomics, a fixed order, equal bits on two runs.
// Pass A runs before pass B on one stream, since B reads A's row sums.
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
// bf16 runs wgmma on TMA tiles (hopper.cuh) in the forward's warp-specialised,
// persistent shape, below; every view's base and strides are multiples of 16
// bytes, as TMA needs. f32 runs every product in 3xTF32 on the tensor cores
// (tf32_tiles.cuh), with the tiles staged by a cp.async ring and split into
// hi/lo fragments once per tile.
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

#include "hopper.cuh"
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

// ------------------------------------------------ bf16: wgmma on TMA tiles
// Both passes take the forward's shape (attention.cuh): a CTA is a producer
// warp and two consumer warpgroups of 64 rows, persistent over tiles of 128
// rows of one (batch element, head), the tiles of one head next to each
// other. The producer loads each tile's resident pair into one of two
// buffers, then keeps the tiles it sweeps in a ring of stages guarded by
// mbarriers, with the per-row floats they need, which its 32 lanes read
// before they wait for the stage and write after. The logits are in log2
// units: dh^-1/2 log2(e) is folded into one multiply and P = exp2(.) is one
// MUFU op per score. Every product is wgmma: the scores (S and dP) with both
// operands in shared memory, K-major; the gradient products with P or dS,
// rounded to bf16, as the register A operand and the operand tile read
// MN-major (the transpose bit) from the same shared tile, so neither P nor
// dS leaves registers.
//
// Pass A (dQ and di): resident Q and g (128 queries), K and V tiles of 128
// keys through a ring of kBwAStages with each key's additive mask (-inf past
// M, where TMA fills zeros). S = Q K^T, dP = g V^T, dS = P o (dP - di), dQ +=
// T(dS) K. With kSweep the producer sends the key tiles twice and the first
// sweep sums di = rowsum(P o dP).
// Pass B (dK and dV): resident K and V (128 keys), Q and g tiles of 128
// queries through a ring of kBwBStages with each query's LSE and di (+inf
// and 0 for queries past N, whose rows TMA fills with zeros, so P = 0).
// S^T = K Q^T, dP^T = V g^T, dV += T(P^T) g, dK += T(dS^T) Q.
// In both passes S and dP are two commit groups, and P is formed while dP's
// products run; in pass B dV's products run while dS^T is formed. The two
// consumers do not take turns issuing S and dP, as the forward's do: turns
// measured slower here (PERF.md).
//
// What bounds it: the operations, 7 (9 with the sweep) N x M x dh products
// per head and an exp per score in each pass. As measured (PERF.md), the
// gradient products (register A operands, dh wide) and the chain they end in
// each consumer (scores, wait, exps, products, wait) hold the time: 3.6x the
// bound at B=12 N=1024, under SDPA's backward.

constexpr int kBwRows = 128, kBwAk = 128, kBwBq = 128, kBwAStages = 3, kBwBStages = 4, kBwThreads = 384;

template <int DH>
struct Bf16Bwd {
  static constexpr int row_bytes = 2 * DH;  // 128 or 64: the swizzle
  static constexpr int sbo = 8 * row_bytes;  // between groups of 8 rows
  static constexpr int block_bytes = kBwRows * row_bytes;  // a resident operand: Q or g (A), K or V (B)
  static constexpr int a_tile = kBwAk * row_bytes;  // a K or V tile of pass A
  static constexpr int b_tile = kBwBq * row_bytes;  // a Q or g tile of pass B
  // slack to align to the swizzle period, two resident pairs, the ring with
  // its floats, the barriers
  static constexpr size_t a_bytes =
      1024 + 4 * block_bytes + kBwAStages * (2 * a_tile + kBwAk * sizeof(float)) + (4 + 2 * kBwAStages) * 8;
  static constexpr size_t b_bytes =
      1024 + 4 * block_bytes + kBwBStages * (2 * b_tile + 2 * kBwBq * sizeof(float)) + (4 + 2 * kBwBStages) * 8;
};

__device__ __forceinline__ uint8_t* swizzle_aligned(uint8_t* smem) {
  return smem + ((1024 - (smem_addr(smem) & 1023)) & 1023);
}

// the barriers: the resident pair's full and empty (two buffers each), then
// the stages' full and empty
__device__ __forceinline__ void init_ring(uint64_t* bars, int stages) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&bars[i], 1);      // the producer's lane 0, with the bytes
      mbar_init(&bars[2 + i], 8);  // the consumers' warps
    }
    for (int s = 0; s < stages; ++s) {
      mbar_init(&bars[4 + s], 32);  // the producer's lanes, after their floats
      mbar_init(&bars[4 + stages + s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();
}

// d += A . B^T over the head width: A 64 rows, B the N rows of a tile, both
// K-major at shared addresses; issued, not committed
template <int N, int DH>
__device__ __forceinline__ void issue_head_product(float (&d)[N / 2], uint32_t a, uint32_t b) {
  using S = Bf16Bwd<DH>;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    wgmma_ss<N, 0>(d, smem_desc(a + 32 * kk, 16, S::sbo, S::row_bytes),
                   smem_desc(b + 32 * kk, 16, S::sbo, S::row_bytes));
}

// The bf16 A fragments of an accumulator tile, 16 columns per step (entry
// (j, e): row 16 warp + g, + 8 for e >= 2, column 8 j + 2 t + (e & 1))
template <int N>
__device__ __forceinline__ void pack_fragments(uint32_t (&f)[N / 16][4], const float (&x)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) f[kk][i] = pack_bf16(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.f;
}

// ------------------------------------------------ pass A (bf16): dQ (and di)
template <int DH, bool kSweep>
__global__ void __launch_bounds__(kBwThreads, 1)
    attn_bwd_dq_bf16(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_g,
                     const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
                     const AttnBwdArgs<bf16> a, int B, int H) {
  using S = Bf16Bwd<DH>;
  extern __shared__ uint8_t bwd_smem[];
  uint8_t* const rs = swizzle_aligned(bwd_smem);  // [buf][Q, g][kBwRows][DH]
  uint8_t* const ring = rs + 4 * S::block_bytes;  // [stage][K, V][kBwAk][DH]
  float* const madd = reinterpret_cast<float*>(ring + kBwAStages * 2 * S::a_tile);  // [stage][kBwAk]
  uint64_t* const bars = reinterpret_cast<uint64_t*>(madd + kBwAStages * kBwAk);
  uint64_t *const r_full = bars, *const r_empty = bars + 2, *const full = bars + 4, *const empty = full + kBwAStages;
  const int wg = threadIdx.x / 128, warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
  const int N = a.N, M = a.M;
  const int qblocks = (N + kBwRows - 1) / kBwRows, tiles = qblocks * H * B, ktiles = (M + kBwAk - 1) / kBwAk;
  const int sweeps = kSweep ? 2 * ktiles : ktiles;
  init_ring(bars, kBwAStages);

  if (wg == 0) {  // the producer: its first warp
    regs_release<24>();
    if (warp != 0) return;
    int stage = 0, buf = 0;
    uint32_t phase = 0, bphase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int n0 = tile % qblocks * kBwRows, h = tile / qblocks % H, b = tile / qblocks / H;
      const bool dead = a.dead != nullptr && a.dead[b] != 0;
      if (lane == 0) {
        mbar_wait(&r_empty[buf], bphase ^ 1);
        mbar_arrive_tx(&r_full[buf], 2 * S::block_bytes);
        tma_load_4d(rs + 2 * buf * S::block_bytes, &map_q, &r_full[buf], 0, n0, h, b);
        tma_load_4d(rs + (2 * buf + 1) * S::block_bytes, &map_g, &r_full[buf], 0, n0, h, b);
      }
      if (++buf == 2) buf = 0, bphase ^= 1;
      for (int it = 0; it < sweeps; ++it) {
        const int k0 = (it < ktiles ? it : it - ktiles) * kBwAk;
        float ma[kBwAk / 32];  // read before the wait
#pragma unroll
        for (int j = 0; j < kBwAk / 32; ++j) ma[j] = key_add(a.mask, b, M, k0 + lane + 32 * j, dead) * kLog2e;
        mbar_wait(&empty[stage], phase ^ 1);
        if (lane == 0) {
          mbar_expect_tx(&full[stage], 2 * S::a_tile);
          tma_load_4d(ring + 2 * stage * S::a_tile, &map_k, &full[stage], 0, k0, h, b);
          tma_load_4d(ring + (2 * stage + 1) * S::a_tile, &map_v, &full[stage], 0, k0, h, b);
        }
#pragma unroll
        for (int j = 0; j < kBwAk / 32; ++j) madd[stage * kBwAk + lane + 32 * j] = ma[j];
        mbar_arrive(&full[stage]);
        if (++stage == kBwAStages) stage = 0, phase ^= 1;
      }
    }
    return;
  }

  // a consumer warpgroup: query rows [64 cw, 64 cw + 64) of each tile
  regs_acquire<240>();
  constexpr float kScale = Head<DH>::scale;
  const int cw = wg - 1, g = lane / 4, t = lane % 4;
  float s[kBwAk / 2], dp[kBwAk / 2], dq[DH / 2];
  int stage = 0, buf = 0;
  uint32_t phase = 0, bphase = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int n0 = tile % qblocks * kBwRows, h = tile / qblocks % H, b = tile / qblocks / H;
    const bool dead = a.dead != nullptr && a.dead[b] != 0;
    const float lscale = dead ? 0.f : kScale * kLog2e, ds_keep = dead && a.zero_dead_ds ? 0.f : 1.f;
    const size_t stat = (static_cast<size_t>(b) * H + h) * N;
    float lse2[2], di[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = n0 + 64 * cw + 16 * warp + g + 8 * hh;
      lse2[hh] = r < N ? (dead ? dead_lse(a) : a.lse[stat + r]) * kLog2e : INFINITY;  // padding rows: P = 0
      di[hh] = 0.f;
      if constexpr (!kSweep) {
        float x = 0.f;
        if (r < N) {
          const bf16* grow = a.g + b * a.lg.batch + h * a.lg.head + r * a.lg.row;
          const bf16* orow = a.out + b * a.lo.batch + h * a.lo.head + r * a.lo.row;
#pragma unroll
          for (int nd = 0; nd < DH / 8; ++nd) {
            const float2 u = load2(grow + nd * 8 + 2 * t), w = load2(orow + nd * 8 + 2 * t);
            x = fmaf(u.x, w.x, x);
            x = fmaf(u.y, w.y, x);
          }
        }
        x += __shfl_xor_sync(0xffffffffu, x, 1);
        x += __shfl_xor_sync(0xffffffffu, x, 2);
        di[hh] = x * row_mass(a, dead) - (a.g_lse != nullptr && r < N ? a.g_lse[stat + r] : 0.f);
      }
    }
    mbar_wait(&r_full[buf], bphase);
    const uint32_t q_addr = smem_addr(rs + 2 * buf * S::block_bytes + cw * 64 * S::row_bytes);
    const uint32_t g_addr = q_addr + S::block_bytes;
    zero(dq);
    for (int it = 0; it < sweeps; ++it) {
      const bool second = !kSweep || it >= ktiles;  // the sweep that forms dS and dQ
      mbar_wait(&full[stage], phase);
      const uint32_t k_addr = smem_addr(ring + 2 * stage * S::a_tile), v_addr = k_addr + S::a_tile;
      zero(s);
      zero(dp);
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
      issue_head_product<kBwAk, DH>(s, q_addr, k_addr);
      wgmma_commit();
      issue_head_product<kBwAk, DH>(dp, g_addr, v_addr);
      wgmma_commit();
      wgmma_wait<1>();  // P from S while dP's products run
      fence_regs(s);
      const float* ma = madd + stage * kBwAk;
#pragma unroll
      for (int j = 0; j < kBwAk / 8; ++j) {
        const float2 m2 = *reinterpret_cast<const float2*>(ma + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[4 * j + e] = exp2_approx(fmaf(s[4 * j + e], lscale, (e & 1 ? m2.y : m2.x) - lse2[e >> 1]));
      }
      wgmma_wait<0>();
      fence_regs(dp);
      if (it + 1 == sweeps && lane == 0) mbar_arrive(&r_empty[buf]);  // this tile's Q and g are read
#pragma unroll
      for (int i = 0; i < kBwAk / 2; ++i) {
        if (second) s[i] = ds_keep * s[i] * (dp[i] - di[(i >> 1) & 1]);
        else di[(i >> 1) & 1] = fmaf(s[i], dp[i], di[(i >> 1) & 1]);
      }
      if (second) {  // dQ += T(dS) K
        uint32_t f[kBwAk / 16][4];
        pack_fragments<kBwAk>(f, s);
        fence_regs(dq);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBwAk / 16; ++kk)
          wgmma_pv<DH>(dq, f[kk], smem_desc(k_addr + 16 * kk * S::row_bytes, 8192, S::sbo, S::row_bytes));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
      }
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == kBwAStages) stage = 0, phase ^= 1;
      if (kSweep && it == ktiles - 1) {  // the quad's column sums, less the LSE's cotangent
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          di[hh] += __shfl_xor_sync(0xffffffffu, di[hh], 1);
          di[hh] += __shfl_xor_sync(0xffffffffu, di[hh], 2);
          const int r = n0 + 64 * cw + 16 * warp + g + 8 * hh;
          if (a.g_lse != nullptr && r < N) di[hh] -= a.g_lse[stat + r];
        }
      }
    }
    if (++buf == 2) buf = 0, bphase ^= 1;

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = n0 + 64 * cw + 16 * warp + g + 8 * hh;
      if (r < N) {
        const long long at = b * a.ldq.batch + h * a.ldq.head + r * a.ldq.row;
#pragma unroll
        for (int j = 0; j < DH / 8; ++j) {
          const float x0 = dq[4 * j + 2 * hh] * kScale, x1 = dq[4 * j + 2 * hh + 1] * kScale;
          if (a.dq32 != nullptr) store2(a.dq32 + at + 8 * j + 2 * t, x0, x1);
          store2(a.dq + at + 8 * j + 2 * t, x0, x1);
        }
        if (t == 0) a.di[stat + r] = di[hh];
      }
    }
  }
}

// ------------------------------------------------ pass B (bf16): dK, dV
template <int DH>
__global__ void __launch_bounds__(kBwThreads, 1)
    attn_bwd_dkdv_bf16(const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
                       const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_g,
                       const AttnBwdArgs<bf16> a, int B, int H) {
  using S = Bf16Bwd<DH>;
  extern __shared__ uint8_t bwd_smem[];
  uint8_t* const rs = swizzle_aligned(bwd_smem);  // [buf][K, V][kBwRows][DH]
  uint8_t* const ring = rs + 4 * S::block_bytes;  // [stage][Q, g][kBwBq][DH]
  float* const rowf = reinterpret_cast<float*>(ring + kBwBStages * 2 * S::b_tile);  // [stage][lse2, di][kBwBq]
  uint64_t* const bars = reinterpret_cast<uint64_t*>(rowf + kBwBStages * 2 * kBwBq);
  uint64_t *const r_full = bars, *const r_empty = bars + 2, *const full = bars + 4, *const empty = full + kBwBStages;
  const int wg = threadIdx.x / 128, warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
  const int N = a.N, M = a.M;
  const int kblocks = (M + kBwRows - 1) / kBwRows, tiles = kblocks * H * B, qtiles = (N + kBwBq - 1) / kBwBq;
  init_ring(bars, kBwBStages);

  if (wg == 0) {  // the producer: its first warp
    regs_release<24>();
    if (warp != 0) return;
    int stage = 0, buf = 0;
    uint32_t phase = 0, bphase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = tile % kblocks * kBwRows, h = tile / kblocks % H, b = tile / kblocks / H;
      const bool dead = a.dead != nullptr && a.dead[b] != 0;
      const float lse_dead = dead_lse(a) * kLog2e;
      const size_t stat = (static_cast<size_t>(b) * H + h) * N;
      if (lane == 0) {
        mbar_wait(&r_empty[buf], bphase ^ 1);
        mbar_arrive_tx(&r_full[buf], 2 * S::block_bytes);
        tma_load_4d(rs + 2 * buf * S::block_bytes, &map_k, &r_full[buf], 0, m0, h, b);
        tma_load_4d(rs + (2 * buf + 1) * S::block_bytes, &map_v, &r_full[buf], 0, m0, h, b);
      }
      if (++buf == 2) buf = 0, bphase ^= 1;
      for (int qt = 0; qt < qtiles; ++qt) {
        const int q0 = qt * kBwBq;
        float lse2[kBwBq / 32], di[kBwBq / 32];  // read before the wait
#pragma unroll
        for (int j = 0; j < kBwBq / 32; ++j) {
          const int r = q0 + lane + 32 * j;
          lse2[j] = r < N ? (dead ? lse_dead : a.lse[stat + r] * kLog2e) : INFINITY;  // padding: P = 0
          di[j] = r < N ? a.di[stat + r] : 0.f;
        }
        mbar_wait(&empty[stage], phase ^ 1);
        if (lane == 0) {
          mbar_expect_tx(&full[stage], 2 * S::b_tile);
          tma_load_4d(ring + 2 * stage * S::b_tile, &map_q, &full[stage], 0, q0, h, b);
          tma_load_4d(ring + (2 * stage + 1) * S::b_tile, &map_g, &full[stage], 0, q0, h, b);
        }
#pragma unroll
        for (int j = 0; j < kBwBq / 32; ++j) {
          rowf[2 * stage * kBwBq + lane + 32 * j] = lse2[j];
          rowf[(2 * stage + 1) * kBwBq + lane + 32 * j] = di[j];
        }
        mbar_arrive(&full[stage]);
        if (++stage == kBwBStages) stage = 0, phase ^= 1;
      }
    }
    return;
  }

  // a consumer warpgroup: key rows [64 cw, 64 cw + 64) of each tile, the
  // rows of every product (they are transposed)
  regs_acquire<240>();
  constexpr float kScale = Head<DH>::scale;
  const int cw = wg - 1, g = lane / 4, t = lane % 4;
  float s[kBwBq / 2], dp[kBwBq / 2], dk[DH / 2], dv[DH / 2];
  int stage = 0, buf = 0;
  uint32_t phase = 0, bphase = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile % kblocks * kBwRows, h = tile / kblocks % H, b = tile / kblocks / H;
    const bool dead = a.dead != nullptr && a.dead[b] != 0;
    const float lscale = dead ? 0.f : kScale * kLog2e, ds_keep = dead && a.zero_dead_ds ? 0.f : 1.f;
    float madd[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      madd[hh] = key_add(a.mask, b, M, m0 + 64 * cw + 16 * warp + g + 8 * hh, dead) * kLog2e;
    mbar_wait(&r_full[buf], bphase);
    const uint32_t k_addr = smem_addr(rs + 2 * buf * S::block_bytes + cw * 64 * S::row_bytes);
    const uint32_t v_addr = k_addr + S::block_bytes;
    zero(dk);
    zero(dv);
    for (int qt = 0; qt < qtiles; ++qt) {
      mbar_wait(&full[stage], phase);
      const uint32_t q_addr = smem_addr(ring + 2 * stage * S::b_tile), g_addr = q_addr + S::b_tile;
      zero(s);
      zero(dp);
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
      issue_head_product<kBwBq, DH>(s, k_addr, q_addr);
      wgmma_commit();
      issue_head_product<kBwBq, DH>(dp, v_addr, g_addr);
      wgmma_commit();
      wgmma_wait<1>();  // P^T from S^T while dP^T's products run
      fence_regs(s);
      const float* lse2 = rowf + 2 * stage * kBwBq;
      const float* di = lse2 + kBwBq;
#pragma unroll
      for (int j = 0; j < kBwBq / 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(lse2 + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[4 * j + e] = exp2_approx(fmaf(s[4 * j + e], lscale, madd[e >> 1] - (e & 1 ? l2.y : l2.x)));
      }
      // dV += T(P^T) g, issued before dS^T is formed
      uint32_t pf[kBwBq / 16][4], sf[kBwBq / 16][4];
      pack_fragments<kBwBq>(pf, s);
      fence_regs(dv);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBwBq / 16; ++kk)
        wgmma_pv<DH>(dv, pf[kk], smem_desc(g_addr + 16 * kk * S::row_bytes, 8192, S::sbo, S::row_bytes));
      wgmma_commit();
      wgmma_wait<1>();  // dP^T (dV's products may still run)
      fence_regs(dp);
      if (qt + 1 == qtiles && lane == 0) mbar_arrive(&r_empty[buf]);  // this tile's K and V are read
#pragma unroll
      for (int j = 0; j < kBwBq / 8; ++j) {
        const float2 d2 = *reinterpret_cast<const float2*>(di + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          dp[i] = ds_keep * s[i] * (dp[i] - (e & 1 ? d2.y : d2.x));
        }
      }
      // dK += T(dS^T) Q
      pack_fragments<kBwBq>(sf, dp);
      fence_regs(dk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBwBq / 16; ++kk)
        wgmma_pv<DH>(dk, sf[kk], smem_desc(q_addr + 16 * kk * S::row_bytes, 8192, S::sbo, S::row_bytes));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == kBwBStages) stage = 0, phase ^= 1;
    }
    if (++buf == 2) buf = 0, bphase ^= 1;

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = m0 + 64 * cw + 16 * warp + g + 8 * hh;
      if (r < M) {
        const long long at = b * a.ldkv.batch + h * a.ldkv.head + r * a.ldkv.row;
        const long long at32 = b * a.ldkv32.batch + h * a.ldkv32.head + r * a.ldkv32.row;
#pragma unroll
        for (int j = 0; j < DH / 8; ++j) {
          const int c = 8 * j + 2 * t;
          const float k0 = dk[4 * j + 2 * hh] * kScale, k1 = dk[4 * j + 2 * hh + 1] * kScale;
          const float v0 = dv[4 * j + 2 * hh], v1 = dv[4 * j + 2 * hh + 1];
          if (a.dk32 != nullptr) {
            store2(a.dk32 + at32 + c, k0, k1);
            store2(a.dv32 + at32 + c, v0, v1);
          }
          store2(a.dk + at + c, k0, k1);
          store2(a.dv + at + c, v0, v1);
        }
      }
    }
  }
}

// The launches of the bf16 passes this library made (each pass counts one),
// counted on the host where each is launched; og_attention_backward_launches
// reads them
unsigned long long attention_backward_launches[1] = {0};

// pass A, then pass B, the bf16 passes on their TMA maps
template <int DH, bool kSweep>
cudaError_t launch_backward_bf16(const AttnBwdArgs<bf16>& a, int B, int H, cudaStream_t stream) {
  static_assert(kBwAk == kBwRows, "pass A's K and V tiles and pass B's resident K and V share their maps");
  const int N = a.N, M = a.M;
  CUtensorMap q_rows, g_rows, q_tile, g_tile, k_rows, v_rows;
  if (!head_map<DH>(&q_rows, a.q, B, H, N, a.lq, kBwRows) || !head_map<DH>(&g_rows, a.g, B, H, N, a.lg, kBwRows) ||
      !head_map<DH>(&q_tile, a.q, B, H, N, a.lq, kBwBq) || !head_map<DH>(&g_tile, a.g, B, H, N, a.lg, kBwBq) ||
      !head_map<DH>(&k_rows, a.k, B, H, M, a.lk, kBwRows) || !head_map<DH>(&v_rows, a.v, B, H, M, a.lv, kBwRows))
    return cudaErrorInvalidValue;
  const size_t smem_a = Bf16Bwd<DH>::a_bytes, smem_b = Bf16Bwd<DH>::b_bytes;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(attn_bwd_dq_bf16<DH, kSweep>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem_a)))) return err;
  if ((err = cudaFuncSetAttribute(attn_bwd_dkdv_bf16<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem_b)))) return err;
  const int sms = sm_count();
  const int tiles_a = (N + kBwRows - 1) / kBwRows * H * B, tiles_b = (M + kBwRows - 1) / kBwRows * H * B;
  attn_bwd_dq_bf16<DH, kSweep><<<tiles_a < sms ? tiles_a : sms, kBwThreads, smem_a, stream>>>(
      q_rows, g_rows, k_rows, v_rows, a, B, H);
  if ((err = cudaGetLastError())) return err;
  ++attention_backward_launches[0];
  attn_bwd_dkdv_bf16<DH><<<tiles_b < sms ? tiles_b : sms, kBwThreads, smem_b, stream>>>(
      k_rows, v_rows, q_tile, g_tile, a, B, H);
  if ((err = cudaGetLastError())) return err;
  ++attention_backward_launches[0];
  return cudaSuccess;
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
    if constexpr (sizeof(T) == 2) {
      return launch_backward_bf16<DH, kSweep>(a, B, H, s);
    } else {
      cudaError_t err;
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

// The launches of the bf16 passes (which 0; two per backward) this library
// has made since it was loaded or since that count was last reset; with
// reset, sets the count to 0 after reading it.
extern "C" unsigned long long og_attention_backward_launches(int which, int reset) {
  if (which != 0) return 0;
  const unsigned long long launches = attention_backward_launches[0];
  if (reset) attention_backward_launches[0] = 0;
  return launches;
}
