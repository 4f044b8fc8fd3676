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
// bf16: Hopper's wgmma on TMA tiles, persistent CTAs of one producer and two
// consumer warpgroups that take tiles in turn, an mbarrier ring of k-tiles
// and an epilogue through shared memory with 16-byte stores (see the bf16
// section below). What keeps them over their byte bound is the epilogue, not
// the products or the weight tiles' re-reads from L2: taking out the stores
// saves the most time, taking out the products or the weight loads little
// (scripts/bf16_ablations.py, PERF.md). f32: 3xTF32 on the tensor
// cores from a three-stage cp.async ring of raw f32 tiles, up to 128 x 128 per
// CTA of 8 warps (see the f32 section below).

#pragma once

#include "hopper.cuh"

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

// ---------------------------------------------------------------- bf16
// wgmma on TMA tiles (hopper.cuh). A CTA is one producer warpgroup and two
// consumer warpgroups, persistent over 64 x BN output tiles (in row-major
// order, so the n-slabs of one row block run side by side and A comes from
// device memory once where n_out <= BN). The consumers take the CTA's tiles
// in turn (FlashAttention-3's and CUTLASS's ping-pong): while one runs its
// epilogue the other's products run, so the epilogue, the larger cost at
// these byte-bound shapes (PERF.md), overlaps the tensor cores' work. One
// thread of the producer keeps k-tiles of 64 (128-byte rows, 128-byte
// swizzle) of A and of the weight in a ring of kStages stages, in the CTA's
// tile order, each guarded by a `full` mbarrier (TMA bytes landed) and an
// `empty` one (the consuming warpgroup's warps done with it); rows past the
// end and k past k arrive as zeros. The weight tile is K-major as torch
// stores it ([n_out, k]), or MN-major with KN ([k, n_out], wgmma's transposed
// B). A consumer issues the four k-steps of a stage as m64nBNk16 wgmma into
// its f32 accumulator and releases the stage once the next stage's products
// are issued, so the tensor cores always have one group queued.
//
// The ring takes up to 200 KB: 5 stages at 64 x 256, 8 at 64 x 128 and
// 64 x 64. A consumer releases a stage only once the next stage's products
// are queued, so the ring is deeper than the loads the producer has in
// flight; with fewer stages the loads' latency showed between k-tiles.
//
// The epilogue goes through shared memory: each consumer warpgroup writes 32
// accumulator columns at a time to its f32 staging tile (row stride 40 floats:
// two wavefronts per warp, the least for 256 bytes), then each thread takes
// 8 consecutive columns of a row (the same 8 columns for all its rows of a
// chunk, so the bias, scale and shift are read once per chunk) and applies
// the epilogue there, with the rounding points of epilogue2: 16-byte loads of
// x and 16-byte stores.

constexpr int kGk = 64;  // the k-tile: one 128-byte row of bf16

template <int BN>
struct Bf16Tile {
  static constexpr int BM = 64, kConsumers = 2, kThreads = 128 * (kConsumers + 1);
  static constexpr int a_bytes = BM * 2 * kGk, w_bytes = BN * 2 * kGk, stage_bytes = a_bytes + w_bytes;
  static constexpr int kStages = 204800 / stage_bytes < 8 ? 204800 / stage_bytes : 8;
  static constexpr int kLd = 40;  // floats per row of a warpgroup's staging tile (32 columns + 8)
  static constexpr int staging_floats = kConsumers * BM * kLd;
  // 1024 bytes of slack to align the ring to the swizzle period, the ring,
  // the staging tiles and the barriers
  static constexpr size_t bytes = 1024 + kStages * stage_bytes + staging_floats * sizeof(float) + 2 * kStages * 8;
};

__device__ __forceinline__ void load8(const bf16* src, float (&x)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(bf16* dst, const float (&y)[8]) {
  *reinterpret_cast<uint4*>(dst) =
      make_uint4(pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]), pack_bf16(y[4], y[5]), pack_bf16(y[6], y[7]));
}

// The per-column vectors of columns c .. c + 7: the bias, and the scale and
// shift of kReluAffine
struct Columns8 {
  float bias[8], scale[8], shift[8];
};
template <int EPI>
__device__ __forceinline__ Columns8 columns8(const GemmArgs<bf16>& p, int c) {
  Columns8 v;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    v.bias[i] = bias_at(p, c + i);
    if constexpr (EPI == kReluAffine) {
      v.scale[i] = p.scale[c + i];
      v.shift[i] = p.shift[c + i];
    }
  }
  return v;
}

// columns c .. c + 7 of row r, from their f32 sums s (epilogue2's arithmetic)
template <int EPI>
__device__ __forceinline__ void epilogue8(const GemmArgs<bf16>& p, const Columns8& v, int r, int c, const float* s) {
  const float4 s0 = *reinterpret_cast<const float4*>(s), s1 = *reinterpret_cast<const float4*>(s + 4);
  const float sum[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
  float y[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) y[i] = sum[i] + v.bias[i];
  bf16* o = p.out + static_cast<size_t>(r) * p.ldo + c;
  if constexpr (EPI == kBias) {
    store8(o, y);
  } else if constexpr (EPI == kBiasF32) {
    float4* of = reinterpret_cast<float4*>(reinterpret_cast<float*>(p.out) + static_cast<size_t>(r) * p.ldo + c);
    of[0] = make_float4(y[0], y[1], y[2], y[3]);
    of[1] = make_float4(y[4], y[5], y[6], y[7]);
  } else if constexpr (EPI == kConcat) {
    float m[8], x[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) m[i] = round_to<bf16>(y[i]);
    load8(p.x + static_cast<size_t>(r) * p.ldx + c, x);
    store8(o + p.n_out, m);
    if (p.use_offset) {
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] -= m[i];
    }
    store8(o, x);
  } else if constexpr (EPI == kReluAffine || EPI == kRelu) {
    // a ReLU that keeps NaN (fmaxf would drop it): a feature-kind element with
    // no valid key is NaN through the whole layer
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      y[i] = y[i] < 0.f ? 0.f : y[i];
      if constexpr (EPI == kReluAffine) y[i] = y[i] * v.scale[i] + v.shift[i];
    }
    store8(o, y);
  } else {
    float x[8];
    load8(p.x + static_cast<size_t>(r) * p.ldx + c, x);
#pragma unroll
    for (int i = 0; i < 8; ++i) y[i] += x[i];
    store8(o, y);
  }
}

template <int EPI, bool KN, int BN>
__global__ void __launch_bounds__(Bf16Tile<BN>::kThreads, 1)
    gemm_bf16(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_w,
              const __grid_constant__ CUtensorMap map_w2, GemmArgs<bf16> p, int wrows) {
  using G = Bf16Tile<BN>;
  extern __shared__ uint8_t gemm_smem[];
  uint8_t* const a_ring = gemm_smem + ((1024 - (smem_addr(gemm_smem) & 1023)) & 1023);
  uint8_t* const w_ring = a_ring + G::kStages * G::a_bytes;
  float* const staging = reinterpret_cast<float*>(w_ring + G::kStages * G::w_bytes);
  uint64_t* const full = reinterpret_cast<uint64_t*>(staging + G::staging_floats);
  uint64_t* const empty = full + G::kStages;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int slabs = p.n_out / BN, tiles = (p.rows + G::BM - 1) / G::BM * slabs, ktiles = (p.k + kGk - 1) / kGk;
  if (threadIdx.x == 0) {
    for (int s = 0; s < G::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // the consuming warpgroup's warps
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {  // the producer
    regs_release<40>();
    if (tid != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = tile / slabs * G::BM, n0 = tile % slabs * BN;
      for (int kt = 0; kt < ktiles; ++kt) {
        const int k0 = kt * kGk;
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_arrive_tx(&full[stage], G::stage_bytes);
        tma_load_2d(a_ring + stage * G::a_bytes, &map_a, &full[stage], k0, m0);
        uint8_t* const ws = w_ring + stage * G::w_bytes;
        // boxes of 64 x wrows: wrows weight rows (k-rows with KN, 64 columns
        // each) of W or of W2, at row i of the 64-row block j (an offset of
        // i * 128 bytes, a whole number of 1024-byte swizzle periods)
        for (int j = 0; j < BN / 64; ++j)
          for (int i = 0; i < 64; i += wrows) {
            uint8_t* const dst = ws + j * 8192 + i * 128;
            if constexpr (KN) {
              const int kr = k0 + i;
              const bool second = p.k_split && kr >= p.k_split;
              tma_load_2d(dst, second ? &map_w2 : &map_w, &full[stage], n0 + 64 * j, second ? kr - p.k_split : kr);
            } else {
              const int c = n0 + 64 * j + i;
              const bool second = p.split && c >= p.split;
              tma_load_2d(dst, second ? &map_w2 : &map_w, &full[stage], k0, second ? c - p.split : c);
            }
          }
        if (++stage == G::kStages) stage = 0, phase ^= 1;
      }
    }
    return;
  }

  // a consumer warpgroup: the CTA's tiles cw, cw + 2, ..., whose k-tiles sit
  // at ring positions j ktiles .. j ktiles + ktiles - 1 for the CTA's j-th
  // tile. The two take turns at their main loops (named barrier 3 + cw, then
  // the turn passes on 4 - cw when the CTA has a next tile, which is the
  // other's): a consumer so never waits on a ring position whose stage's
  // previous fill another consumer has not yet seen, which the mbarriers'
  // phase parity could not tell apart.
  regs_acquire<232>();
  const int cw = wg - 1, g = lane / 4, t = lane % 4;
  float* const st = staging + cw * 64 * G::kLd;
  float acc[BN / 2];
  int pos = cw * ktiles;
  if (cw == 1) named_arrive(3, 256);  // the first main loop is consumer 0's
  for (int tile = blockIdx.x + cw * gridDim.x; tile < tiles; tile += G::kConsumers * gridDim.x) {
    const int m0 = tile / slabs * G::BM, n0 = tile % slabs * BN;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    int prev = -1;
    named_sync(3 + cw, 256);
    for (int kt = 0; kt < ktiles; ++kt, ++pos) {
      const int stage = pos % G::kStages;
      mbar_wait(&full[stage], (pos / G::kStages) & 1);
      const uint32_t a = smem_addr(a_ring + stage * G::a_bytes);
      const uint32_t w = smem_addr(w_ring + stage * G::w_bytes);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kGk / 16; ++kk) {
        // K-major: k-step kk is 32 bytes into each 128-byte row; MN-major
        // (KN): 16 k-rows of 128 bytes on, 64-column blocks 8192 bytes apart
        const uint64_t db = KN ? smem_desc(w + 2048 * kk, 8192, 1024, 128) : smem_desc(w + 32 * kk, 16, 1024, 128);
        wgmma_ss<BN, KN ? 1 : 0>(acc, smem_desc(a + 32 * kk, 16, 1024, 128), db);
      }
      wgmma_commit();
      fence_regs(acc);
      wgmma_wait<1>();  // the previous stage's products are done
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = stage;
    }
    if (tile + static_cast<int>(gridDim.x) < tiles) named_arrive(4 - cw, 256);
    pos += (G::kConsumers - 1) * ktiles;  // the other consumer's tile
    // accumulator (j, e): row 16 warp + g (+ 8 for e >= 2), column 8 j + 2 t + (e & 1);
    // 32 columns at a time, each thread then 8 columns (tid % 4) of rows tid / 4 and 32 + tid / 4.
    // The column vectors of each chunk are read one chunk ahead (the first
    // while the last products finish)
    const int col = tid % 4 * 8, row = tid / 4;
    Columns8 v = columns8<EPI>(p, n0 + col);
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(&empty[prev]);
#pragma unroll
    for (int c = 0; c < BN / 32; ++c) {
      Columns8 next = v;
      if (c + 1 < BN / 32) next = columns8<EPI>(p, n0 + 32 * (c + 1) + col);
      named_sync(1 + cw, 128);  // this warpgroup is done reading the staging tile
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * (4 * c + jj);
        float* s = st + (16 * warp + g) * G::kLd + 8 * jj + 2 * t;
        *reinterpret_cast<float2*>(s) = make_float2(acc[j], acc[j + 1]);
        *reinterpret_cast<float2*>(s + 8 * G::kLd) = make_float2(acc[j + 2], acc[j + 3]);
      }
      named_sync(1 + cw, 128);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = row + 32 * half;
        if (m0 + r < p.rows) epilogue8<EPI>(p, v, m0 + r, n0 + 32 * c + col, st + r * G::kLd + col);
      }
      v = next;
    }
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

// The launches of the GEMM kernels this library made, counted on the host
// where each kernel is launched; og_gemm_launches reads them
enum GemmKernel { kGemmF32 = 0, kTnGemmF32 = 1, kGemmBf16 = 2 };
unsigned long long gemm_launches[3] = {0, 0, 0};

inline cudaError_t counted_launch(GemmKernel which) {
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++gemm_launches[which];
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

// The bf16 launch rule, from the three tiles' times at K1's shapes for
// 16,384, 12,288, 4,096 and 1,024 rows on an H100 (PERF.md): the widest
// n-slab (A read once per slab) whose tiles give every SM two, one for each
// consumer, so that one's epilogue overlaps the other's products; else
// 64 x 64, the most tiles (B=1, 1,024 rows, and the fixture's 4,096 at D=128).
// K1 at B=16 takes 64 x 256 for n_out 512 and 64 x 128 for n_out 256.
// Returns the tile's width BN (tiles of 64 x BN).
inline int bf16_tile_rule(int rows, int n_out) {
  const int sms = sm_count(), blocks = (rows + 63) / 64;
  if (n_out % 256 == 0 && blocks * (n_out / 256) >= 2 * sms) return 256;
  if (n_out % 128 == 0 && blocks * (n_out / 128) >= 2 * sms) return 128;
  return 64;
}

// The tensor maps of A ([rows, k], row stride lda) and of W and W2 in their
// layouts, boxes of 64 x wrows for the weights
template <int BM, bool KN>
bool bf16_gemm_maps(const GemmArgs<bf16>& p, int wrows, CUtensorMap* a, CUtensorMap* w, CUtensorMap* w2) {
  const uint32_t box_a[2] = {kGk, BM}, box_w[2] = {64, static_cast<uint32_t>(wrows)};
  const uint64_t dims_a[2] = {static_cast<uint64_t>(p.k), static_cast<uint64_t>(p.rows)};
  const uint64_t stride_a[1] = {static_cast<uint64_t>(p.lda) * 2};
  if (!bf16_map(a, p.A, 2, dims_a, stride_a, box_a, 128)) return false;
  // KN: W [k or k_split, n_out], W2 [k - k_split, n_out]; else W [n_out or split, k], W2 [n_out - split, k]
  const int cut = KN ? p.k_split : p.split, whole = KN ? p.k : p.n_out, inner = KN ? p.n_out : p.k;
  const uint64_t stride_w[1] = {static_cast<uint64_t>(inner) * 2};
  const uint64_t dims_w[2] = {static_cast<uint64_t>(inner), static_cast<uint64_t>(cut ? cut : whole)};
  if (!bf16_map(w, p.W, 2, dims_w, stride_w, box_w, 128)) return false;
  if (!cut) {
    *w2 = *w;
    return true;
  }
  const uint64_t dims_w2[2] = {static_cast<uint64_t>(inner), static_cast<uint64_t>(whole - cut)};
  return bf16_map(w2, p.W2, 2, dims_w2, stride_w, box_w, 128);
}

template <int EPI, bool KN, int BN>
cudaError_t launch_gemm_bf16(const GemmArgs<bf16>& p, cudaStream_t stream) {
  using G = Bf16Tile<BN>;
  // the stacked weights' cut falls on a box boundary: 64-row boxes where it
  // can, else 16 (one wgmma k-step), else 8 (one swizzle period)
  const int cut = KN ? p.k_split : p.split;
  const int wrows = cut % 64 == 0 ? 64 : cut % 16 == 0 ? 16 : 8;
  CUtensorMap a, w, w2;
  if (!bf16_gemm_maps<G::BM, KN>(p, wrows, &a, &w, &w2)) return cudaErrorInvalidValue;
  auto kernel = gemm_bf16<EPI, KN, BN>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(G::bytes));
  if (err != cudaSuccess) return err;
  const int tiles = (p.rows + G::BM - 1) / G::BM * (p.n_out / BN);
  kernel<<<tiles < sm_count() ? tiles : sm_count(), G::kThreads, G::bytes, stream>>>(a, w, w2, p, wrows);
  return counted_launch(kGemmBf16);
}

// The stacked weights' cut (split, or k_split with KN) a multiple of 8 in bf16
template <typename T, int EPI, bool KN = false>
cudaError_t gemm(const GemmArgs<T>& p, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    if (p.split % 8 != 0 || p.k_split % 8 != 0 || p.lda % 8 != 0) return cudaErrorInvalidValue;
    switch (bf16_tile_rule(p.rows, p.n_out)) {
      case 256: return launch_gemm_bf16<EPI, KN, 256>(p, stream);
      case 128: return launch_gemm_bf16<EPI, KN, 128>(p, stream);
    }
    return launch_gemm_bf16<EPI, KN, 64>(p, stream);
  } else {
    if (f32_tile_rule(p.rows, p.n_out) == kTile128x128)
      return launch_gemm_f32<EPI, KN, 128, 128, 64, 32, 1, 2>(p, stream);
    return launch_gemm_f32<EPI, KN, 64, 64, 32, 32, 3, 1>(p, stream);
  }
}

}  // namespace

// The launches of gemm_f32 (which 0), tn_gemm_f32 (which 1) or gemm_bf16
// (which 2) this library has made since it was loaded or since that count
// was last reset; with reset, sets the count to 0 after reading it.
extern "C" unsigned long long og_gemm_launches(int which, int reset) {
  if (which < kGemmF32 || which > kGemmBf16) return 0;
  const unsigned long long launches = gemm_launches[which];
  if (reset) gemm_launches[which] = 0;
  return launches;
}
