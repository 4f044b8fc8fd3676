// Shared-memory tiles of f32 operands for 3xTF32 products on the tensor cores
// (mma.sync m16n8k8), shared by the f32 attention forward and its backward.
//
// A tile of rows of a [L, DH] head operand comes into shared memory as raw f32
// rows by 16-byte cp.async (stage_raw). One split pass per tile (split_tile)
// then writes each element's hi and lo TF32 parts in "fragment order": for
// each 8 x 8 block of the B operand, lane (g, t) = (lane / 4, lane % 4) finds
// its {hi b0, hi b1, lo b0, lo b1} as one float4 at block * 32 + lane, so a
// warp reads a block in 512 contiguous bytes, with no bank conflict and no
// conversion. Two orders of a tile's B operand exist:
//
// kd: k = the tile's columns (the head dims), n = its rows; block (n / 8,
//     k / 8), b0 = x[n0 + g][k0 + t], b1 = x[n0 + g][k0 + t + 4]. A product
//     that contracts over the head dims (S = Q K^T, dP = g V^T) reads K or V
//     so.
// kr: k = the tile's rows, n = its columns; block (k / 8, n / 8), b0 =
//     x[k0 + 2t][n0 + g], b1 = x[k0 + 2t + 1][n0 + g]: the rows of each group
//     of 8 taken in the order (0, 2, 4, 6, 1, 3, 5, 7). A thread's
//     accumulator holds columns 2t and 2t + 1 of each 8-wide n-tile; in this
//     row order those are its A slots t and t + 4, so an accumulator tile
//     (P, dS) becomes the A operand of the next product (P V, dS K) in
//     registers, without a shuffle (a_from_acc).
//
// A operands that stay for a whole sweep (Q, g, K, V rows of a warp) are read
// once from device memory into registers (load_a_rows) as raw f32 and split
// per tile (fewer registers than holding hi and lo).

#pragma once

#include "mma.cuh"

namespace {

// Row stride (floats) of a raw tile of DH columns: rows stay 16-byte aligned,
// and the split pass's reads in both orders fall in 32 distinct banks
template <int DH>
__host__ __device__ constexpr int raw_ld() {
  return DH + 4;
}

// CTAs per SM that a 128-thread f32 attention kernel asks the register
// allocator for: three (168 registers) at dh = 32, where the forward and
// pass A fit without spilling and run faster (measured on an H100); one at
// dh = 64, where a cap of 168 spills and runs slower
template <int DH>
__host__ __device__ constexpr int x_min_blocks() {
  return DH == 32 ? 3 : 1;
}

// rows [r0, r0 + ROWS) of a [L, DH] operand (row stride ld, in elements) into
// a raw shared tile by 16-byte cp.async (not committed); rows at or past
// `limit` are zero
template <int ROWS, int DH, int THREADS>
__device__ __forceinline__ void stage_raw(float* dst, const float* src, long long ld, int r0, int limit,
                                          int tid) {
  constexpr int kChunks = DH / 4;
#pragma unroll 1  // unrolled, its addresses would be hoisted and held in registers across the sweep
  for (int i = tid; i < ROWS * kChunks; i += THREADS) {
    const int r = i / kChunks, c = (i % kChunks) * 4;
    const bool ok = r0 + r < limit;
    cp_async16(dst + r * raw_ld<DH>() + c, src + (ok ? r0 + r : 0) * ld + c, ok);
  }
}

// The hi/lo fragments of a raw [ROWS, DH] tile, in kd order (KR false) or kr
// order (KR true). THREADS is a multiple of 32, so each warp splits whole
// blocks.
template <int ROWS, int DH, int THREADS, bool KR>
__device__ __forceinline__ void split_tile(float4* __restrict__ dst, const float* __restrict__ raw, int tid) {
  constexpr int ld = raw_ld<DH>(), per = DH / 8, slots = ROWS * DH / 2;
#pragma unroll 1  // as in stage_raw
  for (int s = tid; s < slots; s += THREADS) {
    const int block = s / 32, g = (s % 32) / 4, t = s % 4;
    float x0, x1;
    if constexpr (KR) {
      const int k0 = (block / per) * 8, n0 = (block % per) * 8;
      x0 = raw[(k0 + 2 * t) * ld + n0 + g];
      x1 = raw[(k0 + 2 * t + 1) * ld + n0 + g];
    } else {
      const int n0 = (block / per) * 8, k0 = (block % per) * 8;
      x0 = raw[(n0 + g) * ld + k0 + t];
      x1 = raw[(n0 + g) * ld + k0 + t + 4];
    }
    uint32_t h0, l0, h1, l1;
    split_tf32(x0, h0, l0);
    split_tf32(x1, h1, l1);
    dst[s] = make_float4(__uint_as_float(h0), __uint_as_float(h1), __uint_as_float(l0), __uint_as_float(l1));
  }
}

// The A operand (16 x 8: rows g and g + 8, k slots t and t + 4) of a product
// that contracts over one accumulator n-tile's 8 columns, in kr's row order:
// slot t is column 2t, slot t + 4 column 2t + 1
__device__ __forceinline__ void a_from_acc(const float (&c)[4], uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_tf32(c[0], hi[0], lo[0]);  // row g, column 2t
  split_tf32(c[2], hi[1], lo[1]);  // row g + 8, column 2t
  split_tf32(c[1], hi[2], lo[2]);  // row g, column 2t + 1
  split_tf32(c[3], hi[3], lo[3]);  // row g + 8, column 2t + 1
}

// The tensor cores add each product into an f32 accumulator rounding toward
// zero, so a sum chained through many mma.sync shrinks by about half an ulp
// per step; chained over a whole key sweep (a running output) that is ~1e-5
// relative at 1024 keys. So no product here runs longer than one tile into
// one accumulator: each tile's partial starts at zero and is added to the
// running sum in f32 (round to nearest), and hi.hi runs apart from the small
// terms.
//
// Issue order. mma.sync, the TF32 conversions and these loads are volatile
// asm, so they issue in program order: a warp loads the fragments of one
// k-step, splits its A operand while they arrive, then issues the products
// in three rounds over the n-tiles (lo . hi, hi . lo, hi . hi), so that no
// mma waits on the one just before it. Left to itself the compiler hoists a
// whole tile's loads and splits ahead of the products and runs out of
// registers.

__device__ __forceinline__ float4 lds_frag(const float4* p) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(smem_addr(p)));
  return v;
}

// acc[j] += a . b[j] in 3xTF32 for N n-tiles, in three rounds
template <int N>
__device__ __forceinline__ void mma_rounds(float (&acc)[N][4], float (&lo)[N][4], const uint32_t (&hi)[4],
                                           const uint32_t (&lw)[4], const float4 (&b)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(lo[j], lw, __float_as_uint(b[j].x), __float_as_uint(b[j].y));
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(lo[j], hi, __float_as_uint(b[j].z), __float_as_uint(b[j].w));
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(acc[j], hi, __float_as_uint(b[j].x), __float_as_uint(b[j].y));
}

// s = x . B over the head dims for one tile: x is this thread's raw A rows
// (load_a_rows), B a tile in kd order with NT n-tiles. s is overwritten.
template <int NT, int PER>
__device__ __forceinline__ void head_product(float (&s)[NT][4], const float (&x)[PER][4], const float4* frag,
                                             int lane) {
  float lo[NT][4] = {};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < PER; ++kk) {
    float4 b[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) b[nt] = lds_frag(&frag[(nt * PER + kk) * 32 + lane]);
    uint32_t hi[4], lw[4];
    split_tf32(x[kk], hi, lw);
    mma_rounds<NT>(s, lo, hi, lw, b);
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] += lo[nt][e];
}

// acc[N0 .. N0 + NH) += A . B for one tile: A from the NT accumulator tiles a
// (a_from_acc), B a tile in kr order with PER n-tiles; the tile's partial in
// fresh registers, added in f32
template <int NT, int PER, int N0, int NH>
__device__ __forceinline__ void tile_product_part(float (&acc)[PER][4], const float (&a)[NT][4], const float4* frag,
                                                  int lane) {
  float part[NH][4] = {}, lo[NH][4] = {};
#pragma unroll
  for (int kc = 0; kc < NT; ++kc) {
    float4 b[NH];
#pragma unroll
    for (int j = 0; j < NH; ++j) b[j] = lds_frag(&frag[(kc * PER + N0 + j) * 32 + lane]);
    uint32_t hi[4], lw[4];
    a_from_acc(a[kc], hi, lw);
    mma_rounds<NH>(part, lo, hi, lw, b);
  }
#pragma unroll
  for (int j = 0; j < NH; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[N0 + j][e] += part[j][e] + lo[j][e];
}

// acc += A . B over all PER n-tiles, in PARTS parts (fewer live registers)
template <int NT, int PER, int PARTS = 2, int N0 = 0>
__device__ __forceinline__ void tile_product(float (&acc)[PER][4], const float (&a)[NT][4], const float4* frag,
                                             int lane) {
  tile_product_part<NT, PER, N0, PER / PARTS>(acc, a, frag, lane);
  if constexpr (N0 + PER / PARTS < PER) tile_product<NT, PER, PARTS, N0 + PER / PARTS>(acc, a, frag, lane);
}

// This thread's A-operand values of rows r0 + g and r0 + g + 8 of a [L, DH]
// operand in device memory (row stride ld), raw f32, k = the head dims:
// x[kk] = {(g, 8kk + t), (g + 8, 8kk + t), (g, 8kk + t + 4), (g + 8, 8kk + t + 4)};
// rows at or past `limit` are zero
template <int DH>
__device__ __forceinline__ void load_a_rows(float (&x)[DH / 8][4], const float* __restrict__ src, long long ld,
                                            int r0, int limit, int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + g + 8 * hh;
    const bool ok = r < limit;
    const float* row = src + (ok ? r : 0) * ld;
#pragma unroll
    for (int kk = 0; kk < DH / 8; ++kk) {
      x[kk][hh] = ok ? row[kk * 8 + t] : 0.f;
      x[kk][2 + hh] = ok ? row[kk * 8 + t + 4] : 0.f;
    }
  }
}

}  // namespace
