// One eval-mode attentional-propagation layer (softmax attention) with its six
// dense products in int8, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel openglue_tpu/ops/pallas/gnn_layer_int8.py::
// _layer_kernel_int8, reached through fused_attention_propagation_int8. For x_q
// [B, N, D], x_kv [B, M, D] (f32 or bf16), D = 128 or 256, H heads of dh = 32 or
// 64, int8 weights [out, in] with f32 per-output-channel scales:
//   quant(x):  dynamic  s_row = absmax_row / 127 + 1e-12, x8 = clip(rint(x / s_row))
//              static   s = act_scales[site],             x8 = clip(rint(x * (1 / s)))
//   dense(x8, W8) = s32(x8 . W8^T) * (s_row * s_col) + bias               (f32)
//   k, v = dense(quant(x_kv));  q = dense(quant(x_q))
//   attention in bf16 as in the softmax layer (q, k, v and P cast to bf16, f32
//   logits, exp and sums), or with quant_attention in int8: q, k, v quantized
//   with one scale per tensor (static) or per batch element (dynamic) as
//   clip(rint(x * (1 / s))); logits = s32(q8 . k8) * (s_q s_k dh^-1/2) + (mask ? 0 :
//   -1e9); p = exp(logits - rowmax) against the FINAL row max; denom = sum p (f32);
//   p8 = rint(p * 127); o = s32(p8 . v8) * (s_v / 127) / denom
//   msg = dense(quant(attn));  cat = [x_q, msg] or [x_q - msg, msg]      (f32)
//   h1 = relu(dense(quant(cat))) * a1 + c1;  out = X(x_q + dense(quant(h1)))
// rint rounds half to even, as jnp.round does. The products are exact integer
// products and every dequantization is written with unfused f32 multiplies and
// adds, so the dense chain gives the same bits as the plain PyTorch version.
//
// What bounds it on the H100: at B=16, N=M=1024, D=256 the dense products are
// 2.1e10 int8 operations (11 us at 1,979 TOP/s) and the attention 1.7e10 (bf16
// or int8); the activations the chain must move (x in, k, v, q, attn, cat8,
// h18, out) are about 110 MB, 33 us at 3.35 TB/s.
//
// Design. Every s8 product is wgmma's m64nNk32 s32.s8.s8 (hopper.cuh) on
// tiles that TMA or the CTA's own threads put in shared memory. A GEMM CTA
// (gemm_s8) is a producer warpgroup (one thread issues TMA) and two consumer
// warpgroups, persistent over 64-row tiles that own WHOLE output rows:
// consumer c takes the columns [c n/2, (c + 1) n/2), so a quantization whose
// row absmax spans the whole row moves into the GEMM that produces or
// consumes it.
//  * The weight stays in shared memory for the CTA's life where it fits
//    (128 KB or less: every product but ffn1 at D=256, whose weight streams
//    in 64-byte k-tiles through a three-stage ring).
//  * A from x_kv, x_q or the attention output is quantized on load: TMA
//    brings the tile's raw rows (32 KB a fill), and the consumers' eight
//    warps reduce each row's absmax over its whole D and write the s8 row
//    into the swizzled A tile, its scale beside it. A from cat8 or h18 comes
//    by TMA with its row scales, a tile ahead (two A slots).
//  * The epilogue runs warp by warp: each warp passes its own 16 rows'
//    sums through shared memory 32 columns at a time, so that a lane
//    dequantizes 16 consecutive columns of one row and stores them at once.
//    The out GEMM forms [x_q - msg, msg] (or [x_q, msg]), the ffn1 GEMM
//    relu(y) a1 + c1; the two consumers exchange their halves' row absmax
//    through shared memory and write only the s8 row and its scale (cat8,
//    h18): no f32 cat or h1 reaches device memory. ffn2 writes x_q + y in
//    x's type.
// What holds the GEMMs back (PERF.md): with one CTA per SM and two
// tiles each at B=16, a tile's quantize, products and epilogue run one
// after the other, and the epilogue takes 3 to 10 times the products.
// Without quant_attention the kv and q epilogues write bf16 q and k|v for the
// softmax layer's bf16 attention (attention.cuh, unchanged). With it, static
// scales make those epilogues write q8, k8 and V^T directly; dynamic ones
// write f32 q, k, v and fold each element's absmax into an atomicMax on the
// float's bits (exact in any order), and one launch quantizes q, k and V^T.
// attention_s8 is the bf16 attention's shape on s8 wgmma: a producer warp
// keeps K and V^T tiles in a ring, two consumer warpgroups of 64 queries,
// persistent over 128-query tiles. The probabilities are quantized against
// the final row max, so the keys are swept twice: q.k^T for the row max,
// then q.k^T again, p, denom and P.V with P in registers as the RS operand.
// The accumulator's key order in a thread is not the register A operand's k
// order for 8-bit types, so V^T is stored with its keys permuted inside each
// block of 32 to match (vt_pos). A layer is 6 launches (int8, int8_static,
// int8_static_attn) or 7 and a memset (int8_attn).

#include <climits>

#include "attention.cuh"

namespace {

constexpr float kEps = 1e-12f;
constexpr float kInv127 = 0.007874015748031496f;  // f32(1 / 127)
constexpr float kMagic = 12582912.f;              // 1.5 * 2^23: integers below 2^22 sit in its mantissa
constexpr int kMagicBits = 0x4B400000;

// clip(rint(y), -127, 127), rounding half to even (as __float2int_rn): the
// clamped value rounded by the f32 add of 1.5 * 2^23
__device__ __forceinline__ int quant(float y) {
  return __float_as_int(__fadd_rn(fminf(fmaxf(y, -127.f), 127.f), kMagic)) - kMagicBits;
}
// an s32 sum below 2^22 in magnitude as f32, exactly (as __int2float_rn)
__device__ __forceinline__ float s32_small(int s) { return __fsub_rn(__int_as_float(s + kMagicBits), kMagic); }
// any s32 as f32, rounded to nearest once (as __int2float_rn): hi 4096 + lo in one fma
__device__ __forceinline__ float s32_any(int s) { return __fmaf_rn(s32_small(s >> 12), 4096.f, s32_small(s & 4095)); }

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (a & 0xff) | ((b & 0xff) << 8) | ((c & 0xff) << 16) | ((d & 0xff) << 24);
}
__device__ __forceinline__ float scale_of(float absmax) { return __fadd_rn(__fdiv_rn(absmax, 127.f), kEps); }

// Where V^T keeps key m: keys are permuted inside each block of 32 so that
// position 16 hf + 4 u + i holds key 16 hf + 8 (i >> 1) + 2 u + (i & 1), the
// key whose probability the register A operand of P.V holds at k index
// 16 hf + 4 u + i (lane t = u holds the accumulator's columns 2u, 2u + 1, 8 +
// 2u, 9 + 2u of each half of 16)
__host__ __device__ __forceinline__ int vt_pos(int m) {
  return (m & ~15) | (((m >> 1) & 3) << 2) | (((m >> 3) & 1) << 1) | (m & 1);
}

// V values of a row from p (16-byte aligned) as f32
template <int V>
__device__ __forceinline__ void load_row(const float* p, float (&v)[V]) {
#pragma unroll
  for (int i = 0; i < V; i += 4) {
    const float4 x = *reinterpret_cast<const float4*>(p + i);
    v[i] = x.x, v[i + 1] = x.y, v[i + 2] = x.z, v[i + 3] = x.w;
  }
}
template <int V>
__device__ __forceinline__ void load_row(const bf16* p, float (&v)[V]) {
  if constexpr (V == 8) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      v[2 * i] = f.x, v[2 * i + 1] = f.y;
    }
  } else {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.y));
    v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
  }
}

// The launches of this library's kernels (which 0) and memsets (which 1),
// counted on the host where each is made; og_gnn_layer_int8_launches reads them
unsigned long long int8_launches[2] = {0, 0};

inline cudaError_t counted(int which) {
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++int8_launches[which];
  return err;
}

// ------------------------------------------------------------------ s8 GEMM

enum S8Epilogue { kBf16 = 0, kF32Absmax = 1, kQuantAttn = 2, kCat8 = 3, kH18 = 4, kResidual = 5 };

constexpr int kRows = 64;        // rows of a tile: one wgmma M
constexpr int kRingK = 64;       // a streamed weight's k-tile: 64 bytes in the 64-byte swizzle
constexpr int kRingStages = 3;
constexpr int kResidentBytes = 131072;  // the largest weight kept in shared memory
constexpr int kRawBytes = 32768;        // the raw rows a tile quantizes on load, per TMA fill

// rint(x / s) clipped to +-127, bit-equal to quant(__fdiv_rn(x, s)) for |x / s|
// <= 127 (a dynamic row scale): x (1 / s) is within 2^-23 |x / s| (1.6e-5) of
// x / s, so it rounds to the same integer unless it lies within 3.2e-5 of a
// half; there the division decides.
__device__ __noinline__ int quant_quotient(float x, float s) { return quant(__fdiv_rn(x, s)); }
__device__ __forceinline__ int quant_div(float x, float s, float inv) {
  const float t = __fmul_rn(x, inv);
  const float f = fabsf(__fsub_rn(t, __fsub_rn(__fadd_rn(t, kMagic), kMagic)));
  int q = quant(t);
  if (f > 0.49996f) q = quant_quotient(x, s);  // rare: a call keeps the division off the common path
  return q;
}

// The rows of a K-wide bf16 or f32 matrix one raw fill holds: 64, or 32 for
// f32 rows of K = 256
__host__ __device__ __forceinline__ int raw_rows_of(int K, int bf16_rows) {
  const int rows = kRawBytes / (K * (bf16_rows ? 2 : 4));
  return rows < kRows ? rows : kRows;
}

constexpr int kDumpLd = 36;  // words per row of a warp's dump rows (32 columns + 4)

// One 32-column chunk c of a warp's s32 sums into its dump rows [16][kDumpLd]
// (entry 4j + e of acc: row g + 8 (e >> 1), column 8 j + 2 t + (e & 1)); the
// chunk is picked at run time, its registers by constant indices
template <int BN>
__device__ __forceinline__ void dump_chunk(const int (&acc)[BN / 2], int c, int* dump, int g, int t) {
#pragma unroll
  for (int cc = 0; cc < BN / 32; ++cc)
    if (cc == c) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * (4 * cc + jj);
        int* const d = dump + g * kDumpLd + 8 * jj + 2 * t;
        *reinterpret_cast<int2*>(d) = make_int2(acc[j], acc[j + 1]);
        *reinterpret_cast<int2*>(d + 8 * kDumpLd) = make_int2(acc[j + 2], acc[j + 3]);
      }
    }
}

__device__ __forceinline__ void lds8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p), b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

// The shared memory of one gemm_s8 instance: the A tile ([K / 128][64 rows]
// [128 bytes], 128-byte swizzle; two slots when TMA fills it, one when the
// consumers quantize it from the raw rows), the raw rows, the weight
// (resident [K / 128][n rows][128 bytes], or the ring's stages of [n rows][64
// bytes]), each consumer's dump tile, consumer 1's V^T staging tile [BN][80]
// (kQuantAttn), the row scales, the row-absmax exchange and the barriers
template <int EPI, bool QA, int BN, int K>
struct S8Tile {
  static constexpr int n_out = 2 * BN;
  static constexpr bool resident = n_out * K <= kResidentBytes;
  static constexpr int a_slots = QA ? 1 : 2;
  static constexpr int a_bytes = kRows * K;
  static constexpr int raw_bytes = QA ? kRawBytes : 0;
  static constexpr int stage_bytes = n_out * kRingK;
  static constexpr int w_bytes = resident ? n_out * K : kRingStages * stage_bytes;
  static constexpr int w_stages = resident ? 1 : kRingStages;
  static constexpr int dump_bytes = kRows * kDumpLd * 4;
  static constexpr int vt_ld = kRows + 16;
  static constexpr int vt_bytes = EPI == kQuantAttn ? BN * vt_ld : 0;
  static constexpr int col_vectors = EPI == kH18 ? 4 : 2;  // column scales, biases (a1, c1)
  static constexpr int x_bytes = EPI == kCat8 ? kRows * n_out * 4 : 0;  // kCat8: the tile's x_q rows (f32 at most)
  static constexpr size_t bytes = 1024 + a_slots * a_bytes + raw_bytes + w_bytes + x_bytes + 2 * dump_bytes +
                                  vt_bytes + col_vectors * n_out * 4 + a_slots * kRows * 4 + 4 * kRows * 4 +
                                  (8 + 2 * w_stages) * 8;
};

struct S8Args {
  int rows, L;                // rows of A and the output; rows per batch element
  const void* xa;             // A quantized on load: [rows, K]
  const float* a_static;      //   its calibrated scale, or null: per-row scales
  const float* a_scale;       // A by TMA (s8 [rows, K]): its row scales
  const float *scol, *bias;   // output columns [0, split): weight scales and biases
  const float *scol2, *bias2; //   [split, n): the second weight's (split 0: one weight)
  int split;
  void* out; int ldo;         // the output; kQuantAttn: consumer 0's
  void* out2;                 // kQuantAttn: consumer 1's (V^T where vt_heads > 0)
  float* out_scale;           // kCat8, kH18: the rows' scales [rows]
  const float* o_static[2];   // calibrated scale of each consumer's output site; null: dynamic
  const void* xq;             // kCat8, kResidual: x_q [rows, n] (kCat8: n = D)
  const float *a1, *c1;       // kH18: the folded BatchNorm
  unsigned* amax[2];          // kF32Absmax: each consumer's per-element absmax (f32 bits)
  int use_offset;
  int vt_heads, Mp;           // kQuantAttn: consumer 1 writes V^T [B, H, dh, Mp]
  int a_bf16, x_bf16;         // xa, and xq and kResidual's out, are bf16 (else f32)
};

// Rows `rows` of the raw tile (TA [rows][K], from tile row r0) quantized into
// the A tile a (16-byte chunk c of row r at chunk c ^ (r % 8) of its 128-byte
// row: the 128-byte swizzle) with their scales in srow. Consumer warp w (0 to
// 7) takes rows w rows / 8 .. ; lane l the K / 32 values from column l K / 32.
template <int K, typename TA>
__device__ __forceinline__ void quantize_raw(const S8Args& p, const TA* raw, int rows, int r0, uint8_t* a, float* srow,
                                             int w, int lane) {
  constexpr int V = K / 32;
  const int k0 = lane * V, per = rows / 8;
  const bool fixed = p.a_static != nullptr;
  const float s_fixed = fixed ? *p.a_static : 0.f, inv_fixed = fixed ? __fdiv_rn(1.f, s_fixed) : 0.f;
  uint8_t* const base = a + (k0 / 128) * (kRows * 128) + k0 % 16;
#pragma unroll 4
  for (int i = 0; i < per; ++i) {
    const int rr = w * per + i, rl = r0 + rr;
    float v[V];
    load_row<V>(raw + rr * K + k0, v);
    int q[V];
    float s = s_fixed;
    if (fixed) {
#pragma unroll
      for (int j = 0; j < V; ++j) q[j] = quant(__fmul_rn(v[j], inv_fixed));
    } else {
      float amax = 0.f;
#pragma unroll
      for (int j = 0; j < V; ++j) amax = fmaxf(amax, fabsf(v[j]));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
      s = scale_of(amax);
      const float inv = __fdiv_rn(1.f, s);
#pragma unroll
      for (int j = 0; j < V; ++j) q[j] = quant_div(v[j], s, inv);
    }
    uint8_t* const dst = base + rl * 128 + ((((k0 % 128) / 16) ^ (rl % 8)) * 16);
    if constexpr (V == 8)
      *reinterpret_cast<uint2*>(dst) = make_uint2(pack4(q[0], q[1], q[2], q[3]), pack4(q[4], q[5], q[6], q[7]));
    else
      *reinterpret_cast<uint32_t*>(dst) = pack4(q[0], q[1], q[2], q[3]);
    if (lane == 0) srow[rl] = s;
  }
}

// out[r, c] = epilogue(s32(A8[r] . W8[c]) * (s_row[r] s_col[c]) + bias[c]) for
// 64-row tiles. QA: the producer brings the tile's raw rows of xa by TMA
// (map_a; 32 KB at a time: 64 bf16 or 32 f32 rows of K = 256) and the
// consumers quantize them; else A is s8 by TMA (map_a).
template <int EPI, bool QA, int BN, int K>
__global__ void __launch_bounds__(384, 1)
    gemm_s8(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_w,
            const __grid_constant__ CUtensorMap map_w2, const __grid_constant__ CUtensorMap map_x, S8Args p) {
  using G = S8Tile<EPI, QA, BN, K>;
  extern __shared__ uint8_t s8_smem[];
  uint8_t* const a_s = s8_smem + ((1024 - (smem_addr(s8_smem) & 1023)) & 1023);
  uint8_t* const w_s = a_s + G::a_slots * G::a_bytes;
  uint8_t* const raw_s = w_s + G::w_bytes;
  uint8_t* const x_s = raw_s + G::raw_bytes;               // kCat8: x_q [64][D]
  uint8_t* const dump_s = x_s + G::x_bytes;                // [warp][16][kDumpLd] s32
  uint8_t* const vt_s = dump_s + 2 * G::dump_bytes;       // consumer 1's V^T staging [BN][vt_ld]
  float* const colv_s = reinterpret_cast<float*>(vt_s + G::vt_bytes);  // [vector][n]
  float* const srow_s = colv_s + G::col_vectors * G::n_out;             // [slot][64]
  float* const xchg = srow_s + G::a_slots * kRows;                         // [tile parity][consumer][64]
  uint64_t* const a_full = reinterpret_cast<uint64_t*>(xchg + 4 * kRows);
  uint64_t* const a_empty = a_full + 2;
  uint64_t* const raw_full = a_empty + 2;
  uint64_t* const raw_empty = raw_full + 1;
  uint64_t* const x_full = raw_empty + 1;
  uint64_t* const x_empty = x_full + 1;
  uint64_t* const w_full = x_empty + 1;
  uint64_t* const w_empty = w_full + G::w_stages;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int tiles = (p.rows + kRows - 1) / kRows;
  // QA: the raw rows per TMA fill (raw_rows_of) and fills per tile
  const int raw_rows = raw_rows_of(K, p.a_bf16), fills = kRows / raw_rows, fill_bytes = raw_rows * K * (p.a_bf16 ? 2 : 4);
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&a_full[i], 128);  // the producer warpgroup's threads
      mbar_init(&a_empty[i], 8);   // the consumers' warps
    }
    mbar_init(raw_full, 1);
    mbar_init(raw_empty, 8);
    mbar_init(x_full, 1);
    mbar_init(x_empty, 8);
    for (int s = 0; s < G::w_stages; ++s) {
      mbar_init(&w_full[s], 1);
      mbar_init(&w_empty[s], 8);
    }
    mbar_fence_init();
  }
  // the output columns' weight scales and biases (and a1, c1), once
  for (int c = threadIdx.x; c < G::n_out; c += blockDim.x) {
    const bool w2 = p.split && c >= p.split;
    colv_s[c] = w2 ? p.scol2[c - p.split] : p.scol[c];
    colv_s[G::n_out + c] = w2 ? p.bias2[c - p.split] : p.bias[c];
    if constexpr (EPI == kH18) {
      colv_s[2 * G::n_out + c] = p.a1[c];
      colv_s[3 * G::n_out + c] = p.c1[c];
    }
  }
  __syncthreads();

  if (wg == 0) {  // the producer warpgroup
    if constexpr (G::resident) {
      // the whole weight, once: boxes of 128 bytes x BN rows of W (rows below
      // the split) or W2
      if (tid == 0) {
        mbar_arrive_tx(&w_full[0], G::w_bytes);
        for (int kb = 0; kb < K / 128; ++kb)
          for (int r0 = 0; r0 < G::n_out; r0 += BN) {
            const bool second = p.split && r0 >= p.split;
            tma_load_2d(w_s + kb * G::n_out * 128 + r0 * 128, second ? &map_w2 : &map_w, &w_full[0], kb * 128,
                        second ? r0 - p.split : r0);
          }
      }
    }
    int slot = 0, stage = 0;
    uint32_t aphase = 0, wphase = 0, rphase = 0, xphase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = tile * kRows;
      if constexpr (QA) {
        if (tid == 0)
          for (int f = 0; f < fills; ++f) {
            mbar_wait(raw_empty, rphase ^ 1);
            mbar_arrive_tx(raw_full, fill_bytes);
            tma_load_2d(raw_s, &map_a, raw_full, 0, m0 + f * raw_rows);
            rphase ^= 1;
          }
        if constexpr (EPI == kCat8) {  // the tile's x_q rows, once the last tile's epilogue is done with them
          if (tid == 0) {
            mbar_wait(x_empty, xphase ^ 1);
            mbar_arrive_tx(x_full, kRows * G::n_out * (p.x_bf16 ? 2 : 4));
            tma_load_2d(x_s, &map_x, x_full, 0, m0);
          }
          xphase ^= 1;
        }
      } else {
        mbar_wait(&a_empty[slot], aphase ^ 1);
        if (tid == 0) {
          mbar_expect_tx(&a_full[slot], G::a_bytes);
          for (int kb = 0; kb < K / 128; ++kb)
            tma_load_2d(a_s + slot * G::a_bytes + kb * kRows * 128, &map_a, &a_full[slot], kb * 128, m0);
        }
        float* const srow = srow_s + slot * kRows;
        if (tid < kRows) srow[tid] = m0 + tid < p.rows ? p.a_scale[m0 + tid] : 0.f;
        mbar_arrive(&a_full[slot]);
        if (++slot == 2) slot = 0, aphase ^= 1;
      }
      if constexpr (!G::resident) {
        // this tile's pass over the weight: k-tiles of 64 bytes x n rows
        if (tid == 0)
          for (int kt = 0; kt < K / kRingK; ++kt) {
            mbar_wait(&w_empty[stage], wphase ^ 1);
            mbar_arrive_tx(&w_full[stage], G::stage_bytes);
            for (int r0 = 0; r0 < G::n_out; r0 += 256)
              tma_load_2d(w_s + stage * G::stage_bytes + r0 * kRingK, &map_w, &w_full[stage], kt * kRingK, r0);
            if (++stage == kRingStages) stage = 0, wphase ^= 1;
          }
      }
    }
    return;
  }

  // a consumer warpgroup: columns [c0, c0 + BN) of every tile
  const int cw = wg - 1, g = lane / 4, t = lane % 4, c0 = cw * BN, hc = 16 * (lane % 2);
  int* const dump_w = reinterpret_cast<int*>(dump_s) + (4 * cw + warp) * 16 * kDumpLd;
  int acc[BN / 2];
  // kResidual: x_q at the lane's columns of every chunk (16 bf16 or f32 each)
  uint4 xr[EPI == kResidual ? BN / 32 : 1][4];
  int slot = 0, stage = 0, par = 0;
  uint32_t aphase = 0, wphase = 0, rphase = 0, xphase = 0;
  if constexpr (G::resident) mbar_wait(&w_full[0], 0);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, par ^= 1) {
    const int m0 = tile * kRows;
    if constexpr (QA) {
      // both consumers are past the last tile's products: A and its scales are free
      named_sync(4, 256);
      for (int f = 0; f < fills; ++f) {
        mbar_wait(raw_full, rphase);
        rphase ^= 1;
        if (p.a_bf16)
          quantize_raw<K>(p, reinterpret_cast<const bf16*>(raw_s), raw_rows, f * raw_rows, a_s, srow_s, 4 * cw + warp, lane);
        else
          quantize_raw<K>(p, reinterpret_cast<const float*>(raw_s), raw_rows, f * raw_rows, a_s, srow_s, 4 * cw + warp, lane);
        __syncwarp();
        if (lane == 0) mbar_arrive(raw_empty);
      }
      fence_async_smem();  // the A tile is read by wgmma
      named_sync(4, 256);  // and is whole
    } else {
      mbar_wait(&a_full[slot], aphase);
    }
    const int rl = 16 * warp + lane / 2, r = m0 + rl;  // the lane's epilogue row
    if constexpr (EPI == kResidual) {  // its x_q, loaded while the products run
      const size_t row = static_cast<size_t>(r < p.rows ? r : 0) * p.ldo + c0 + hc;
#pragma unroll
      for (int c = 0; c < BN / 32; ++c) {
        if (p.x_bf16) {
          const uint4* const x = reinterpret_cast<const uint4*>(static_cast<const bf16*>(p.xq) + row + 32 * c);
          xr[c][0] = x[0], xr[c][1] = x[1];
        } else {
          const uint4* const x = reinterpret_cast<const uint4*>(static_cast<const float*>(p.xq) + row + 32 * c);
          xr[c][0] = x[0], xr[c][1] = x[1], xr[c][2] = x[2], xr[c][3] = x[3];
        }
      }
    }
    const uint32_t a = smem_addr(a_s + slot * G::a_bytes);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    if constexpr (G::resident) {
      const uint32_t w = smem_addr(w_s) + c0 * 128;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < K / 32; ++ks)  // k-step ks: 32 bytes into 128-byte block ks / 4
        wgmma_s8_ss<BN>(acc, kmajor_desc(a + (ks / 4) * kRows * 128 + 32 * (ks % 4), 1024, 128),
                        kmajor_desc(w + (ks / 4) * G::n_out * 128 + 32 * (ks % 4), 1024, 128));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    } else {
      int prev = -1;
      for (int kt = 0; kt < K / kRingK; ++kt) {
        mbar_wait(&w_full[stage], wphase);
        const uint32_t w = smem_addr(w_s + stage * G::stage_bytes) + c0 * kRingK;
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kRingK / 32; ++kk) {
          const int ks = kt * (kRingK / 32) + kk;
          wgmma_s8_ss<BN>(acc, kmajor_desc(a + (ks / 4) * kRows * 128 + 32 * (ks % 4), 1024, 128),
                          kmajor_desc(w + 32 * kk, 8 * kRingK, kRingK));
        }
        wgmma_commit();
        fence_regs(acc);
        wgmma_wait<1>();  // the previous k-tile's products are done
        if (prev >= 0 && lane == 0) mbar_arrive(&w_empty[prev]);
        prev = stage;
        if (++stage == kRingStages) stage = 0, wphase ^= 1;
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(&w_empty[prev]);
    }
    // the scale of the lane's epilogue row, then (TMA A) A's slot is free
    const float su = srow_s[slot * kRows + rl];
    if constexpr (!QA) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&a_empty[slot]);
      if (++slot == 2) slot = 0, aphase ^= 1;
    }

    // ---- the epilogue, warp by warp: warp w owns its accumulator rows 16 w ..
    // 16 w + 15; lane l takes row 16 w + l / 2 and columns 16 (l % 2) .. + 15 of
    // each 32-column chunk, whose s32 sums pass through the warp's own dump
    // rows (dump_chunk picks the chunk's registers), so no barrier joins the
    // warps and each lane's loads and stores are 16 to 64 contiguous bytes
    auto stage_chunk = [&](int c) {
      __syncwarp();  // the warp is done with its dump rows
      dump_chunk<BN>(acc, c, dump_w, g, t);
      __syncwarp();
    };
    auto unit_y = [&](int c, int u, float (&v)[8]) {  // 8 columns of the lane's row
      const int* const d = dump_w + (lane / 2) * kDumpLd + hc + 8 * u;
      const int4 a0 = *reinterpret_cast<const int4*>(d), a1 = *reinterpret_cast<const int4*>(d + 4);
      const int a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const int col = c0 + 32 * c + hc + 8 * u;
      float sc[8], bi[8];
      lds8(colv_s + col, sc);
      lds8(colv_s + G::n_out + col, bi);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float x = K <= 256 ? s32_small(a[i]) : s32_any(a[i]);
        v[i] = __fadd_rn(__fmul_rn(x, __fmul_rn(su, sc[i])), bi[i]);
      }
      if constexpr (EPI == kH18) {  // relu(y) a1 + c1
        float a1[8], c1[8];
        lds8(colv_s + 2 * G::n_out + col, a1);
        lds8(colv_s + 3 * G::n_out + col, c1);
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = __fadd_rn(__fmul_rn(fmaxf(v[i], 0.f), a1[i]), c1[i]);
      }
    };
    auto unit_x = [&](int c, int u, float (&x)[8]) {  // x_q at the same columns (kResidual: prefetched)
      uint4 w0, w1;
      if constexpr (EPI == kResidual) {
        w0 = xr[c][p.x_bf16 ? u : 2 * u];
        w1 = xr[c][2 * u + 1];
      } else {  // kCat8: the tile's x_q rows [64][D] in shared memory, D = 2 BN
        const int at = rl * (2 * BN) + c0 + 32 * c + hc + 8 * u;
        const uint4* const src = p.x_bf16 ? reinterpret_cast<const uint4*>(reinterpret_cast<const bf16*>(x_s) + at)
                                          : reinterpret_cast<const uint4*>(reinterpret_cast<const float*>(x_s) + at);
        w0 = src[0];
        w1 = p.x_bf16 ? w0 : src[1];
      }
      if (p.x_bf16) {
        const uint4 w = w0;
        const uint32_t h[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&h[i]));
          x[2 * i] = f.x, x[2 * i + 1] = f.y;
        }
      } else {
        const uint32_t h[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) x[i] = __uint_as_float(h[i]);
      }
    };
    // kCat8: the first half's value, x_q - msg or x_q
    auto cat_x = [&](float x, float m) { return p.use_offset ? __fsub_rn(x, m) : x; };
    // the chunks in turn: unrolled where x_q sits in registers by chunk
    auto for_chunks = [&](auto&& body) {
      if constexpr (EPI == kResidual) {
#pragma unroll
        for (int c = 0; c < BN / 32; ++c) body(c);
      } else {
#pragma unroll 1
        for (int c = 0; c < BN / 32; ++c) body(c);
      }
    };

    if constexpr (EPI == kCat8) mbar_wait(x_full, xphase);
    // the s8 outputs' row scale: calibrated, or from the whole row's absmax
    // (both consumers' columns: exchanged through shared memory)
    float rs = 0.f, rinv = 0.f;
    const float* const fixed = p.o_static[EPI == kQuantAttn ? cw : 0];
    if constexpr (EPI == kQuantAttn || EPI == kCat8 || EPI == kH18) {
      if (fixed != nullptr) {
        rs = *fixed;
        rinv = __fdiv_rn(1.f, rs);
      } else if constexpr (EPI != kQuantAttn) {
        float am = 0.f;
        for_chunks([&](int c) {
          stage_chunk(c);
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            float v[8], x[8];
            unit_y(c, u, v);
            if constexpr (EPI == kCat8) unit_x(c, u, x);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              am = fmaxf(am, fabsf(v[i]));
              if constexpr (EPI == kCat8) am = fmaxf(am, fabsf(cat_x(x[i], v[i])));
            }
          }
        });
        am = fmaxf(am, __shfl_xor_sync(0xffffffffu, am, 1));
        if (lane % 2 == 0) xchg[(2 * par + cw) * kRows + rl] = am;
        named_sync(3, 256);  // both consumers' halves are in
        rs = scale_of(fmaxf(am, xchg[(2 * par + 1 - cw) * kRows + rl]));
        rinv = __fdiv_rn(1.f, rs);
      }
      if constexpr (EPI != kQuantAttn) {
        if (cw == 0 && lane % 2 == 0 && r < p.rows) p.out_scale[r] = rs;
      }
    }
    auto q8 = [&](float v) { return fixed != nullptr ? quant(__fmul_rn(v, rinv)) : quant_div(v, rs, rinv); };
    const bool transposed = EPI == kQuantAttn && p.vt_heads > 0 && cw == 1;
    float am = 0.f;  // kF32Absmax
    for_chunks([&](int c) {
      stage_chunk(c);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float v[8];
        unit_y(c, u, v);
        if (r >= p.rows && !transposed) continue;
        const int col = c0 + 32 * c + hc + 8 * u;
        const size_t at = static_cast<size_t>(r) * p.ldo + col;
        if constexpr (EPI == kBf16) {
          *reinterpret_cast<uint4*>(static_cast<bf16*>(p.out) + at) =
              make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
        } else if constexpr (EPI == kF32Absmax) {
          float4* const o = reinterpret_cast<float4*>(static_cast<float*>(p.out) + at);
          o[0] = make_float4(v[0], v[1], v[2], v[3]);
          o[1] = make_float4(v[4], v[5], v[6], v[7]);
#pragma unroll
          for (int i = 0; i < 8; ++i) am = fmaxf(am, fabsf(v[i]));
        } else if constexpr (EPI == kResidual) {
          float x[8];
          unit_x(c, u, x);
#pragma unroll
          for (int i = 0; i < 8; ++i) v[i] = __fadd_rn(x[i], v[i]);
          if (p.x_bf16) {
            *reinterpret_cast<uint4*>(static_cast<bf16*>(p.out) + at) =
                make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
          } else {
            float4* const o = reinterpret_cast<float4*>(static_cast<float*>(p.out) + at);
            o[0] = make_float4(v[0], v[1], v[2], v[3]);
            o[1] = make_float4(v[4], v[5], v[6], v[7]);
          }
        } else {
          int q[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) q[i] = q8(v[i]);
          if (transposed) {  // V^T's staging tile [column][row]
#pragma unroll
            for (int i = 0; i < 8; ++i) vt_s[(col - c0 + i) * G::vt_ld + rl] = static_cast<uint8_t>(q[i]);
            continue;
          }
          int8_t* const o = static_cast<int8_t*>(cw == 0 || EPI != kQuantAttn ? p.out : p.out2);
          *reinterpret_cast<uint2*>(o + at + (EPI == kCat8 ? 2 * BN : 0)) =
              make_uint2(pack4(q[0], q[1], q[2], q[3]), pack4(q[4], q[5], q[6], q[7]));
          if constexpr (EPI == kCat8) {  // the first half: x_q - msg (or x_q) at column col
            float x[8];
            unit_x(c, u, x);
#pragma unroll
            for (int i = 0; i < 8; ++i) q[i] = q8(cat_x(x[i], v[i]));
            *reinterpret_cast<uint2*>(o + at) = make_uint2(pack4(q[0], q[1], q[2], q[3]), pack4(q[4], q[5], q[6], q[7]));
          }
        }
      }
    });
    if constexpr (EPI == kCat8) {  // the x_q rows may be refilled
      __syncwarp();
      if (lane == 0) mbar_arrive(x_empty);
      xphase ^= 1;
    }
    if constexpr (EPI == kF32Absmax) {
      // one atomic per warp where its 16 rows lie in one element, else one per row
      am = fmaxf(am, __shfl_xor_sync(0xffffffffu, am, 1));
      const int first = m0 + 16 * warp, last = min(first + 15, p.rows - 1);
      if (first < p.rows) {
        if (first / p.L == last / p.L) {
          float m = am;
#pragma unroll
          for (int o = 2; o < 32; o <<= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
          if (lane == 0) atomicMax(p.amax[cw] + first / p.L, __float_as_uint(m));
        } else if (lane % 2 == 0 && r < p.rows) {
          atomicMax(p.amax[cw] + r / p.L, __float_as_uint(am));
        }
      }
    }
    if constexpr (EPI == kQuantAttn) {
      if (transposed) {
        named_sync(2, 128);  // consumer 1's V^T staging tile is whole
        // V^T [B, H, dh, Mp]: column c of consumer 1 is head c / dh, row c % dh
        const int H = p.vt_heads, dh = BN / H, b0 = m0 / p.L, key0 = m0 - b0 * p.L;
        int8_t* const dst = static_cast<int8_t*>(p.out2);
        if (m0 + kRows <= p.rows && key0 % kRows == 0 && key0 + kRows <= p.L) {
          for (int i = tid; i < BN * 4; i += 128) {  // (column, 16 positions)
            const int c = i / 4, qk = i % 4;
            uint32_t w[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              uint32_t word = 0;
#pragma unroll
              for (int ii = 0; ii < 4; ++ii) {
                const int key = 16 * qk + 8 * (ii >> 1) + 2 * u + (ii & 1);
                word |= static_cast<uint32_t>(vt_s[c * G::vt_ld + key]) << (8 * ii);
              }
              w[u] = word;
            }
            *reinterpret_cast<uint4*>(dst + ((static_cast<size_t>(b0) * H + c / dh) * dh + c % dh) * p.Mp + key0 +
                                      16 * qk) = make_uint4(w[0], w[1], w[2], w[3]);
          }
        } else {  // a tile across elements or ragged: byte by byte, padding keys L .. Mp - 1 with 0
          for (int i = tid; i < BN * kRows; i += 128) {
            const int c = i / kRows, kr = i % kRows, row = m0 + kr;
            if (row >= p.rows) continue;
            const int b = row / p.L, m = row - b * p.L;
            int8_t* const vrow = dst + ((static_cast<size_t>(b) * H + c / dh) * dh + c % dh) * p.Mp;
            vrow[vt_pos(m)] = static_cast<int8_t>(vt_s[c * G::vt_ld + kr]);
            if (m == p.L - 1)
              for (int k = p.L; k < p.Mp; ++k) vrow[vt_pos(k)] = 0;
          }
        }
        named_sync(2, 128);  // the staging tile is free again
      }
    }
  }
}

// A tiled byte map of a [rows, width] matrix with boxes of box_w bytes x box_rows rows
bool matrix_map(CUtensorMap* map, const void* base, int rows, int width, int box_w, int box_rows) {
  const uint64_t dims[2] = {static_cast<uint64_t>(width), static_cast<uint64_t>(rows)};
  const uint64_t strides[1] = {static_cast<uint64_t>(width)};
  const uint32_t box[2] = {static_cast<uint32_t>(box_w), static_cast<uint32_t>(box_rows)};
  return typed_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, base, 2, dims, strides, box, box_w);
}

// p's tiles on min(tiles, SMs) persistent CTAs; a8 the s8 A where !QA; w
// (and w2 from p.split on) the [n, K] weight
template <int EPI, bool QA, int BN, int K>
cudaError_t launch_s8(const S8Args& p, const int8_t* a8, const int8_t* w, const int8_t* w2, cudaStream_t stream) {
  using G = S8Tile<EPI, QA, BN, K>;
  CUtensorMap ma, mw, mw2;
  const int w_rows = p.split ? p.split : G::n_out;
  const bool ok = G::resident ? matrix_map(&mw, w, w_rows, K, 128, BN) &&
                                    (!p.split || matrix_map(&mw2, w2, G::n_out - p.split, K, 128, BN))
                              : matrix_map(&mw, w, G::n_out, K, kRingK, G::n_out < 256 ? G::n_out : 256);
  if (!ok) return cudaErrorInvalidValue;
  if (!p.split) mw2 = mw;
  if (QA) {  // the raw rows, unswizzled
    const uint64_t dims[2] = {K, static_cast<uint64_t>(p.rows)}, strides[1] = {static_cast<uint64_t>(K) * (p.a_bf16 ? 2 : 4)};
    const uint32_t box[2] = {K, static_cast<uint32_t>(raw_rows_of(K, p.a_bf16))};
    if (!typed_map(&ma, p.a_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, p.xa, 2, dims,
                   strides, box, 0))
      return cudaErrorInvalidValue;
  } else if (!matrix_map(&ma, a8, p.rows, K, 128, kRows)) {
    return cudaErrorInvalidValue;
  }
  CUtensorMap mx = mw;
  if (EPI == kCat8) {  // x_q [rows, D], D = 2 BN: 64-row boxes, unswizzled
    const uint64_t dims[2] = {G::n_out, static_cast<uint64_t>(p.rows)};
    const uint64_t strides[1] = {static_cast<uint64_t>(G::n_out) * (p.x_bf16 ? 2 : 4)};
    const uint32_t box[2] = {G::n_out, kRows};
    if (!typed_map(&mx, p.x_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, p.xq, 2, dims,
                   strides, box, 0))
      return cudaErrorInvalidValue;
  }
  auto kernel = gemm_s8<EPI, QA, BN, K>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(G::bytes));
  if (err != cudaSuccess) return err;
  const int tiles = (p.rows + kRows - 1) / kRows;
  kernel<<<tiles < sm_count() ? tiles : sm_count(), 384, G::bytes, stream>>>(ma, mw, mw2, mx, p);
  return counted(0);
}

// ------------------------------------------------------------ s8 attention

constexpr int kSq = 128, kSk = 128, kSStages = 4;  // queries per tile, keys per tile, ring stages

// Shared memory: two Q tiles [128][DH], the ring's stages of a K tile [128
// keys][DH] and a V^T tile [DH][128 keys], their additive masks (f32) and key
// classes (s32), the barriers
template <int DH>
struct S8Attn {
  static constexpr int q_bytes = kSq * DH, k_bytes = kSk * DH, v_bytes = DH * kSk, stage_bytes = k_bytes + v_bytes;
  static constexpr size_t bytes =
      1024 + 2 * q_bytes + kSStages * stage_bytes + 2 * kSStages * kSk * 4 + (4 + 2 * kSStages) * 8;
};

// A key's class in sweep 0, added to its s32 score: 0 valid, kMaskedBias masked,
// kBeyondBias past M. |q8 . k8| < 2^20, so the classes never overlap and the
// largest sum decodes to the row's largest score of the best class present.
constexpr int kMaskedBias = -(1 << 26), kBeyondBias = -(1 << 30);

// the scale of batch element b: the calibrated one, or from its absmax
__device__ __forceinline__ float tensor_scale(const unsigned* absmax, const float* static_scale, int b) {
  return static_scale != nullptr ? *static_scale : scale_of(__uint_as_float(absmax[b]));
}

// S = Q K^T (s8 tiles at shared addresses q, k; rows of DH bytes) into s, complete
template <int DH>
__device__ __forceinline__ void s8_scores(int (&s)[64], uint32_t q, uint32_t k) {
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0;
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DH / 32; ++kk)
    wgmma_s8_ss_n128(s, kmajor_desc(q + 32 * kk, 8 * DH, DH), kmajor_desc(k + 32 * kk, 8 * DH, DH));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
}

// A producer warp and two consumer warpgroups of 64 queries, persistent over
// 128-query tiles of one (element, head). Sweep 0 finds each row's max logit;
// sweep 1 recomputes the logits and accumulates denom and the s8 P.V against
// that max. q8, k8 [B, N or M, D]; vt8 [B, H, DH, Mp] (keys permuted, vt_pos);
// absmax [k, v, q][B] (dynamic) or act_scales (static: sites 5, 6, 7 are k, v, q);
// out f32 [B, N, D].
template <int DH>
__global__ void __launch_bounds__(384, 1)
    attention_s8(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v, const uint8_t* __restrict__ mask,
                 const unsigned* __restrict__ absmax, const float* __restrict__ act_scales,
                 float* __restrict__ out, int B, int H, int N, int M) {
  using S = S8Attn<DH>;
  extern __shared__ uint8_t s8a_smem[];
  uint8_t* const qs = s8a_smem + ((1024 - (smem_addr(s8a_smem) & 1023)) & 1023);
  uint8_t* const ring = qs + 2 * S::q_bytes;  // stage s: K at s * stage_bytes, V^T k_bytes on
  float* const madd = reinterpret_cast<float*>(ring + kSStages * S::stage_bytes);  // [stage][kSk]
  int* const kclass = reinterpret_cast<int*>(madd + kSStages * kSk);                // [stage][kSk]
  uint64_t* const q_full = reinterpret_cast<uint64_t*>(kclass + kSStages * kSk);
  uint64_t* const q_empty = q_full + 2;
  uint64_t* const full = q_empty + 2;
  uint64_t* const empty = full + kSStages;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int qblocks = (N + kSq - 1) / kSq, tiles = qblocks * H * B, ktiles = (M + kSk - 1) / kSk, D = H * DH;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], 8);
    }
    for (int s = 0; s < kSStages; ++s) {
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
      const int n0 = tile % qblocks * kSq, h = tile / qblocks % H, b = tile / qblocks / H;
      if (lane == 0) {
        mbar_wait(&q_empty[qbuf], qphase ^ 1);
        mbar_arrive_tx(&q_full[qbuf], S::q_bytes);
        tma_load_4d(qs + qbuf * S::q_bytes, &map_q, &q_full[qbuf], 0, n0, h, b);
      }
      if (++qbuf == 2) qbuf = 0, qphase ^= 1;
      for (int sweep = 0; sweep < 2; ++sweep)
        for (int kt = 0; kt < ktiles; ++kt) {
          const int k0 = kt * kSk;
          mbar_wait(&empty[stage], phase ^ 1);
          uint8_t* const st = ring + stage * S::stage_bytes;
          if (lane == 0) {
            mbar_expect_tx(&full[stage], S::k_bytes + (sweep ? S::v_bytes : 0));
            tma_load_4d(st, &map_k, &full[stage], 0, k0, h, b);
            if (sweep) tma_load_4d(st + S::k_bytes, &map_v, &full[stage], k0, 0, h, b);
          }
#pragma unroll
          for (int j = 0; j < kSk / 32; ++j) {
            const float m = mask_add(mask, b, M, k0 + lane + 32 * j);
            madd[stage * kSk + lane + 32 * j] = m;
            kclass[stage * kSk + lane + 32 * j] = m == 0.f ? 0 : m == kMasked ? kMaskedBias : kBeyondBias;
          }
          mbar_arrive(&full[stage]);
          if (++stage == kSStages) stage = 0, phase ^= 1;
        }
    }
    return;
  }

  // a consumer warpgroup: query rows [64 cw, 64 cw + 64) of each tile
  regs_acquire<240>();
  const int cw = wg - 1, g = lane / 4, t = lane % 4;
  int s[64], o[DH / 2];
  int stage = 0, qbuf = 0;
  uint32_t phase = 0, qphase = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int n0 = tile % qblocks * kSq, h = tile / qblocks % H, b = tile / qblocks / H;
    const float s_k = tensor_scale(absmax, act_scales ? act_scales + 5 : nullptr, b);
    const float s_v = tensor_scale(absmax ? absmax + B : nullptr, act_scales ? act_scales + 6 : nullptr, b);
    const float s_q = tensor_scale(absmax ? absmax + 2 * B : nullptr, act_scales ? act_scales + 7 : nullptr, b);
    const float logit_scale = __fmul_rn(__fmul_rn(s_q, s_k), Head<DH>::scale);
    const float out_scale = __fmul_rn(s_v, kInv127);
    mbar_wait(&q_full[qbuf], qphase);
    const uint32_t q_addr = smem_addr(qs + qbuf * S::q_bytes + cw * 64 * DH);
    float row_max[2], row_sum[2] = {0.f, 0.f};
    int best[2] = {INT_MIN, INT_MIN};  // sweep 0: the largest score + class of each row
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] = 0;
    for (int sweep = 0; sweep < 2; ++sweep) {
      for (int kt = 0; kt < ktiles; ++kt) {
        mbar_wait(&full[stage], phase);
        const uint8_t* const st = ring + stage * S::stage_bytes;
        const float* const ma = madd + stage * kSk;
        s8_scores<DH>(s, q_addr, smem_addr(st));
        if (sweep == 0) {
          const int* const kc = kclass + stage * kSk;
#pragma unroll
          for (int j = 0; j < 16; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) best[e >> 1] = max(best[e >> 1], s[4 * j + e] + kc[8 * j + 2 * t + (e & 1)]);
        } else {
          // p, the row sums and p8 = rint(p 127), in place of the scores
#pragma unroll
          for (int j = 0; j < 16; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float logit = __fadd_rn(__fmul_rn(s32_small(s[4 * j + e]), logit_scale), ma[8 * j + 2 * t + (e & 1)]);
              const float pe = expf(logit - row_max[e >> 1]);
              row_sum[e >> 1] += pe;
              // rint(p 127) in the low byte (the add of 1.5 * 2^23 leaves it there)
              s[4 * j + e] = __float_as_int(__fadd_rn(__fmul_rn(pe, 127.f), kMagic));
            }
          // P's register A fragments, one per 32 keys: k index 4t + i of
          // each half of 16 holds the thread's own columns (vt_pos)
          uint32_t pa[4][4];
#pragma unroll
          for (int kc = 0; kc < 4; ++kc) {
            const int j = 4 * kc;
            pa[kc][0] = pack4(s[4 * j], s[4 * j + 1], s[4 * j + 4], s[4 * j + 5]);
            pa[kc][1] = pack4(s[4 * j + 2], s[4 * j + 3], s[4 * j + 6], s[4 * j + 7]);
            pa[kc][2] = pack4(s[4 * j + 8], s[4 * j + 9], s[4 * j + 12], s[4 * j + 13]);
            pa[kc][3] = pack4(s[4 * j + 10], s[4 * j + 11], s[4 * j + 14], s[4 * j + 15]);
          }
          const uint32_t v_addr = smem_addr(st + S::k_bytes);
          fence_regs(o);
          wgmma_fence();
#pragma unroll
          for (int kc = 0; kc < 4; ++kc) wgmma_s8_pv<DH>(o, pa[kc], kmajor_desc(v_addr + 32 * kc, 1024, 128));
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(o);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[stage]);
        if (++stage == kSStages) stage = 0, phase ^= 1;
      }
      if (sweep == 0) {
        // the row max logit: the logit is monotonic in the score within a
        // class, so it is the logit of the best class's largest score (a
        // masked key's logit, near -1e9, only where no key is valid)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          best[hh] = max(best[hh], __shfl_xor_sync(0xffffffffu, best[hh], 1));
          best[hh] = max(best[hh], __shfl_xor_sync(0xffffffffu, best[hh], 2));
          if (best[hh] > kMaskedBias / 2)
            row_max[hh] = __fadd_rn(__fmul_rn(s32_small(best[hh]), logit_scale), 0.f);
          else
            row_max[hh] = __fadd_rn(__fmul_rn(s32_small(best[hh] - kMaskedBias), logit_scale), kMasked);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&q_empty[qbuf]);
    if (++qbuf == 2) qbuf = 0, qphase ^= 1;

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      row_sum[hh] += __shfl_xor_sync(0xffffffffu, row_sum[hh], 1);
      row_sum[hh] += __shfl_xor_sync(0xffffffffu, row_sum[hh], 2);
    }
    float* const ob = out + static_cast<size_t>(b) * N * D + h * DH;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = n0 + 64 * cw + 16 * warp + g + 8 * hh;
      if (r < N) {
#pragma unroll
        for (int j = 0; j < DH / 8; ++j)
          store2(ob + static_cast<size_t>(r) * D + 8 * j + 2 * t,
                 __fmul_rn(s32_any(o[4 * j + 2 * hh]), out_scale) / row_sum[hh],
                 __fmul_rn(s32_any(o[4 * j + 2 * hh + 1]), out_scale) / row_sum[hh]);
      }
    }
  }
}

// The byte map of an s8 [B, H, L, DH] head operand of a [B, L, D] buffer, or
// of V^T [B, H, DH, Mp] (transposed): boxes of 128 rows (keys) of one head
template <int DH>
bool s8_head_map(CUtensorMap* map, const int8_t* base, int B, int H, int L, bool transposed) {
  const int D = H * DH;
  if (transposed) {
    const uint64_t dims[4] = {static_cast<uint64_t>(L), DH, static_cast<uint64_t>(H), static_cast<uint64_t>(B)};
    const uint64_t strides[3] = {static_cast<uint64_t>(L), static_cast<uint64_t>(DH) * L,
                                 static_cast<uint64_t>(D) * L};
    const uint32_t box[4] = {kSk, DH, 1, 1};
    return typed_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, base, 4, dims, strides, box, 128);
  }
  const uint64_t dims[4] = {DH, static_cast<uint64_t>(L), static_cast<uint64_t>(H), static_cast<uint64_t>(B)};
  const uint64_t strides[3] = {static_cast<uint64_t>(D), DH, static_cast<uint64_t>(L) * D};
  const uint32_t box[4] = {DH, kSq, 1, 1};
  return typed_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, base, 4, dims, strides, box, DH);
}

template <int DH>
cudaError_t launch_attention_s8(const int8_t* q8, const int8_t* k8, const int8_t* vt8, const uint8_t* mask,
                                const unsigned* absmax, const float* act, float* out, int B, int N, int M, int Mp,
                                int H, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  if (!s8_head_map<DH>(&mq, q8, B, H, N, false) || !s8_head_map<DH>(&mk, k8, B, H, M, false) ||
      !s8_head_map<DH>(&mv, vt8, B, H, Mp, true))
    return cudaErrorInvalidValue;
  const size_t smem = S8Attn<DH>::bytes;
  const cudaError_t err =
      cudaFuncSetAttribute(attention_s8<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int tiles = (N + kSq - 1) / kSq * H * B;
  attention_s8<DH><<<tiles < sm_count() ? tiles : sm_count(), 384, smem, stream>>>(mq, mk, mv, mask, absmax, act,
                                                                                  out, B, H, N, M);
  return counted(0);
}

// ------------------------------------------- dynamic per-element quantization

// q, k and V^T of the dynamic int8 attention, with each element's scale from
// its absmax: blocks [0, vt_blocks) each quantize one 64-key tile of one head
// of v (kvf's columns D ..) into V^T [B, H, DH, Mp] (keys permuted by vt_pos,
// 0 from M on); the others k8 (kvf's columns 0 .. D - 1) and q8, 16 values at
// a time. clip(rint(x * (1 / s))).
template <int DH>
__global__ void __launch_bounds__(256)
    quant_qkv_kernel(const float* __restrict__ kvf, const float* __restrict__ qf, const unsigned* __restrict__ absmax,
                     int B, int N, int M, int Mp, int H, int8_t* __restrict__ k8, int8_t* __restrict__ q8,
                     int8_t* __restrict__ vt8) {
  const int D = H * DH, mtiles = Mp / 64, vt_blocks = B * H * mtiles;
  if (static_cast<int>(blockIdx.x) < vt_blocks) {
    __shared__ __align__(16) int8_t tile[DH][64 + 16];  // [d][position]
    const int kt = blockIdx.x % mtiles, h = blockIdx.x / mtiles % H, b = blockIdx.x / mtiles / H;
    const float inv = __fdiv_rn(1.f, scale_of(__uint_as_float(absmax[B + b])));
    for (int i = threadIdx.x; i < 64 * DH; i += 256) {
      const int kl = i / DH, d = i % DH, m = kt * 64 + kl;
      int q = 0;
      if (m < M) q = quant(__fmul_rn(kvf[(static_cast<size_t>(b) * M + m) * 2 * D + D + h * DH + d], inv));
      tile[d][vt_pos(kl)] = static_cast<int8_t>(q);
    }
    __syncthreads();
    const int d = threadIdx.x / 4, c = (threadIdx.x % 4) * 16;
    if (d < DH)
      *reinterpret_cast<uint4*>(vt8 + ((static_cast<size_t>(b) * H + h) * DH + d) * Mp + kt * 64 + c) =
          *reinterpret_cast<const uint4*>(&tile[d][c]);
    return;
  }
  const size_t kchunks = static_cast<size_t>(B) * M * D / 16, chunks = kchunks + static_cast<size_t>(B) * N * D / 16;
  const size_t stride = static_cast<size_t>(gridDim.x - vt_blocks) * 256;
  for (size_t i = (blockIdx.x - vt_blocks) * 256 + threadIdx.x; i < chunks; i += stride) {
    const bool is_k = i < kchunks;
    const size_t e = (is_k ? i : i - kchunks) * 16, row = e / D, col = e % D;
    const int b = static_cast<int>(row / (is_k ? M : N));
    const float inv = __fdiv_rn(1.f, scale_of(__uint_as_float(absmax[(is_k ? 0 : 2 * B) + b])));
    const float* const src = is_k ? kvf + row * 2 * D + col : qf + row * D + col;
    uint32_t w[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4 v = *reinterpret_cast<const float4*>(src + 4 * u);
      w[u] = pack4(quant(__fmul_rn(v.x, inv)), quant(__fmul_rn(v.y, inv)), quant(__fmul_rn(v.z, inv)),
                   quant(__fmul_rn(v.w, inv)));
    }
    *reinterpret_cast<uint4*>((is_k ? k8 : q8) + e) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// ---------------------------------------------------------------- the layer

inline int keys_padded(int M) { return (M + 63) / 64 * 64; }

struct Buffers {
  int8_t *cat8, *h18, *q8, *k8, *vt8;
  float *scat, *sh1, *attn, *kvf, *qf;
  bf16 *kvb, *qb;
  unsigned* absmax;
};

// The workspace: the attention output, cat8 and h18 with their row scales;
// bf16 q and k|v for the bf16 attention; q8, k8 and V^T for the s8 one, with
// f32 q, k|v and the absmax where its scales are dynamic.
Buffers carve(Carve& ws, int B, int N, int M, int D, int quant_attention, int is_static) {
  const size_t rq = static_cast<size_t>(B) * N, rk = static_cast<size_t>(B) * M;
  Buffers p = {};
  p.attn = ws.take<float>(rq * D);
  p.cat8 = ws.take<int8_t>(rq * 2 * D);
  p.scat = ws.take<float>(rq);
  p.h18 = ws.take<int8_t>(rq * 2 * D);
  p.sh1 = ws.take<float>(rq);
  if (!quant_attention) {
    p.kvb = ws.take<bf16>(rk * 2 * D);
    p.qb = ws.take<bf16>(rq * D);
    return p;
  }
  p.q8 = ws.take<int8_t>(rq * D);
  p.k8 = ws.take<int8_t>(rk * D);
  p.vt8 = ws.take<int8_t>(static_cast<size_t>(B) * D * keys_padded(M));  // [B, H, dh, Mp]
  if (!is_static) {
    p.kvf = ws.take<float>(rk * 2 * D);
    p.qf = ws.take<float>(rq * D);
    p.absmax = ws.take<unsigned>(3 * static_cast<size_t>(B));
  }
  return p;
}

template <typename TX, int D>
cudaError_t layer_of_width(int B, int N, int M, int H, int quant_attention, int use_offset, const TX* xq,
                           const TX* xkv, const uint8_t* mask, const float* act, const int8_t* const* w,
                           const float* const* f, void* ws_, void* out, cudaStream_t s) {
  const int8_t *wq = w[0], *wk = w[1], *wv = w[2], *wo = w[3], *w1 = w[4], *w2 = w[5];
  const float *sq = f[0], *bq = f[1], *sk = f[2], *bk = f[3], *sv = f[4], *bv = f[5], *so = f[6], *bo = f[7],
              *s1 = f[8], *b1 = f[9], *a1 = f[10], *c1 = f[11], *s2 = f[12], *b2 = f[13];
  const bool is_static = act != nullptr;
  Carve ws{static_cast<char*>(ws_)};
  const Buffers p = carve(ws, B, N, M, D, quant_attention, is_static);
  const int nq = B * N, nk = B * M, mp = keys_padded(M);
  // the calibrated scale of a site, or null for a dynamic one
  auto site = [&](int i) { return is_static ? act + i : nullptr; };
  cudaError_t err;

  constexpr int xb = std::is_same<TX, bf16>::value;
  S8Args kv = {};
  kv.rows = nk, kv.L = M, kv.xa = xkv, kv.a_static = site(0), kv.a_bf16 = xb;
  kv.scol = sk, kv.bias = bk, kv.scol2 = sv, kv.bias2 = bv, kv.split = D;
  S8Args q = {};
  q.rows = nq, q.L = N, q.xa = xq, q.a_static = site(1), q.scol = sq, q.bias = bq, q.a_bf16 = xb;
  if (!quant_attention) {
    kv.out = p.kvb, kv.ldo = 2 * D;
    q.out = p.qb, q.ldo = D;
    if ((err = launch_s8<kBf16, true, D, D>(kv, nullptr, wk, wv, s))) return err;
    if ((err = launch_s8<kBf16, true, D / 2, D>(q, nullptr, wq, wq, s))) return err;
    if ((err = attention<bf16, float>(p.qb, p.kvb, p.kvb + D, mask, p.attn, nullptr, B, N, M, D, H, D, 2 * D, s)))
      return err;
    ++int8_launches[0];
  } else if (is_static) {
    kv.out = p.k8, kv.ldo = D, kv.out2 = p.vt8, kv.o_static[0] = site(5), kv.o_static[1] = site(6);
    kv.vt_heads = H, kv.Mp = mp;
    q.out = q.out2 = p.q8, q.ldo = D, q.o_static[0] = q.o_static[1] = site(7);
    if ((err = launch_s8<kQuantAttn, true, D, D>(kv, nullptr, wk, wv, s))) return err;
    if ((err = launch_s8<kQuantAttn, true, D / 2, D>(q, nullptr, wq, wq, s))) return err;
  } else {
    if ((err = cudaMemsetAsync(p.absmax, 0, 3 * static_cast<size_t>(B) * sizeof(unsigned), s))) return err;
    ++int8_launches[1];
    kv.out = p.kvf, kv.ldo = 2 * D, kv.amax[0] = p.absmax, kv.amax[1] = p.absmax + B;
    q.out = p.qf, q.ldo = D, q.amax[0] = q.amax[1] = p.absmax + 2 * B;
    if ((err = launch_s8<kF32Absmax, true, D, D>(kv, nullptr, wk, wv, s))) return err;
    if ((err = launch_s8<kF32Absmax, true, D / 2, D>(q, nullptr, wq, wq, s))) return err;
  }
  if (quant_attention) {
    if ((err = with_head_width(D / H, [&](auto width) -> cudaError_t {
          constexpr int DH = decltype(width)::value;
          if (!is_static) {
            const int blocks = B * H * (mp / 64) + 4 * sm_count();
            quant_qkv_kernel<DH><<<blocks, 256, 0, s>>>(p.kvf, p.qf, p.absmax, B, N, M, mp, H, p.k8, p.q8, p.vt8);
            const cudaError_t launched = counted(0);
            if (launched != cudaSuccess) return launched;
          }
          return launch_attention_s8<DH>(p.q8, p.k8, p.vt8, mask, p.absmax, act, p.attn, B, N, M, mp, H, s);
        })))
      return err;
  }

  S8Args o = {};
  o.rows = nq, o.L = N, o.xa = p.attn, o.a_static = site(2), o.scol = so, o.bias = bo;
  o.out = p.cat8, o.ldo = 2 * D, o.out_scale = p.scat, o.o_static[0] = site(3), o.xq = xq, o.use_offset = use_offset;
  o.x_bf16 = xb;
  if ((err = launch_s8<kCat8, true, D / 2, D>(o, nullptr, wo, wo, s))) return err;
  S8Args h = {};
  h.rows = nq, h.L = N, h.a_scale = p.scat, h.scol = s1, h.bias = b1, h.a1 = a1, h.c1 = c1;
  h.out = p.h18, h.ldo = 2 * D, h.out_scale = p.sh1, h.o_static[0] = site(4);
  if ((err = launch_s8<kH18, false, D, 2 * D>(h, p.cat8, w1, w1, s))) return err;
  S8Args r = {};
  r.rows = nq, r.L = N, r.a_scale = p.sh1, r.scol = s2, r.bias = b2, r.out = out, r.ldo = D, r.xq = xq, r.x_bf16 = xb;
  return launch_s8<kResidual, false, D / 2, 2 * D>(r, p.h18, w2, w2, s);
}

template <typename TX>
cudaError_t layer(int B, int N, int M, int D, int H, int quant_attention, int use_offset, const void* xq,
                  const void* xkv, const void* mask, const float* act, const void* const* w, const float* const* f,
                  void* ws, void* out, cudaStream_t s) {
  const int8_t* const* w8 = reinterpret_cast<const int8_t* const*>(w);
  const TX *q = static_cast<const TX*>(xq), *kv = static_cast<const TX*>(xkv);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  if (D == 256) return layer_of_width<TX, 256>(B, N, M, H, quant_attention, use_offset, q, kv, m, act, w8, f, ws, out, s);
  return layer_of_width<TX, 128>(B, N, M, H, quant_attention, use_offset, q, kv, m, act, w8, f, ws, out, s);
}

bool shape_ok(int D, int H, int M) { return (D == 128 || D == 256) && head_width_ok(D, H) && M > 0; }

// ------------------------------------------------ the descriptor probe

// out [64, N] s32 = a [64, K] s8 . b [N, K]^T, both loaded by TMA in the
// swizzle of their K-byte rows (K = 64 or 128) and multiplied by one
// warpgroup's s8 wgmma: the descriptors of the layer's GEMMs, alone
template <int N>
__global__ void __launch_bounds__(128) s8_probe_kernel(const __grid_constant__ CUtensorMap map_a,
                                                       const __grid_constant__ CUtensorMap map_b, int K, int* out) {
  extern __shared__ uint8_t probe_smem[];
  uint8_t* const a = probe_smem + ((1024 - (smem_addr(probe_smem) & 1023)) & 1023);
  uint8_t* const b = a + 64 * 128;
  __shared__ uint64_t bar;
  if (threadIdx.x == 0) {
    mbar_init(&bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_tx(&bar, (64 + N) * K);
    tma_load_2d(a, &map_a, &bar, 0, 0);
    tma_load_2d(b, &map_b, &bar, 0, 0);
  }
  mbar_wait(&bar, 0);
  int acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0;
  fence_regs(acc);
  wgmma_fence();
  for (int ks = 0; ks < K / 32; ++ks)
    wgmma_s8_ss<N>(acc, kmajor_desc(smem_addr(a) + 32 * ks, 8 * K, K), kmajor_desc(smem_addr(b) + 32 * ks, 8 * K, K));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  const int warp = threadIdx.x / 32, g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) out[(16 * warp + g + 8 * (e >> 1)) * N + 8 * j + 2 * t + (e & 1)] = acc[4 * j + e];
}

}  // namespace

// Bytes of workspace og_gnn_layer_int8 needs.
extern "C" size_t og_gnn_layer_int8_workspace(int x_is_bf16, int B, int N, int M, int D, int H,
                                              int quant_attention, int is_static) {
  (void)x_is_bf16;
  (void)H;
  Carve ws{nullptr};
  carve(ws, B, N, M, D, quant_attention, is_static);
  return ws.used;
}

// The layer's plan on the current card: out [13] = kernel launches per layer,
// memsets per layer, rows per GEMM tile, GEMM CTAs over the key rows and over
// the query rows, attention CTAs, shared-memory bytes of the kv, q, out, ffn1
// and ffn2 GEMMs and of the attention, and the SM count. Returns a CUDA error
// code (cudaErrorInvalidValue for a shape the layer refuses).
extern "C" int og_gnn_layer_int8_plan(int x_is_bf16, int B, int N, int M, int D, int H, int quant_attention,
                                      int is_static, int* out) {
  (void)x_is_bf16;
  if (!shape_ok(D, H, M)) return cudaErrorInvalidValue;
  const int sms = sm_count(), dh = D / H;
  auto ctas = [&](long long rows) {
    const long long tiles = (rows + kRows - 1) / kRows;
    return static_cast<int>(tiles < sms ? tiles : sms);
  };
  const long long attn_tiles = static_cast<long long>((N + kSq - 1) / kSq) * H * B;
  size_t smem[6];
  const bool qs = quant_attention && is_static, qd = quant_attention && !is_static;
  if (D == 256) {
    smem[0] = qs ? S8Tile<kQuantAttn, true, 256, 256>::bytes : qd ? S8Tile<kF32Absmax, true, 256, 256>::bytes
                                                                : S8Tile<kBf16, true, 256, 256>::bytes;
    smem[1] = qs ? S8Tile<kQuantAttn, true, 128, 256>::bytes : qd ? S8Tile<kF32Absmax, true, 128, 256>::bytes
                                                                : S8Tile<kBf16, true, 128, 256>::bytes;
    smem[2] = S8Tile<kCat8, true, 128, 256>::bytes, smem[3] = S8Tile<kH18, false, 256, 512>::bytes;
    smem[4] = S8Tile<kResidual, false, 128, 512>::bytes;
  } else {
    smem[0] = qs ? S8Tile<kQuantAttn, true, 128, 128>::bytes : qd ? S8Tile<kF32Absmax, true, 128, 128>::bytes
                                                                : S8Tile<kBf16, true, 128, 128>::bytes;
    smem[1] = qs ? S8Tile<kQuantAttn, true, 64, 128>::bytes : qd ? S8Tile<kF32Absmax, true, 64, 128>::bytes
                                                               : S8Tile<kBf16, true, 64, 128>::bytes;
    smem[2] = S8Tile<kCat8, true, 64, 128>::bytes, smem[3] = S8Tile<kH18, false, 128, 256>::bytes;
    smem[4] = S8Tile<kResidual, false, 64, 256>::bytes;
  }
  if (quant_attention) smem[5] = dh == 64 ? S8Attn<64>::bytes : S8Attn<32>::bytes;
  else smem[5] = dh == 64 ? Bf16Attn<64>::bytes : Bf16Attn<32>::bytes;
  const long long bf16_tiles = static_cast<long long>((N + kHq - 1) / kHq) * H * B;
  const long long a_tiles = quant_attention ? attn_tiles : bf16_tiles;
  const int v[13] = {qd ? 7 : 6, qd ? 1 : 0, kRows, ctas(static_cast<long long>(B) * M), ctas(static_cast<long long>(B) * N),
                     static_cast<int>(a_tiles < sms ? a_tiles : sms), static_cast<int>(smem[0]),
                     static_cast<int>(smem[1]), static_cast<int>(smem[2]), static_cast<int>(smem[3]),
                     static_cast<int>(smem[4]), static_cast<int>(smem[5]), sms};
  for (int i = 0; i < 13; ++i) out[i] = v[i];
  return cudaSuccess;
}

// The kernel launches (which 0) or memsets (which 1) this library has made
// since it was loaded or since that count was last reset; with reset, sets the
// count to 0 after reading it.
extern "C" unsigned long long og_gnn_layer_int8_launches(int which, int reset) {
  if (which < 0 || which > 1) return 0;
  const unsigned long long launches = int8_launches[which];
  if (reset) int8_launches[which] = 0;
  return launches;
}

// out [64, N] s32 = a [64, K] . b [N, K]^T (s8, K = 64 or 128, N = 64, 128 or
// 256) through the s8 wgmma and the swizzled descriptors the layer uses.
extern "C" int og_s8_wgmma_probe(const void* a, const void* b, int N, int K, void* out, void* stream) {
  if ((K != 64 && K != 128) || (N != 64 && N != 128 && N != 256)) return cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  if (!matrix_map(&ma, a, 64, K, K, 64) || !matrix_map(&mb, b, N, K, K, N)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = 1024 + (64 + N) * 128;
  auto run = [&](auto kernel) -> cudaError_t {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    kernel<<<1, 128, smem, s>>>(ma, mb, K, static_cast<int*>(out));
    return cudaGetLastError();
  };
  if (N == 64) return run(s8_probe_kernel<64>);
  if (N == 128) return run(s8_probe_kernel<128>);
  return run(s8_probe_kernel<256>);
}

// One layer. x_is_bf16 selects the type X of x_q, x_kv and out (else f32).
// act_scales: null for dynamic quantization, else f32 [5] (kv, xq, attn, cat,
// h1) or, with quant_attention, [8] (+ k, v, q of the attention). weights (s8,
// [out, in]): wq, wk, wv, wo [D, D], w1 [2D, 2D], w2 [D, 2D]. f32 vectors: sq,
// bq, sk, bk, sv, bv, so, bo [D], s1, b1, a1, c1 [2D], s2, b2 [D]. mask: [B, M]
// uint8 or null. D = 128 or 256, = dh * H with dh 32 or 64. Every pointer is
// 16-byte aligned (TMA).
// Returns the CUDA error code of the launches (0 on success).
extern "C" int og_gnn_layer_int8(int x_is_bf16, int B, int N, int M, int D, int H,
                                 int quant_attention, int use_offset, const void* xq,
                                 const void* xkv, const void* mask, const void* act_scales,
                                 const void* const* weights, const void* const* vectors,
                                 void* workspace, void* out, void* stream) {
  if (B == 0 || N == 0) return cudaSuccess;
  if (!shape_ok(D, H, M)) return cudaErrorInvalidValue;
  const float* const* f = reinterpret_cast<const float* const*>(vectors);
  const float* act = static_cast<const float*>(act_scales);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    return layer<bf16>(B, N, M, D, H, quant_attention, use_offset, xq, xkv, mask, act, weights, f, workspace, out, s);
  return layer<float>(B, N, M, D, H, quant_attention, use_offset, xq, xkv, mask, act, weights, f, workspace, out, s);
}
