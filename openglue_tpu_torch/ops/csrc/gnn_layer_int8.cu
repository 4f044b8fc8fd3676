// One eval-mode attentional-propagation layer (softmax attention) with its six
// dense products in int8, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel openglue_tpu/ops/pallas/gnn_layer_int8.py::
// _layer_kernel_int8, reached through fused_attention_propagation_int8. For x_q
// [B, N, D], x_kv [B, M, D] (f32 or bf16), H heads of dh = 32 or 64, int8 weights
// [out, in] with f32 per-output-channel scales:
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
// 2.1e10 int8 operations and the attention 1.7e10 (bf16 or int8) against 25 MB of
// activations in and out: operations bound it.
//
// Design. The row absmax of a quantization site is a reduction over the
// producer's whole output row (256 or 512 wide), which a GEMM epilogue that owns
// one column tile cannot see, so a small quantize pass sits between the GEMMs:
// a warp per row reads the f32 row, reduces |x|, writes the s8 row and its
// scale. The GEMM is mma.sync m16n8k32 s8 -> s32 with cp.async double buffering
// (the bf16 GEMM's tiling: an s8 k-tile of 64 bytes has the shared-memory
// geometry of a bf16 k-tile of 32) and f32 epilogues (dequantize; concat;
// ReLU and folded BatchNorm; residual). Without quant_attention the attention
// is the softmax layer's flash kernel, writing f32. With it, the probabilities
// must be quantized against the final row max, which a one-pass online softmax
// does not know, so the s8 attention kernel walks the keys twice: s8 q.k^T for
// the row max, then again for p, denom and the s8 P.V. V is stored transposed
// ([B, H, dh, M]) by its quantize pass, so that P.V's B operand has keys
// contiguous; P goes from the accumulator registers of q.k^T into the A
// operand with a fixed permutation of the keys inside each block of 32, and V's
// fragments are read in the same permutation. The dynamic per-tensor absmax is
// an atomicMax on the bits of |x| (non-negative floats order as integers), which
// is exact in any order. A layer is 12 launches (dynamic) to 19 (int8_attn).

#include "attention.cuh"

namespace {

constexpr float kEps = 1e-12f;
constexpr float kInv127 = 0.007874015748031496f;  // f32(1 / 127)

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// clip(rint(y), -127, 127): __float2int_rn rounds half to even
__device__ __forceinline__ int quant(float y) { return max(-127, min(127, __float2int_rn(y))); }
__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (a & 0xff) | ((b & 0xff) << 8) | ((c & 0xff) << 16) | ((d & 0xff) << 24);
}
__device__ __forceinline__ float scale_of(float absmax) { return __fadd_rn(__fdiv_rn(absmax, 127.f), kEps); }

__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load4(const bf16* p) {
  const float2 a = load2(p), b = load2(p + 2);
  return make_float4(a.x, a.y, b.x, b.y);
}

// ------------------------------------------------------------ quantize rows

// One warp per row of x [rows, width] (width a multiple of 4): s8 row and its
// scale. static_scale null: per-row dynamic scale; else the calibrated one.
template <typename TX>
__global__ void __launch_bounds__(256)
quant_rows_kernel(const TX* __restrict__ x, int rows, int width, const float* __restrict__ static_scale,
                  int8_t* __restrict__ x8, float* __restrict__ srow) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  const TX* xr = x + static_cast<size_t>(row) * width;
  float s, inv = 0.f;
  if (static_scale != nullptr) {
    s = *static_scale;
    inv = __fdiv_rn(1.f, s);
  } else {
    float amax = 0.f;
    for (int c = lane * 4; c < width; c += 128) {
      const float4 v = load4(xr + c);
      amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w))));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    s = scale_of(amax);
  }
  uint32_t* out = reinterpret_cast<uint32_t*>(x8 + static_cast<size_t>(row) * width);
  for (int c = lane * 4; c < width; c += 128) {
    const float4 v = load4(xr + c);
    if (static_scale != nullptr)
      out[c / 4] = pack4(quant(__fmul_rn(v.x, inv)), quant(__fmul_rn(v.y, inv)),
                         quant(__fmul_rn(v.z, inv)), quant(__fmul_rn(v.w, inv)));
    else
      out[c / 4] = pack4(quant(__fdiv_rn(v.x, s)), quant(__fdiv_rn(v.y, s)),
                         quant(__fdiv_rn(v.z, s)), quant(__fdiv_rn(v.w, s)));
  }
  if (lane == 0) srow[row] = s;
}

template <typename TX>
cudaError_t quant_rows(const TX* x, int rows, int width, const float* static_scale, int8_t* x8,
                       float* srow, cudaStream_t s) {
  quant_rows_kernel<TX><<<(rows + 7) / 8, 256, 0, s>>>(x, rows, width, static_scale, x8, srow);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ s8 GEMM

enum S8Epilogue { kOutF32 = 0, kOutBf16 = 1, kCatF32 = 2, kReluAffineF32 = 3, kResidualX = 4 };

struct S8Args {
  const int8_t* A; int lda;   // [rows, k]
  const float* srow;          // [rows]
  const int8_t* W;            // [n_out, k]
  const float* scol;          // [n_out]
  const float* bias;          // [n_out]
  int rows, n_out, k;
  void* out; int ldo;
  const void* x; int ldx;     // x_q for kCatF32 / kResidualX
  const float* a1;            // kReluAffineF32
  const float* c1;
  int use_offset;
};

// columns c and c+1 of row r
template <int EPI, typename TX>
__device__ __forceinline__ void s8_epilogue2(const S8Args& p, int r, int c, int acc0, int acc1) {
  const float sr = p.srow[r];
  const float y0 = __fadd_rn(__fmul_rn(__int2float_rn(acc0), __fmul_rn(sr, p.scol[c])), p.bias[c]);
  const float y1 = __fadd_rn(__fmul_rn(__int2float_rn(acc1), __fmul_rn(sr, p.scol[c + 1])), p.bias[c + 1]);
  const size_t o = static_cast<size_t>(r) * p.ldo + c;
  if constexpr (EPI == kOutF32) {
    store2(static_cast<float*>(p.out) + o, y0, y1);
  } else if constexpr (EPI == kOutBf16) {
    store2(static_cast<bf16*>(p.out) + o, y0, y1);
  } else if constexpr (EPI == kCatF32) {
    const float2 x = load2(static_cast<const TX*>(p.x) + static_cast<size_t>(r) * p.ldx + c);
    float* out = static_cast<float*>(p.out) + o;
    store2(out + p.n_out, y0, y1);
    if (p.use_offset) store2(out, __fsub_rn(x.x, y0), __fsub_rn(x.y, y1));
    else store2(out, x.x, x.y);
  } else if constexpr (EPI == kReluAffineF32) {
    store2(static_cast<float*>(p.out) + o,
           __fadd_rn(__fmul_rn(fmaxf(y0, 0.f), p.a1[c]), p.c1[c]),
           __fadd_rn(__fmul_rn(fmaxf(y1, 0.f), p.a1[c + 1]), p.c1[c + 1]));
  } else {
    const float2 x = load2(static_cast<const TX*>(p.x) + static_cast<size_t>(r) * p.ldx + c);
    store2(static_cast<TX*>(p.out) + o, __fadd_rn(x.x, y0), __fadd_rn(x.y, y1));
  }
}

constexpr int kBK8 = 64, kPad8 = 16;  // an s8 k-tile and its padding, in bytes

// A BM x BN block per CTA, warps of WM x WN m16n8k32 tiles, the k loop
// double-buffered with cp.async; both operands have k contiguous.
template <int EPI, typename TX, int BM, int BN, int WM, int WN>
__global__ void __launch_bounds__((BM / WM) * (BN / WN) * 32) gemm_s8(S8Args p) {
  constexpr int kThreads = (BM / WM) * (BN / WN) * 32, MI = WM / 16, NI = WN / 8;
  __shared__ __align__(16) int8_t As[2][BM][kBK8 + kPad8];
  __shared__ __align__(16) int8_t Ws[2][BN][kBK8 + kPad8];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int wm = (warp / (BN / WN)) * WM, wn = (warp % (BN / WN)) * WN;
  int acc[MI][NI][4] = {};

  auto load = [&](int stage, int k0) {
    for (int i = tid; i < BM * (kBK8 / 16); i += kThreads) {
      const int r = i / (kBK8 / 16), c = (i % (kBK8 / 16)) * 16;
      const bool ok = m0 + r < p.rows;
      cp_async16(&As[stage][r][c], p.A + static_cast<size_t>(ok ? m0 + r : 0) * p.lda + k0 + c, ok);
    }
    for (int i = tid; i < BN * (kBK8 / 16); i += kThreads) {
      const int r = i / (kBK8 / 16), c = (i % (kBK8 / 16)) * 16;
      cp_async16(&Ws[stage][r][c], p.W + static_cast<size_t>(n0 + r) * p.k + k0 + c, true);
    }
    cp_async_commit();
  };

  const int ktiles = p.k / kBK8;
  load(0, 0);
  for (int kt = 0; kt < ktiles; ++kt) {
    const int stage = kt & 1;
    if (kt + 1 < ktiles) {
      load(stage ^ 1, (kt + 1) * kBK8);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK8; kk += 32) {
      uint32_t a[MI][4], b[NI][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        ldmatrix_x4(a[mi], &As[stage][wm + mi * 16 + (lane % 16)][kk + (lane / 16) * 16]);
#pragma unroll
      for (int np = 0; np < NI / 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4(r, &Ws[stage][wn + np * 16 + (lane % 8) + (lane / 16) * 8][kk + ((lane / 8) % 2) * 16]);
        b[2 * np][0] = r[0]; b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2]; b[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
    }
    __syncthreads();  // this stage is refilled by the next iteration's load
  }

  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + wm + mi * 16 + g + 8 * h;
        if (r < p.rows)
          s8_epilogue2<EPI, TX>(p, r, n0 + wn + ni * 8 + 2 * t, acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
}

template <int EPI, typename TX>
cudaError_t gemm8(const S8Args& p, cudaStream_t stream) {
  // 128x128 blocks where they fill the card, 64x64 for small batches
  const int big_blocks = ((p.rows + 127) / 128) * (p.n_out / 128);
  if (p.n_out % 128 == 0 && big_blocks >= 132) {
    const dim3 grid((p.rows + 127) / 128, p.n_out / 128);
    gemm_s8<EPI, TX, 128, 128, 64, 32><<<grid, 256, 0, stream>>>(p);
  } else {
    const dim3 grid((p.rows + 63) / 64, p.n_out / 64);
    gemm_s8<EPI, TX, 64, 64, 32, 32><<<grid, 128, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

// ------------------------------------------------- per-tensor quantization

// max |x| of each batch element into out[b], as the bits of a non-negative
// float (they order as unsigned integers); out starts at 0
__global__ void __launch_bounds__(256)
absmax_kernel(const float* __restrict__ x, size_t per_batch, unsigned* __restrict__ out) {
  __shared__ float red[8];
  const float* xb = x + blockIdx.y * per_batch;
  float amax = 0.f;
  for (size_t i = (blockIdx.x * 256 + threadIdx.x) * 4; i < per_batch; i += gridDim.x * 1024) {
    const float4 v = load4(xb + i);
    amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w))));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = amax;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < 8; ++w) amax = fmaxf(amax, red[w]);
    atomicMax(out + blockIdx.y, __float_as_uint(amax));
  }
}

// the scale of batch element b: the calibrated one, or from its absmax
__device__ __forceinline__ float tensor_scale(const unsigned* absmax, const float* static_scale, int b) {
  return static_scale != nullptr ? *static_scale : scale_of(__uint_as_float(absmax[b]));
}

// x [B, L * D] f32 -> s8 in the same layout, clip(rint(x * (1 / s)))
__global__ void __launch_bounds__(256)
quant_tensor_kernel(const float* __restrict__ x, size_t per_batch, const unsigned* __restrict__ absmax,
                    const float* __restrict__ static_scale, int8_t* __restrict__ x8) {
  const int b = blockIdx.y;
  const float inv = __fdiv_rn(1.f, tensor_scale(absmax, static_scale, b));
  const float* xb = x + b * per_batch;
  uint32_t* out = reinterpret_cast<uint32_t*>(x8 + b * per_batch);
  for (size_t i = (blockIdx.x * 256 + threadIdx.x) * 4; i < per_batch; i += gridDim.x * 1024) {
    const float4 v = load4(xb + i);
    out[i / 4] = pack4(quant(__fmul_rn(v.x, inv)), quant(__fmul_rn(v.y, inv)),
                       quant(__fmul_rn(v.z, inv)), quant(__fmul_rn(v.w, inv)));
  }
}

// v [B, M, D] f32 -> s8 transposed per head, vt [B, H, dh, Mp] (Mp a multiple
// of 64; keys from M on are 0): one 64-key tile of one head per block
template <int DH>
__global__ void __launch_bounds__(256)
quant_v_transposed_kernel(const float* __restrict__ v, int M, int Mp, int D,
                          const unsigned* __restrict__ absmax, const float* __restrict__ static_scale,
                          int8_t* __restrict__ vt) {
  __shared__ int8_t tile[DH][64 + 16];  // [d][key]
  const int m0 = blockIdx.x * 64, h = blockIdx.y, b = blockIdx.z, H = gridDim.y, tid = threadIdx.x;
  const float inv = __fdiv_rn(1.f, tensor_scale(absmax, static_scale, b));
  for (int i = tid; i < 64 * DH; i += 256) {
    const int r = i / DH, d = i % DH;
    int q = 0;
    if (m0 + r < M) q = quant(__fmul_rn(v[(static_cast<size_t>(b) * M + m0 + r) * D + h * DH + d], inv));
    tile[d][r] = static_cast<int8_t>(q);
  }
  __syncthreads();
  const int d = tid / 4, c = (tid % 4) * 16;
  if (d < DH)
    *reinterpret_cast<uint4*>(vt + ((static_cast<size_t>(b) * H + h) * DH + d) * Mp + m0 + c) =
        *reinterpret_cast<const uint4*>(&tile[d][c]);
}

// ------------------------------------------------------------ s8 attention

// 4 warps, 16 query rows each, one (element, head, 64-query block) per CTA.
// Pass 0 finds each row's max logit; pass 1 recomputes the logits and
// accumulates denom and the s8 P.V against that max.
template <int DH>
__global__ void __launch_bounds__(kAttnThreads)
attention_s8(const int8_t* __restrict__ q8, const int8_t* __restrict__ k8,
             const int8_t* __restrict__ vt8, const uint8_t* __restrict__ mask,
             const unsigned* __restrict__ absmax, const float* __restrict__ act_scales,
             float* __restrict__ out, int B, int N, int M, int Mp, int D) {
  constexpr int kLd = DH + 16, kChunks = DH / 16, kSteps = DH / 32;  // 16-byte chunks; k-steps of 32
  __shared__ __align__(16) int8_t Qs[kAq][kLd];
  __shared__ __align__(16) int8_t Ks[2][kAk][kLd];
  __shared__ __align__(16) int8_t Vs[2][DH][kAk + 16];  // [d][key]
  __shared__ float madd[2][kAk];
  const int b = blockIdx.z, h = blockIdx.y, H = gridDim.y, n0 = blockIdx.x * kAq;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int8_t* qb = q8 + static_cast<size_t>(b) * N * D + h * DH;
  const int8_t* kb = k8 + static_cast<size_t>(b) * M * D + h * DH;
  const int8_t* vb = vt8 + (static_cast<size_t>(b) * H + h) * DH * Mp;
  // sites 5, 6, 7 of act_scales are k, v, q; absmax holds [k, v, q][B]
  const float s_k = tensor_scale(absmax, act_scales ? act_scales + 5 : nullptr, b);
  const float s_v = tensor_scale(absmax ? absmax + B : nullptr, act_scales ? act_scales + 6 : nullptr, b);
  const float s_q = tensor_scale(absmax ? absmax + 2 * B : nullptr, act_scales ? act_scales + 7 : nullptr, b);
  const float logit_scale = __fmul_rn(__fmul_rn(s_q, s_k), Head<DH>::scale);
  const float out_scale = __fmul_rn(s_v, kInv127);

  auto load_kv = [&](int stage, int k0, bool with_v) {
    for (int i = tid; i < kAk * kChunks; i += kAttnThreads) {
      const int r = i / kChunks, c = (i % kChunks) * 16;
      const bool ok = k0 + r < M;
      cp_async16(&Ks[stage][r][c], kb + static_cast<size_t>(ok ? k0 + r : 0) * D + c, ok);
    }
    if (with_v)  // row r is a column d of V; its keys k0 .. k0 + 63 exist up to Mp
      for (int i = tid; i < DH * (kAk / 16); i += kAttnThreads) {
        const int r = i / (kAk / 16), c = (i % (kAk / 16)) * 16;
        cp_async16(&Vs[stage][r][c], vb + static_cast<size_t>(r) * Mp + k0 + c, true);
      }
    if (tid < kAk) madd[stage][tid] = mask_add(mask, b, M, k0 + tid);
    cp_async_commit();
  };

  for (int i = tid; i < kAq * kChunks; i += kAttnThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 16;
    const bool ok = n0 + r < N;
    cp_async16(&Qs[r][c], qb + static_cast<size_t>(ok ? n0 + r : 0) * D + c, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qa[kSteps][4];
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk)
    ldmatrix_x4(qa[kk], &Qs[warp * 16 + (lane % 16)][kk * 32 + (lane / 16) * 16]);

  int o[DH / 8][4] = {};
  float row_max[2] = {-INFINITY, -INFINITY};
  float row_sum[2] = {0.f, 0.f};
  const int ktiles = (M + kAk - 1) / kAk;
  for (int pass = 0; pass < 2; ++pass) {
    load_kv(0, 0, pass == 1);
    for (int kt = 0; kt < ktiles; ++kt) {
      const int st = kt & 1;
      if (kt + 1 < ktiles) {
        load_kv(st ^ 1, (kt + 1) * kAk, pass == 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();

      int s[8][4] = {};
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk)
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t r[4];
          ldmatrix_x4(r, &Ks[st][np * 16 + (lane % 8) + (lane / 16) * 8][kk * 32 + ((lane / 8) % 2) * 16]);
          mma_s8(s[2 * np], qa[kk], r[0], r[1]);
          mma_s8(s[2 * np + 1], qa[kk], r[2], r[3]);
        }
      float p[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[nt][e] = __fadd_rn(__fmul_rn(__int2float_rn(s[nt][e]), logit_scale),
                               madd[st][nt * 8 + 2 * t + (e & 1)]);
      if (pass == 0) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) row_max[e >> 1] = fmaxf(row_max[e >> 1], p[nt][e]);
      } else {
        int p8[8][4];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float pe = expf(p[nt][e] - row_max[e >> 1]);
            row_sum[e >> 1] += pe;
            p8[nt][e] = __float2int_rn(__fmul_rn(pe, 127.f));
          }
        // Inside a block of 32 keys the A operand's k index 4t + j holds the
        // thread's own columns: keys 2t, 2t+1, 8+2t, 9+2t of each half of 16;
        // V's fragments are read in the same order.
#pragma unroll
        for (int kc = 0; kc < 2; ++kc) {
          uint32_t pa[4];
          pa[0] = pack4(p8[4 * kc][0], p8[4 * kc][1], p8[4 * kc + 1][0], p8[4 * kc + 1][1]);
          pa[1] = pack4(p8[4 * kc][2], p8[4 * kc][3], p8[4 * kc + 1][2], p8[4 * kc + 1][3]);
          pa[2] = pack4(p8[4 * kc + 2][0], p8[4 * kc + 2][1], p8[4 * kc + 3][0], p8[4 * kc + 3][1]);
          pa[3] = pack4(p8[4 * kc + 2][2], p8[4 * kc + 2][3], p8[4 * kc + 3][2], p8[4 * kc + 3][3]);
#pragma unroll
          for (int nd = 0; nd < DH / 8; ++nd) {
            const int8_t* vrow = &Vs[st][nd * 8 + g][kc * 32 + 2 * t];
            const uint32_t b0 = *reinterpret_cast<const uint16_t*>(vrow) |
                                (static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(vrow + 8)) << 16);
            const uint32_t b1 = *reinterpret_cast<const uint16_t*>(vrow + 16) |
                                (static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(vrow + 24)) << 16);
            mma_s8(o[nd], pa, b0, b1);
          }
        }
      }
      __syncthreads();  // this stage is refilled by the next iteration's load
    }
    if (pass == 0) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        row_max[hh] = fmaxf(row_max[hh], __shfl_xor_sync(0xffffffffu, row_max[hh], 1));
        row_max[hh] = fmaxf(row_max[hh], __shfl_xor_sync(0xffffffffu, row_max[hh], 2));
      }
    }
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    row_sum[hh] += __shfl_xor_sync(0xffffffffu, row_sum[hh], 1);
    row_sum[hh] += __shfl_xor_sync(0xffffffffu, row_sum[hh], 2);
  }
  float* ob = out + static_cast<size_t>(b) * N * D + h * DH;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = n0 + warp * 16 + g + 8 * hh;
    if (r < N) {
#pragma unroll
      for (int nd = 0; nd < DH / 8; ++nd)
        store2(ob + static_cast<size_t>(r) * D + nd * 8 + 2 * t,
               __fmul_rn(__int2float_rn(o[nd][2 * hh]), out_scale) / row_sum[hh],
               __fmul_rn(__int2float_rn(o[nd][2 * hh + 1]), out_scale) / row_sum[hh]);
    }
  }
}

// ---------------------------------------------------------------- the layer

struct Buffers {
  int8_t *kv8, *xq8, *attn8, *cat8, *h18, *q8, *k8, *vt8;
  float *skv, *sxq, *sattn, *scat, *sh1, *qf, *kf, *vf, *attn, *cat, *h1;
  bf16 *qb, *kb, *vb;
  unsigned* absmax;
};

Buffers carve(Carve& ws, int B, int N, int M, int D, int H, int quant_attention) {
  const size_t rq = static_cast<size_t>(B) * N, rk = static_cast<size_t>(B) * M;
  const size_t mp = static_cast<size_t>((M + 63) / 64) * 64;
  Buffers p = {};
  p.kv8 = ws.take<int8_t>(rk * D);
  p.skv = ws.take<float>(rk);
  p.xq8 = ws.take<int8_t>(rq * D);
  p.sxq = ws.take<float>(rq);
  if (quant_attention) {
    p.qf = ws.take<float>(rq * D);
    p.kf = ws.take<float>(rk * D);
    p.vf = ws.take<float>(rk * D);
    p.absmax = ws.take<unsigned>(3 * static_cast<size_t>(B));
    p.q8 = ws.take<int8_t>(rq * D);
    p.k8 = ws.take<int8_t>(rk * D);
    p.vt8 = ws.take<int8_t>(static_cast<size_t>(B) * mp * D);  // [B, H, dh, Mp]
  } else {
    p.qb = ws.take<bf16>(rq * D);
    p.kb = ws.take<bf16>(rk * D);
    p.vb = ws.take<bf16>(rk * D);
  }
  p.attn = ws.take<float>(rq * D);
  p.attn8 = ws.take<int8_t>(rq * D);
  p.sattn = ws.take<float>(rq);
  p.cat = ws.take<float>(rq * 2 * D);
  p.cat8 = ws.take<int8_t>(rq * 2 * D);
  p.scat = ws.take<float>(rq);
  p.h1 = ws.take<float>(rq * 2 * D);
  p.h18 = ws.take<int8_t>(rq * 2 * D);
  p.sh1 = ws.take<float>(rq);
  return p;
}

template <typename TX>
int layer(int B, int N, int M, int D, int H, int quant_attention, int use_offset, const void* xq_,
          const void* xkv_, const void* mask_, const float* act, const void* const* w,
          const float* const* f, void* ws_, void* out, cudaStream_t s) {
  const TX* xq = static_cast<const TX*>(xq_);
  const TX* xkv = static_cast<const TX*>(xkv_);
  const uint8_t* mask = static_cast<const uint8_t*>(mask_);
  const int8_t *wq = static_cast<const int8_t*>(w[0]), *wk = static_cast<const int8_t*>(w[1]),
               *wv = static_cast<const int8_t*>(w[2]), *wo = static_cast<const int8_t*>(w[3]),
               *w1 = static_cast<const int8_t*>(w[4]), *w2 = static_cast<const int8_t*>(w[5]);
  const float *sq = f[0], *bq = f[1], *sk = f[2], *bk = f[3], *sv = f[4], *bv = f[5], *so = f[6],
              *bo = f[7], *s1 = f[8], *b1 = f[9], *a1 = f[10], *c1 = f[11], *s2 = f[12], *b2 = f[13];
  Carve ws{static_cast<char*>(ws_)};
  const Buffers p = carve(ws, B, N, M, D, H, quant_attention);
  const int nq = B * N, nk = B * M, mp = (M + 63) / 64 * 64;
  // the calibrated scale of a site, or null for a dynamic one
  auto site = [&](int i) { return act != nullptr ? act + i : nullptr; };
  cudaError_t err;
  if ((err = quant_rows(xkv, nk, D, site(0), p.kv8, p.skv, s))) return err;
  if ((err = quant_rows(xq, nq, D, site(1), p.xq8, p.sxq, s))) return err;
  if (quant_attention) {
    if ((err = gemm8<kOutF32, TX>({p.kv8, D, p.skv, wk, sk, bk, nk, D, D, p.kf, D}, s))) return err;
    if ((err = gemm8<kOutF32, TX>({p.kv8, D, p.skv, wv, sv, bv, nk, D, D, p.vf, D}, s))) return err;
    if ((err = gemm8<kOutF32, TX>({p.xq8, D, p.sxq, wq, sq, bq, nq, D, D, p.qf, D}, s))) return err;
    const size_t per_k = static_cast<size_t>(M) * D, per_q = static_cast<size_t>(N) * D;
    const unsigned* absmax = nullptr;
    if (act == nullptr) {  // dynamic: one absmax per batch element for k, v and q
      if ((err = cudaMemsetAsync(p.absmax, 0, 3 * static_cast<size_t>(B) * sizeof(unsigned), s))) return err;
      absmax_kernel<<<dim3(32, B), 256, 0, s>>>(p.kf, per_k, p.absmax);
      absmax_kernel<<<dim3(32, B), 256, 0, s>>>(p.vf, per_k, p.absmax + B);
      absmax_kernel<<<dim3(32, B), 256, 0, s>>>(p.qf, per_q, p.absmax + 2 * B);
      if ((err = cudaGetLastError())) return err;
      absmax = p.absmax;
    }
    quant_tensor_kernel<<<dim3(32, B), 256, 0, s>>>(p.kf, per_k, absmax, site(5), p.k8);
    quant_tensor_kernel<<<dim3(32, B), 256, 0, s>>>(p.qf, per_q, absmax ? absmax + 2 * B : nullptr, site(7), p.q8);
    if ((err = with_head_width(D / H, [&](auto width) -> cudaError_t {
          constexpr int DH = decltype(width)::value;
          quant_v_transposed_kernel<DH><<<dim3(mp / 64, H, B), 256, 0, s>>>(
              p.vf, M, mp, D, absmax ? absmax + B : nullptr, site(6), p.vt8);
          attention_s8<DH><<<dim3((N + kAq - 1) / kAq, H, B), kAttnThreads, 0, s>>>(
              p.q8, p.k8, p.vt8, mask, absmax, act, p.attn, B, N, M, mp, D);
          return cudaGetLastError();
        }))) return err;
  } else {
    if ((err = gemm8<kOutBf16, TX>({p.kv8, D, p.skv, wk, sk, bk, nk, D, D, p.kb, D}, s))) return err;
    if ((err = gemm8<kOutBf16, TX>({p.kv8, D, p.skv, wv, sv, bv, nk, D, D, p.vb, D}, s))) return err;
    if ((err = gemm8<kOutBf16, TX>({p.xq8, D, p.sxq, wq, sq, bq, nq, D, D, p.qb, D}, s))) return err;
    if ((err = attention<bf16, float>(p.qb, p.kb, p.vb, mask, p.attn, nullptr, B, N, M, D, H, D, D, s))) return err;
  }
  if ((err = quant_rows(p.attn, nq, D, site(2), p.attn8, p.sattn, s))) return err;
  if ((err = gemm8<kCatF32, TX>({p.attn8, D, p.sattn, wo, so, bo, nq, D, D, p.cat, 2 * D, xq, D, nullptr, nullptr, use_offset}, s))) return err;
  if ((err = quant_rows(p.cat, nq, 2 * D, site(3), p.cat8, p.scat, s))) return err;
  if ((err = gemm8<kReluAffineF32, TX>({p.cat8, 2 * D, p.scat, w1, s1, b1, nq, 2 * D, 2 * D, p.h1, 2 * D, nullptr, 0, a1, c1, 0}, s))) return err;
  if ((err = quant_rows(p.h1, nq, 2 * D, site(4), p.h18, p.sh1, s))) return err;
  return gemm8<kResidualX, TX>({p.h18, 2 * D, p.sh1, w2, s2, b2, nq, D, 2 * D, out, D, xq, D, nullptr, nullptr, 0}, s);
}

}  // namespace

// Bytes of workspace og_gnn_layer_int8 needs.
extern "C" size_t og_gnn_layer_int8_workspace(int x_is_bf16, int B, int N, int M, int D, int H,
                                              int quant_attention) {
  Carve ws{nullptr};
  carve(ws, B, N, M, D, H, quant_attention);
  return ws.used;
}

// One layer. x_is_bf16 selects the type X of x_q, x_kv and out (else f32).
// act_scales: null for dynamic quantization, else f32 [5] (kv, xq, attn, cat,
// h1) or, with quant_attention, [8] (+ k, v, q of the attention). weights (s8,
// [out, in]): wq, wk, wv, wo [D, D], w1 [2D, 2D], w2 [D, 2D]. f32 vectors: sq,
// bq, sk, bk, sv, bv, so, bo [D], s1, b1, a1, c1 [2D], s2, b2 [D]. mask: [B, M]
// uint8 or null. D = dh * H with dh 32 or 64.
// Returns the CUDA error code of the launches (0 on success).
extern "C" int og_gnn_layer_int8(int x_is_bf16, int B, int N, int M, int D, int H,
                                 int quant_attention, int use_offset, const void* xq,
                                 const void* xkv, const void* mask, const void* act_scales,
                                 const void* const* weights, const void* const* vectors,
                                 void* workspace, void* out, void* stream) {
  if (B == 0 || N == 0) return cudaSuccess;
  if (!head_width_ok(D, H) || M <= 0) return cudaErrorInvalidValue;
  const float* const* f = reinterpret_cast<const float* const*>(vectors);
  const float* act = static_cast<const float*>(act_scales);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    return layer<bf16>(B, N, M, D, H, quant_attention, use_offset, xq, xkv, mask, act, weights, f, workspace, out, s);
  return layer<float>(B, N, M, D, H, quant_attention, use_offset, xq, xkv, mask, act, weights, f, workspace, out, s);
}
