// One eval-mode attentional-propagation layer with O(N) feature-map attention
// (linear ELU+1, FAVOR-relu, FAVOR-softmax) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel openglue_tpu/ops/pallas/gnn_layer_kernel.py::
// _layer_kernel, feature-map kinds, reached through fused_attention_propagation.
// For x_q [B, N, D], x_kv [B, M, D], H heads of dh = 32 or 64 and F features per head
// (F = dh for linear; the rows of the projection [F, dh] for FAVOR):
//   q = T(x_q Wq + bq);  k = x_kv Wk + bk (kept f32);  v = T(x_kv Wv + bv)
//   phi(x):  linear         x > 0 ? x + 1 : exp(min(x, 0)), + 1e-6
//            favor_relu     max(ph, 0) + 1e-8,          ph = T(x dh^-1/4) . T(proj)^T
//            favor_softmax  F^-1/2 (exp(ph - |x dh^-1/4|^2 / 2 - stab) + 1e-8), stab the
//                           row max of ph for a query and, for keys, ONE max per
//                           (element, head) over valid keys x features
//   kf = phi(k_h) * mask;  KV_h = T(kf)^T . v_h (f32);  ksum_h = sum_m kf (f32)
//   attn_h = T((T(phi(q_h)) . KV_h) / (phi(q_h) . ksum_h))
//   msg = T(attn Wo + bo);  cat = [x_q, msg] or [T(x_q - msg), msg]
//   h1 = T(relu(cat W1 + b1) * a1 + c1);  out = T(x_q + (h1 W2 + b2))
// T is bf16 or f32; every sum accumulates in f32, at the TPU kernel's rounding
// points. An element whose keys are all masked has KV = ksum = 0 and comes out
// NaN (0 / 0), as on the TPU.
//
// What bounds it on the H100: at B=16, N=M=1024, D=256, F=128 the layer needs
// 2.6e10 operations, 2.1e10 of them in the six dense products, against 25 MB
// of activations in and out. The feature products (the FAVOR projection of
// keys and queries, kf^T v, qf KV with KV in two pieces) are 5.4e9 more on
// the tensor cores: 8 us for the whole card at the 652 TFLOP/s that mma.sync
// reaches on an H100 (scripts/mma_peak.py). What holds the attention part is
// the per-chunk and per-tile work around them: staging and converting the
// keys, the exps, FAVOR-softmax's second sweep for its stabilizer, the query
// tiles' epilogue (scripts/k6_phases.py splits it by phase; PERF.md).
//
// Design. The six dense products run in the shared GEMM with its fused
// epilogues (gemm.cuh): k (f32 out), v and q before, the out projection and
// the two FFN products after. Between them ONE launch does the attention
// part, so a layer is seven launches (eleven before: a key-feature kernel
// wrote [B, H, M, F] f32 features to device memory, an aggregate kernel read
// them back, two launches added its key splits). Its grid is one cluster of
// C CTAs (C <= 8, the plan below; 2 at B=16) per (element, head): CTA r owns
// a contiguous run of 64-key chunks and a run of query tiles.
//
// Keys. A CTA stages its chunks through a ring of cp.async buffers (raw f32
// k, v), with the CTA's mask weights read once; for FAVOR it converts each
// chunk to T(k dh^-1/4) in shared memory (and, for FAVOR-softmax,
// |k dh^-1/4|^2 / 2). A warp owns 16 features and a share of the chunk's
// 16-key groups, and computes ph^T = T(proj) . T(k dh^-1/4)^T for them as
// mma.sync m16n8k16 (bf16 in, f32 accumulate): rows are features, columns
// keys. The feature map, the mask and the key sum are applied to that
// accumulator in registers, and the accumulator, rounded to T, is the A
// operand of KV += T(kf)^T v (v by ldmatrix.trans) without leaving registers:
// the features of a key never reach memory of any kind. FAVOR-softmax first
// sweeps its keys for the max of ph over valid keys x features (a masked key
// at ph - 1e9), keeping T(k dh^-1/4) and the diag resident in shared memory
// where they fit; the cluster's CTAs exchange their maxes through distributed
// shared memory; the second sweep recomputes ph with the true stabilizer
// inside the exp, at the TPU kernel's rounding points.
//
// The cluster's partial KV and ksum (F x dh + F f32 per warp group) meet in
// distributed shared memory: each CTA adds one slice of them over the
// cluster's CTAs and key groups in a fixed order and stores the sum into
// every CTA's KV (two cluster barriers). No atomics: two runs give equal bits.
//
// Queries. A warp takes a tile of 32 queries (16 in f32), staged by cp.async
// one tile ahead: A fragments of T(q dh^-1/4) (or elu1p(q)), ph = that .
// T(proj)^T on the tensor cores (twice for FAVOR-softmax, whose row max needs
// every feature first), the feature map in registers, norm += qf . ksum in
// f32 from the unrounded qf, and o += T(qf) . KV with KV f32 split into bf16
// hi + lo (two products; |KV - hi - lo| <= 2^-16 |KV|, under the output's bf16
// rounding); o times the reciprocal of norm.
//
// The f32 instance keeps its tiles as raw f32 in shared memory and splits
// every f32 operand, as its fragment is read, into three bf16 pieces (x = hi +
// mid + lo exactly for normal x); a product is the six piece products whose
// orders sum to at most 2^-16, smallest first: f32 accuracy at the cost of
// 3xTF32, on the same m16n8k16 fragments as the bf16 instance.

#include <math.h>

#include <cooperative_groups.h>

#include "gemm.cuh"

namespace cg = cooperative_groups;

namespace {

enum Kind { kLinear = 0, kFavorRelu = 1, kFavorSoftmax = 2 };

constexpr float kEluEps = 1e-6f, kFavorEps = 1e-8f;
constexpr int kFeatThreads = 256, kFeatWarps = kFeatThreads / 32;
constexpr int kChunk = 64;           // keys per staged chunk
constexpr int kMaxFeatures = 256;
constexpr int kMaxClusterCtas = 8;   // portable cluster size
constexpr int kSmemCap = 232448;     // shared memory one block may opt into on the H100

// The operand tiles in shared memory: bf16 (read by ldmatrix) in the bf16
// instance; raw f32 in the f32 instance, split into kPieces bf16 pieces as a
// fragment is read. KV takes two pieces in bf16 (hi + lo), three in f32.
template <typename T> struct Op;
template <> struct Op<bf16> {
  using Elem = bf16;
  static constexpr int kPad = 8, kPieces = 1, kKvPieces = 2;
};
template <> struct Op<float> {
  using Elem = float;
  static constexpr int kPad = 4, kPieces = 3, kKvPieces = 3;
};

// ---------------------------------------------------------------- the plan (host)

__host__ __device__ inline int align16(int x) { return (x + 15) / 16 * 16; }

// Chunks of v in flight (a ring; the raw keys take one fewer for FAVOR,
// whose keys leave their buffer at the conversion): three in bf16, two in f32,
// whose tiles are twice as wide
template <typename T>
__host__ __device__ constexpr int key_stages() {
  return std::is_same<T, bf16>::value ? 3 : 2;
}

// Rows of the query tile a warp takes at once: two 16-row halves that share
// every B fragment in bf16, one in f32 (whose operands take three times the
// registers)
template <typename T>
__host__ __device__ constexpr int query_rows() {
  return std::is_same<T, bf16>::value ? 32 : 16;
}

// Byte offsets of one CTA's shared memory:
//   [T(proj) (FAVOR)] [ksum F f32] [cmax 16 f32] [mask weight of each of the CTA's keys]
//   [stage: raw k f32 rings, T(k dh^-1/4) (FAVOR), a ring of v, diag;
//    after the keys, the key groups' partial KV + ksum, then each warp's two query tiles]
//   [resident keys (FAVOR-softmax where they fit): T(k dh^-1/4) and diag of every chunk]
//   [KV for the queries (bf16 hi + lo planes, or f32); before it, the raw projection and,
//    with two feature tiles per warp, the second tile's stage]
struct Layout {
  int ksum, cmax, wts, stage, keys, kv, total;
  int xk, v, diag;  // offsets within a stage
  int raw_bytes;    // one raw k buffer
  int v_bytes;      // one v (or T(k dh^-1/4)) buffer
};

inline Layout make_layout(int F, int dh, bool is_bf16, int kind, int key_groups, int tiles_per_warp,
                          int chunks, bool resident) {
  const int esz = is_bf16 ? 2 : 4, ld = dh + (is_bf16 ? 8 : 4);
  const int qrows = is_bf16 ? query_rows<bf16>() : query_rows<float>();
  const int stages = is_bf16 ? key_stages<bf16>() : key_stages<float>();
  const int e4 = (F * dh + F) / 4;
  Layout L;
  int off = kind == kLinear ? 0 : align16(F * ld * esz);
  L.ksum = off;
  off += align16(F * 4);
  L.cmax = off;
  L.wts = off + 64;
  L.stage = L.wts + chunks * kChunk * 4;
  L.raw_bytes = kChunk * (dh + 4) * 4;
  L.v_bytes = kChunk * ld * esz;
  L.xk = (kind == kLinear ? stages : stages - 1) * L.raw_bytes;
  L.v = L.xk + (kind == kLinear ? 0 : L.v_bytes);
  L.diag = L.v + stages * L.v_bytes;
  const int stage = L.diag + kChunk * 4, queries = kFeatWarps * 2 * qrows * ld * esz;
  const int part = key_groups * e4 * 16;
  L.keys = L.stage + (stage > queries ? (stage > part ? stage : part) : (queries > part ? queries : part));
  L.kv = L.keys + (resident ? chunks * kChunk * (ld * esz + 4) : 0);
  int room = is_bf16 ? 2 * F * ld * 2 : F * ld * 4;
  room = room > F * dh * 4 ? room : F * dh * 4;
  if (tiles_per_warp == 2 && stage > room) room = stage;
  L.total = L.kv + room;
  return L;
}

// How the attention part spreads over the card (mirrored by
// gnn_layer_kernel.feature_plan): C CTAs per (element, head), the largest
// power of two up to 8 that keeps at most one CTA per SM on the card, and no
// more CTAs than 64-key chunks or 64-query runs. (A CTA's fixed work, staging
// T(proj) and receiving the whole KV, does not shrink with its share of the
// keys: at B=16 two CTAs per (element, head) ran the layer faster than four
// or eight on an H100.) Warp w owns feature tile w / G (and w / G + 8 where
// F > 128) and every G-th 16-key group of a chunk, G = 8 / (F / 16) key groups
// (1 to 4). FAVOR-softmax keeps every chunk's T(k dh^-1/4) from its first
// sweep to its second where a CTA has the room.
struct FeaturePlan {
  int cluster, key_groups, tiles_per_warp, chunks_per_cta, qtiles_per_cta, resident;
  Layout L;
};

inline FeaturePlan make_feature_plan(int B, int H, int N, int M, int F, int dh, bool is_bf16, int kind,
                                     int sms) {
  FeaturePlan p;
  const int ft = F / 16;
  p.key_groups = ft >= kFeatWarps ? 1 : (kFeatWarps / ft < 4 ? kFeatWarps / ft : 4);
  p.tiles_per_warp = ft > kFeatWarps ? 2 : 1;
  const long long heads = static_cast<long long>(B) * H;
  const int longest = M > N ? M : N;
  int C = 1;
  while (C < kMaxClusterCtas && 2 * heads * C <= sms && C * kChunk < longest) C *= 2;
  const int qrows = is_bf16 ? query_rows<bf16>() : query_rows<float>();
  const int chunks = (M + kChunk - 1) / kChunk, qtiles = (N + qrows - 1) / qrows;
  p.cluster = C;
  p.chunks_per_cta = (chunks + C - 1) / C;
  p.qtiles_per_cta = (qtiles + C - 1) / C;
  p.L = make_layout(F, dh, is_bf16, kind, p.key_groups, p.tiles_per_warp, p.chunks_per_cta, false);
  p.resident = 0;
  if (kind == kFavorSoftmax) {
    const Layout R = make_layout(F, dh, is_bf16, kind, p.key_groups, p.tiles_per_warp, p.chunks_per_cta, true);
    if (R.total <= kSmemCap) {
      p.L = R;
      p.resident = 1;
    }
  }
  return p;
}

// ---------------------------------------------------------------- fragments (device)

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// (x0, x1) as P bf16 pairs: P = 1 rounds to bf16 (the rounding of T = bf16);
// P = 2 adds the remainder (|error| <= 2^-16 |x|); P = 3 is exact for normal x
template <int P>
__device__ __forceinline__ void split2(float x0, float x1, uint32_t (&out)[P]) {
  out[0] = pack_bf16(x0, x1);
  if constexpr (P > 1) {
    const float2 h = unpack_bf16(out[0]);
    x0 -= h.x;
    x1 -= h.y;
    out[1] = pack_bf16(x0, x1);
    if constexpr (P > 2) {
      const float2 m = unpack_bf16(out[1]);
      out[2] = pack_bf16(x0 - m.x, x1 - m.y);
    }
  }
}

// acc[n] += a . b[n] for N accumulators that share the A operand: the
// pieces' products i + j < max(PA, PB), the small ones first, in rounds of
// one product per accumulator. mma.sync issues in program order, so a
// product issued right behind one into the same accumulator would wait for it.
template <int PA, int PB, int N>
__device__ __forceinline__ void mma_rounds(float (&acc)[N][4], const uint32_t (&a)[PA][4],
                                           const uint32_t (&b)[N][PB][2]) {
  constexpr int P = PA > PB ? PA : PB;
#pragma unroll
  for (int s = P - 1; s >= 0; --s)
#pragma unroll
    for (int i = 0; i < PA; ++i)
      if (s - i >= 0 && s - i < PB)
#pragma unroll
        for (int n = 0; n < N; ++n) mma_bf16(acc[n], a[i], b[n][s - i][0], b[n][s - i][1]);
}

// A operand (16 rows x 16 k, row-major) at (r0, k0) of a tile [rows][ld]
template <int P, typename E>
__device__ __forceinline__ void load_a(uint32_t (&a)[P][4], const E* tile, int ld, int r0, int k0, int lane) {
  if constexpr (std::is_same<E, bf16>::value) {
    ldmatrix_x4(a[0], tile + (r0 + lane % 16) * ld + k0 + (lane / 16) * 8);
  } else {
    const int g = lane / 4, t = lane % 4;
    const float* p = tile + (r0 + g) * ld + k0 + 2 * t;
    const float2 x[4] = {load2(p), load2(p + 8 * ld), load2(p + 8), load2(p + 8 * ld + 8)};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t s[P];
      split2<P>(x[i].x, x[i].y, s);
#pragma unroll
      for (int q = 0; q < P; ++q) a[q][i] = s[q];
    }
  }
}

// B operands b[0], b[1] of two n-tiles (rows n0 .. n0 + 15 of a tile
// [n][ld], the contraction along a row) at k0
template <int P, typename E>
__device__ __forceinline__ void load_b_rows(uint32_t (*b)[P][2], const E* tile, int ld, int n0, int k0,
                                            int lane) {
  if constexpr (std::is_same<E, bf16>::value) {
    uint32_t r[4];
    ldmatrix_x4(r, tile + (n0 + lane % 8 + (lane / 16) * 8) * ld + k0 + ((lane / 8) % 2) * 8);
    b[0][0][0] = r[0]; b[0][0][1] = r[1]; b[1][0][0] = r[2]; b[1][0][1] = r[3];
  } else {
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float* p = tile + (n0 + 8 * j + g) * ld + k0 + 2 * t;
      const float2 x0 = load2(p), x1 = load2(p + 8);
      uint32_t s0[P], s1[P];
      split2<P>(x0.x, x0.y, s0);
      split2<P>(x1.x, x1.y, s1);
#pragma unroll
      for (int q = 0; q < P; ++q) {
        b[j][q][0] = s0[q];
        b[j][q][1] = s1[q];
      }
    }
  }
}

// B operands b[0], b[1] of two n-tiles (columns n0 .. n0 + 15) at rows k0 ..
// k0 + 15 of a tile [k][ld] (the contraction down a column)
template <int P, typename E>
__device__ __forceinline__ void load_b_cols(uint32_t (*b)[P][2], const E* tile, int ld, int k0, int n0,
                                            int lane) {
  if constexpr (std::is_same<E, bf16>::value) {
    uint32_t r[4];
    ldmatrix_x4_trans(r, tile + (k0 + lane % 8 + ((lane / 8) % 2) * 8) * ld + n0 + (lane / 16) * 8);
    b[0][0][0] = r[0]; b[0][0][1] = r[1]; b[1][0][0] = r[2]; b[1][0][1] = r[3];
  } else {
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float* p = tile + (k0 + 2 * t) * ld + n0 + 8 * j + g;
      uint32_t s0[P], s1[P];
      split2<P>(p[0], p[ld], s0);
      split2<P>(p[8 * ld], p[9 * ld], s1);
#pragma unroll
      for (int q = 0; q < P; ++q) {
        b[j][q][0] = s0[q];
        b[j][q][1] = s1[q];
      }
    }
  }
}

// KV's B operands for the query product: hi and lo planes of bf16 (ldmatrix),
// or the raw f32 tile split in three
template <typename T, int PKV>
__device__ __forceinline__ void load_kv(uint32_t (*b)[PKV][2], const typename Op<T>::Elem* kv, int plane,
                                        int ld, int k0, int n0, int lane) {
  if constexpr (std::is_same<T, bf16>::value) {
#pragma unroll
    for (int q = 0; q < PKV; ++q) {
      uint32_t r[2][1][2];
      load_b_cols<1>(r, kv + q * plane, ld, k0, n0, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        b[j][q][0] = r[j][0][0];
        b[j][q][1] = r[j][0][1];
      }
    }
  } else {
    load_b_cols<PKV>(b, kv, ld, k0, n0, lane);
  }
}

// The A operand of a product that contracts over the 16 columns of two
// accumulator n-tiles (lo: columns 0-7, hi: 8-15), in P pieces
template <int P>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[P][4], const float (&lo)[4], const float (&hi)[4]) {
  uint32_t s[4][P];
  split2<P>(lo[0], lo[1], s[0]);
  split2<P>(lo[2], lo[3], s[1]);
  split2<P>(hi[0], hi[1], s[2]);
  split2<P>(hi[2], hi[3], s[3]);
#pragma unroll
  for (int q = 0; q < P; ++q)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[q][i] = s[i][q];
}

// e^x by ex2.approx: a few ulps, far under the features' bf16 rounding and
// the f32 instance's bar
__device__ __forceinline__ float exp_f(float x) { return __expf(x); }
__device__ __forceinline__ float elu1p(float x) { return x > 0.f ? x + 1.f : exp_f(fminf(x, 0.f)); }

__device__ __forceinline__ void store_t4(bf16* p, float4 x) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w));
}
__device__ __forceinline__ void store_t4(float* p, float4 x) { *reinterpret_cast<float4*>(p) = x; }

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

template <typename T>
struct FeatureArgs {
  const float* k32;     // [B, M, D] f32
  const T* v;           // [B, M, D]
  const T* q;           // [B, N, D]
  const uint8_t* mask;  // [B, M] or null
  const float* proj;    // [F, dh] f32 (FAVOR)
  T* attn;              // [B, N, D]
  int H, N, M, D, F;
  int key_groups, tiles_per_warp, chunks_per_cta, qtiles_per_cta, resident;
  float ratio;  // F^-1/2
  Layout L;
};

// ---------------------------------------------------------------- the attention part

template <typename T, int KIND, int DH>
__global__ void __launch_bounds__(kFeatThreads, 1)
feature_attention(const FeatureArgs<T> a) {
  using E = typename Op<T>::Elem;
  constexpr int P = Op<T>::kPieces, PKV = Op<T>::kKvPieces, LD = DH + Op<T>::kPad;
  constexpr int KT = DH / 16, NT = DH / 8, RAW = DH + 4;
  constexpr int QH = query_rows<T>() / 16;  // 16-row halves of a warp's query tile
  constexpr float kDataNorm = Head<DH>::data_norm;
  extern __shared__ __align__(16) char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank()), C = static_cast<int>(cluster.num_blocks());
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int F = a.F, FT = F / 16, KG = a.key_groups, M = a.M, N = a.N, D = a.D;
  const int E4 = (F * DH + F) / 4;
  E* proj_s = reinterpret_cast<E*>(smem);
  float* ksum_s = reinterpret_cast<float*>(smem + a.L.ksum);
  float* cmax = reinterpret_cast<float*>(smem + a.L.cmax);
  float4* part = reinterpret_cast<float4*>(smem + a.L.stage);
  float* wts = reinterpret_cast<float*>(smem + a.L.wts);  // 1 valid, 0 masked, -1 past the key set
  E* keys_s = reinterpret_cast<E*>(smem + a.L.keys);     // resident T(k dh^-1/4) [chunks][64][LD]
  float* keys_diag = reinterpret_cast<float*>(smem + a.L.keys + a.chunks_per_cta * kChunk * LD * sizeof(E));
  E* kv_s = reinterpret_cast<E*>(smem + a.L.kv);
  E* q_s = reinterpret_cast<E*>(smem + a.L.stage) + warp * 2 * 16 * QH * LD;  // this warp's two query tiles
  constexpr int NV = key_stages<T>(), NK = KIND == kLinear ? NV : NV - 1;  // v and raw k buffers
  float* raw_s;  // raw k [NK][64][RAW]
  E *xk_s, *v_s;  // FAVOR: T(k dh^-1/4) [64][LD]; v [NV][64][LD]
  float* diag_s;  // |k dh^-1/4|^2 / 2
  auto set_stage = [&](int at) {  // a second feature tile per warp stages in KV's room
    raw_s = reinterpret_cast<float*>(smem + at);
    xk_s = reinterpret_cast<E*>(smem + at + a.L.xk);
    v_s = reinterpret_cast<E*>(smem + at + a.L.v);
    diag_s = reinterpret_cast<float*>(smem + at + a.L.diag);
  };
  const int chunks = (M + kChunk - 1) / kChunk;
  const int c_begin = rank * a.chunks_per_cta;
  const int c_end = min(chunks, c_begin + a.chunks_per_cta);
  // where chunk c's keys and diag are: resident, or the stage's
  auto xk_at = [&](int c) { return a.resident ? keys_s + (c - c_begin) * kChunk * LD : xk_s; };
  auto diag_at = [&](int c) { return a.resident ? keys_diag + (c - c_begin) * kChunk : diag_s; };
  // the mask weights of this CTA's keys, once (read by the sweeps after their first barrier)
  for (int i = tid; i < a.chunks_per_cta * kChunk; i += kFeatThreads) {
    const int m = c_begin * kChunk + i;
    wts[i] = m >= M ? -1.f : (a.mask == nullptr || a.mask[static_cast<size_t>(b) * M + m] != 0 ? 1.f : 0.f);
  }

  if constexpr (KIND != kLinear) {  // T(proj) [F][LD], by cp.async through KV's room
    float* pr = reinterpret_cast<float*>(kv_s);
    for (int i = tid; i < F * DH / 4; i += kFeatThreads) cp_async16(pr + 4 * i, a.proj + 4 * i, true);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int i = tid; i < F * DH / 4; i += kFeatThreads) {
      const int f = i / (DH / 4), c = (i % (DH / 4)) * 4;
      store_t4(proj_s + f * LD + c, *reinterpret_cast<const float4*>(pr + 4 * i));
    }
    __syncthreads();
  }

  const float* kb = a.k32 + static_cast<size_t>(b) * M * D + h * DH;
  const T* vb = a.v + static_cast<size_t>(b) * M * D + h * DH;

  // chunk c's (the i-th of this CTA's) raw keys (with_k) and v (with_v) into
  // their ring buffers by cp.async, then one commit, whether or not there
  // was a chunk c; rows past the key set are zero
  auto issue = [&](int c, int i, bool with_k, bool with_v) {
    const int m0 = c * kChunk;
    if (with_k && c < c_end) {
      float* raw = raw_s + (i % NK) * a.L.raw_bytes / 4;
      for (int i = tid; i < kChunk * DH / 4; i += kFeatThreads) {
        const int r = i / (DH / 4), col = (i % (DH / 4)) * 4;
        const bool ok = m0 + r < M;
        cp_async16(raw + r * RAW + col, kb + static_cast<size_t>(ok ? m0 + r : 0) * D + col, ok);
      }
    }
    if (with_v && c < c_end) {
      constexpr int kVec = 16 / sizeof(E);
      E* vbuf = v_s + (i % NV) * a.L.v_bytes / static_cast<int>(sizeof(E));
      for (int i = tid; i < kChunk * DH / kVec; i += kFeatThreads) {
        const int r = i / (DH / kVec), col = (i % (DH / kVec)) * kVec;
        const bool ok = m0 + r < M;
        cp_async16(vbuf + r * LD + col, vb + static_cast<size_t>(ok ? m0 + r : 0) * D + col, ok);
      }
    }
    cp_async_commit();
  };
  // from chunk c's raw keys, for FAVOR: T(k dh^-1/4) and (FAVOR-softmax)
  // |k dh^-1/4|^2 / 2
  auto convert = [&](int c) {
    float* dw = diag_at(c);
    if constexpr (KIND != kLinear) {
      E* xk = xk_at(c);
      const float* raw = raw_s + ((c - c_begin) % NK) * a.L.raw_bytes / 4;
      for (int i = tid; i < kChunk * DH / 4; i += kFeatThreads) {
        const int r = i / (DH / 4), col = (i % (DH / 4)) * 4;
        float4 x = *reinterpret_cast<const float4*>(raw + r * RAW + col);
        x = make_float4(x.x * kDataNorm, x.y * kDataNorm, x.z * kDataNorm, x.w * kDataNorm);
        store_t4(xk + r * LD + col, x);
        if constexpr (KIND == kFavorSoftmax) {  // DH / 4 neighbouring lanes hold row r
          float s = x.x * x.x + x.y * x.y + x.z * x.z + x.w * x.w;
#pragma unroll
          for (int o = DH / 8; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
          if (col == 0) dw[r] = 0.5f * s;
        }
      }
    }
  };
  // walk this CTA's chunks, the next NV - 1 copies in flight while body(i,
  // chunk) runs on the i-th; with_k false: the keys are resident
  auto sweep = [&](bool with_k, bool with_v, auto&& body) {
#pragma unroll
    for (int i = 0; i < NV - 1; ++i) issue(c_begin + i, i, with_k, with_v);
    for (int c = c_begin; c < c_end; ++c) {
      const int i = c - c_begin;
      cp_async_wait<NV - 2>();
      __syncthreads();  // chunk c has landed; the last chunk's products are done
      if (KIND != kLinear && with_k) {
        convert(c);
        __syncthreads();
      }
      issue(c + NV - 1, i + NV - 1, with_k, with_v);
      body(i, c);
    }
    cp_async_wait<0>();
    __syncthreads();  // the stage may be reused
  };

  // ph^T (or elu1p(k) for linear) of feature tile ft and the 16 keys at s16
  // of chunk c, the i-th of this CTA's
  auto key_tile = [&](float (&st)[2][4], int ft, int s16, int i, int c) {
    if constexpr (KIND == kLinear) {
      const float* k_s = raw_s + (i % NK) * a.L.raw_bytes / 4;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          st[j][e] = elu1p(k_s[(s16 + 8 * j + 2 * t + (e & 1)) * RAW + ft * 16 + g + 8 * (e >> 1)]) + kEluEps;
    } else {
      const E* xk = xk_at(c);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KT; ++ks) {
        uint32_t pa[P][4], pb[2][P][2];
        load_a<P>(pa, proj_s, LD, ft * 16, ks * 16, lane);
        load_b_rows<P>(pb, xk, LD, s16, ks * 16, lane);
        mma_rounds<P, P, 2>(st, pa, pb);
      }
    }
  };

  // ---- FAVOR-softmax: the key stabilizer, one max over the cluster's valid keys x features
  float stab = 0.f;
  if constexpr (KIND == kFavorSoftmax) {
    float mx = -INFINITY;
    for (int ti = 0; ti < a.tiles_per_warp; ++ti) {
      const int ft = warp / KG + kFeatWarps * ti, kg = warp % KG;
      set_stage(ti == 0 ? a.L.stage : a.L.kv);
      sweep(ti == 0 || !a.resident, false, [&](int buf, int c) {
        if (ft >= FT) return;
        const float* w = wts + (c - c_begin) * kChunk;
        for (int s = kg; s < kChunk / 16; s += KG) {
          float st[2][4];
          key_tile(st, ft, s * 16, buf, c);
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float wm = w[s * 16 + 8 * j + 2 * t + (e & 1)];
              if (wm >= 0.f) mx = fmaxf(mx, wm > 0.f ? st[j][e] : st[j][e] + kMasked);
            }
        }
      });
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (lane == 0) cmax[warp] = mx;
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < kFeatWarps; ++w) mx = fmaxf(mx, cmax[w]);
      cmax[kFeatWarps] = mx;
    }
    cluster.sync();
    stab = -INFINITY;
    for (int r = 0; r < C; ++r) stab = fmaxf(stab, cluster.map_shared_rank(cmax, r)[kFeatWarps]);
  }

  // ---- keys: partial KV and ksum of this CTA's chunks, per warp group
  for (int ti = 0; ti < a.tiles_per_warp; ++ti) {
    const int ft = warp / KG + kFeatWarps * ti, kg = warp % KG;
    float acc[NT][4] = {}, ks[2] = {};
    set_stage(ti == 0 ? a.L.stage : a.L.kv);
    sweep(!a.resident, true, [&](int buf, int c) {
      if (ft >= FT) return;
      // each chunk's product starts from zero and joins the sum in f32 (the
      // tensor cores round their accumulation toward zero)
      const E* vbuf = v_s + (buf % NV) * a.L.v_bytes / static_cast<int>(sizeof(E));
      const float* dw = diag_at(c);
      float prt[NT][4] = {};
      for (int s = kg; s < kChunk / 16; s += KG) {
        float st[2][4];
        key_tile(st, ft, s * 16, buf, c);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int m = s * 16 + 8 * j + 2 * t + (e & 1);
            const float w = wts[(c - c_begin) * kChunk + m];
            float y = st[j][e];
            if constexpr (KIND == kFavorRelu) y = fmaxf(y, 0.f) + kFavorEps;
            if constexpr (KIND == kFavorSoftmax) y = a.ratio * (exp_f(y - dw[m] - stab) + kFavorEps);
            y = w < 0.f ? 0.f : y * w;  // a masked key is multiplied by 0, as in the plain version
            st[j][e] = y;
            ks[e >> 1] += y;
          }
        uint32_t pa[P][4], pb[NT][P][2];
        acc_to_a<P>(pa, st[0], st[1]);
#pragma unroll
        for (int np = 0; np < DH / 16; ++np) load_b_cols<P>(pb + 2 * np, vbuf, LD, s * 16, np * 16, lane);
        mma_rounds<P, P, NT>(prt, pa, pb);
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] += prt[n][e];
    });
    if (ft < FT) {  // this warp group's partial: part[kg] = [KV (F x DH) | ksum (F)]
      float* pk = reinterpret_cast<float*>(part) + static_cast<size_t>(kg) * E4 * 4;
      const int f0 = ft * 16 + g;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int col = n * 8 + 2 * t;
        *reinterpret_cast<float2*>(pk + f0 * DH + col) = make_float2(acc[n][0], acc[n][1]);
        *reinterpret_cast<float2*>(pk + (f0 + 8) * DH + col) = make_float2(acc[n][2], acc[n][3]);
      }
      const float s0 = quad_sum(ks[0]), s1 = quad_sum(ks[1]);
      if (t == 0) {
        pk[F * DH + f0] = s0;
        pk[F * DH + f0 + 8] = s1;
      }
    }
  }

  // ---- the cluster's sum: each CTA adds one slice of the partials over the
  // cluster in a fixed order (key group, then CTA; the remote loads of a step
  // issued together) and stores the sum into every CTA's KV and ksum
  __syncthreads();
  cluster.sync();  // every partial written
  const int per = (E4 + C - 1) / C, i0 = rank * per;
  for (int i = i0 + tid; i < i0 + per && i < E4; i += kFeatThreads) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int kg = 0; kg < KG; ++kg) {
      float4 x[kMaxClusterCtas];
#pragma unroll
      for (int r = 0; r < kMaxClusterCtas; ++r)
        if (r < C) x[r] = cluster.map_shared_rank(part, r)[kg * E4 + i];
#pragma unroll
      for (int r = 0; r < kMaxClusterCtas; ++r)
        if (r < C) {
          s.x += x[r].x; s.y += x[r].y; s.z += x[r].z; s.w += x[r].w;
        }
    }
    const int e = 4 * i;
    if (e >= F * DH) {
      for (int r = 0; r < C; ++r) *reinterpret_cast<float4*>(cluster.map_shared_rank(ksum_s, r) + e - F * DH) = s;
    } else if constexpr (std::is_same<T, bf16>::value) {  // hi and lo planes
      const int at = (e / DH) * LD + e % DH;
      uint32_t s0[2], s1[2];
      split2<2>(s.x, s.y, s0);
      split2<2>(s.z, s.w, s1);
      for (int r = 0; r < C; ++r) {
        E* kv = cluster.map_shared_rank(kv_s, r);
        *reinterpret_cast<uint2*>(kv + at) = make_uint2(s0[0], s1[0]);
        *reinterpret_cast<uint2*>(kv + F * LD + at) = make_uint2(s0[1], s1[1]);
      }
    } else {
      for (int r = 0; r < C; ++r)
        *reinterpret_cast<float4*>(cluster.map_shared_rank(kv_s, r) + (e / DH) * LD + e % DH) = s;
    }
  }
  cluster.sync();  // every CTA's KV complete, and no partial read any more: a CTA may leave

  // ---- queries: 16 QH per warp (the halves share every B fragment); a warp's
  // next tile comes in by cp.async while it works on the current one (rows
  // past N are zero)
  constexpr int QR = 16 * QH;
  const int qtiles = (N + QR - 1) / QR;
  const int t_end = min(qtiles, (rank + 1) * a.qtiles_per_cta);
  const T* qb = a.q + static_cast<size_t>(b) * N * D + h * DH;
  auto issue_q = [&](int qt, int buf) {
    constexpr int kVec = 16 / sizeof(E);
    E* dst = q_s + buf * QR * LD;
    for (int i = lane; i < QR * DH / kVec; i += 32) {
      const int r = i / (DH / kVec), col = (i % (DH / kVec)) * kVec;
      const bool ok = qt * QR + r < N;
      cp_async16(dst + r * LD + col, qb + static_cast<size_t>(ok ? qt * QR + r : 0) * D + col, ok);
    }
    cp_async_commit();
  };
  int qt = rank * a.qtiles_per_cta + warp;
  if (qt < t_end) issue_q(qt, 0);
  for (int buf = 0; qt < t_end; qt += kFeatWarps, buf ^= 1) {
    if (qt + kFeatWarps < t_end) issue_q(qt + kFeatWarps, buf ^ 1);
    else cp_async_commit();  // an empty group: the wait below counts alike
    cp_async_wait<1>();
    __syncwarp();
    const E* qs = q_s + buf * QR * LD;
    uint32_t xa[QH][KT][P][4];
    float diag[QH][2] = {}, rmax[QH][2] = {};
    if constexpr (KIND != kLinear) {  // A fragments of T(q dh^-1/4)
#pragma unroll
      for (int hq = 0; hq < QH; ++hq) {
        float dsum[2] = {};
#pragma unroll
        for (int ks = 0; ks < KT; ++ks)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int hh = i & 1, col = ks * 16 + 2 * t + 8 * (i >> 1);
            float2 x = load2(qs + (hq * 16 + g + 8 * hh) * LD + col);
            x = make_float2(x.x * kDataNorm, x.y * kDataNorm);
            dsum[hh] += x.x * x.x + x.y * x.y;
            uint32_t s[P];
            split2<P>(x.x, x.y, s);
#pragma unroll
            for (int q = 0; q < P; ++q) xa[hq][ks][q][i] = s[q];
          }
        diag[hq][0] = 0.5f * quad_sum(dsum[0]);
        diag[hq][1] = 0.5f * quad_sum(dsum[1]);
      }
    }
    // ph (or elu1p(q) for linear) of the tile's rows and features fc * 16 ..
    auto query_tile = [&](float (&st)[QH][2][4], int fc) {
      if constexpr (KIND == kLinear) {
#pragma unroll
        for (int hq = 0; hq < QH; ++hq)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const float2 x = load2(qs + (hq * 16 + g + 8 * hh) * LD + fc * 16 + 8 * j + 2 * t);
              st[hq][j][2 * hh] = elu1p(x.x) + kEluEps;
              st[hq][j][2 * hh + 1] = elu1p(x.y) + kEluEps;
            }
      } else {
#pragma unroll
        for (int hq = 0; hq < QH; ++hq)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) st[hq][j][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KT; ++ks) {
          uint32_t pb[2][P][2];
          load_b_rows<P>(pb, proj_s, LD, fc * 16, ks * 16, lane);
#pragma unroll
          for (int hq = 0; hq < QH; ++hq) mma_rounds<P, P, 2>(st[hq], xa[hq][ks], pb);
        }
      }
    };
    if constexpr (KIND == kFavorSoftmax) {  // the row max of ph needs every feature first
#pragma unroll
      for (int hq = 0; hq < QH; ++hq) rmax[hq][0] = rmax[hq][1] = -INFINITY;
      for (int fc = 0; fc < FT; ++fc) {
        float st[QH][2][4];
        query_tile(st, fc);
#pragma unroll
        for (int hq = 0; hq < QH; ++hq)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            rmax[hq][0] = fmaxf(rmax[hq][0], fmaxf(st[hq][j][0], st[hq][j][1]));
            rmax[hq][1] = fmaxf(rmax[hq][1], fmaxf(st[hq][j][2], st[hq][j][3]));
          }
      }
#pragma unroll
      for (int hq = 0; hq < QH; ++hq) {
        rmax[hq][0] = quad_max(rmax[hq][0]);
        rmax[hq][1] = quad_max(rmax[hq][1]);
      }
    }
    float o[QH][NT][4] = {}, nrm[QH][2] = {};
    for (int fc = 0; fc < FT; ++fc) {
      float st[QH][2][4];
      query_tile(st, fc);
      uint32_t pa[QH][P][4], pb[NT][PKV][2];
#pragma unroll
      for (int hq = 0; hq < QH; ++hq) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int hh = e >> 1;
            float y = st[hq][j][e];
            if constexpr (KIND == kFavorRelu) y = fmaxf(y, 0.f) + kFavorEps;
            if constexpr (KIND == kFavorSoftmax) y = a.ratio * (exp_f(y - diag[hq][hh] - rmax[hq][hh]) + kFavorEps);
            st[hq][j][e] = y;
            nrm[hq][hh] = fmaf(y, ksum_s[fc * 16 + 8 * j + 2 * t + (e & 1)], nrm[hq][hh]);
          }
        acc_to_a<P>(pa[hq], st[hq][0], st[hq][1]);
      }
#pragma unroll
      for (int np = 0; np < DH / 16; ++np) load_kv<T, PKV>(pb + 2 * np, kv_s, F * LD, LD, fc * 16, np * 16, lane);
#pragma unroll
      for (int hq = 0; hq < QH; ++hq) mma_rounds<P, PKV, NT>(o[hq], pa[hq], pb);
    }
    T* out = a.attn + static_cast<size_t>(b) * N * D + h * DH + 2 * t;
#pragma unroll
    for (int hq = 0; hq < QH; ++hq) {
      // o / norm as o times the row's reciprocal (within an ulp of the
      // quotient; 64 divisions a thread took a third of the query side)
      const float i0 = 1.f / quad_sum(nrm[hq][0]), i1 = 1.f / quad_sum(nrm[hq][1]);
      const int r0 = qt * QR + hq * 16 + g, r1 = r0 + 8;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        if (r0 < N) store2(out + static_cast<size_t>(r0) * D + n * 8, o[hq][n][0] * i0, o[hq][n][1] * i0);
        if (r1 < N) store2(out + static_cast<size_t>(r1) * D + n * 8, o[hq][n][2] * i1, o[hq][n][3] * i1);
      }
    }
    __syncwarp();  // every lane is done with this tile before the next copy into it
  }
}

template <typename T, int KIND, int DH>
cudaError_t launch_attention(const FeaturePlan& p, int B, const FeatureArgs<T>& args, cudaStream_t s) {
  auto kernel = feature_attention<T, KIND, DH>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.L.total);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(p.cluster, B * args.H);
  config.blockDim = dim3(kFeatThreads);
  config.dynamicSmemBytes = p.L.total;
  config.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  if ((err = cudaLaunchKernelEx(&config, kernel, args)) != cudaSuccess) return err;
  return cudaGetLastError();
}

struct Buffers {
  void *q, *k32, *v, *attn, *cat, *h1;
};

Buffers carve(Carve& ws, int B, int N, int M, int D, size_t elt) {
  const size_t rq = static_cast<size_t>(B) * N, rk = static_cast<size_t>(B) * M;
  Buffers p;
  p.q = ws.take<char>(rq * D * elt);
  p.k32 = ws.take<float>(rk * D);
  p.v = ws.take<char>(rk * D * elt);
  p.attn = ws.take<char>(rq * D * elt);
  p.cat = ws.take<char>(rq * 2 * D * elt);
  p.h1 = ws.take<char>(rq * 2 * D * elt);
  return p;
}

template <typename T, int KIND, int DH>
int layer(int B, int N, int M, int D, int H, int F, int use_offset, const void* xq_,
          const void* xkv_, const void* mask_, const void* const* w, const float* const* f,
          const float* proj, void* ws_, void* out_, cudaStream_t s) {
  const T* xq = static_cast<const T*>(xq_);
  const T* xkv = static_cast<const T*>(xkv_);
  const T *wq = static_cast<const T*>(w[0]), *wk = static_cast<const T*>(w[1]),
          *wv = static_cast<const T*>(w[2]), *wo = static_cast<const T*>(w[3]),
          *w1 = static_cast<const T*>(w[4]), *w2 = static_cast<const T*>(w[5]);
  const float *bq = f[0], *bk = f[1], *bv = f[2], *bo = f[3], *b1 = f[4], *a1 = f[5], *c1 = f[6],
              *b2 = f[7];
  Carve ws{static_cast<char*>(ws_)};
  const Buffers p = carve(ws, B, N, M, D, sizeof(T));
  T *q = static_cast<T*>(p.q), *v = static_cast<T*>(p.v), *attn = static_cast<T*>(p.attn),
    *cat = static_cast<T*>(p.cat), *h1 = static_cast<T*>(p.h1), *out = static_cast<T*>(out_);
  float* k32 = static_cast<float*>(p.k32);
  const int nq = B * N, nk = B * M;
  cudaError_t err;
  // k stays f32 into the feature map; v and q are cast to T
  if ((err = gemm<T, kBiasF32>({xkv, D, wk, bk, nk, D, D, reinterpret_cast<T*>(k32), D, nullptr, 0, nullptr, nullptr, 0}, s))) return err;
  if ((err = gemm<T, kBias>({xkv, D, wv, bv, nk, D, D, v, D, nullptr, 0, nullptr, nullptr, 0}, s))) return err;
  if ((err = gemm<T, kBias>({xq, D, wq, bq, nq, D, D, q, D, nullptr, 0, nullptr, nullptr, 0}, s))) return err;
  const FeaturePlan plan = make_feature_plan(B, H, N, M, F, DH, std::is_same<T, bf16>::value, KIND, sm_count());
  if (plan.L.total > kSmemCap) return cudaErrorInvalidValue;
  const FeatureArgs<T> args{k32, v, q, static_cast<const uint8_t*>(mask_), proj, attn, H, N, M, D, F,
                            plan.key_groups, plan.tiles_per_warp, plan.chunks_per_cta, plan.qtiles_per_cta,
                            plan.resident, static_cast<float>(1.0 / sqrt(static_cast<double>(F))), plan.L};
  if ((err = launch_attention<T, KIND, DH>(plan, B, args, s))) return err;
  // out projection with the concat, then the FFN, as in the softmax layer
  if ((err = gemm<T, kConcat>({attn, D, wo, bo, nq, D, D, cat, 2 * D, xq, D, nullptr, nullptr, use_offset}, s))) return err;
  if ((err = gemm<T, kReluAffine>({cat, 2 * D, w1, b1, nq, 2 * D, 2 * D, h1, 2 * D, nullptr, 0, a1, c1, 0}, s))) return err;
  return gemm<T, kResidual>({h1, 2 * D, w2, b2, nq, D, 2 * D, out, D, xq, D, nullptr, nullptr, 0}, s);
}

template <typename T>
int layer_of_kind(int kind, int B, int N, int M, int D, int H, int F, int use_offset,
                  const void* xq, const void* xkv, const void* mask, const void* const* w,
                  const float* const* f, const float* proj, void* ws, void* out, cudaStream_t s) {
  return with_head_width(D / H, [&](auto width) -> cudaError_t {
    constexpr int DH = decltype(width)::value;
    switch (kind) {
      case kLinear: return static_cast<cudaError_t>(layer<T, kLinear, DH>(B, N, M, D, H, F, use_offset, xq, xkv, mask, w, f, proj, ws, out, s));
      case kFavorRelu: return static_cast<cudaError_t>(layer<T, kFavorRelu, DH>(B, N, M, D, H, F, use_offset, xq, xkv, mask, w, f, proj, ws, out, s));
      case kFavorSoftmax: return static_cast<cudaError_t>(layer<T, kFavorSoftmax, DH>(B, N, M, D, H, F, use_offset, xq, xkv, mask, w, f, proj, ws, out, s));
    }
    return cudaErrorInvalidValue;
  });
}

bool shape_ok(int D, int H, int M, int F, int kind) {
  if (!head_width_ok(D, H) || D % 64 != 0 || M <= 0) return false;
  if (F % 16 != 0 || F <= 0 || F > kMaxFeatures || (kind == kLinear && F != D / H)) return false;
  return kind >= kLinear && kind <= kFavorSoftmax;
}

}  // namespace

// Bytes of workspace og_gnn_layer_features needs.
extern "C" size_t og_gnn_layer_features_workspace(int is_bf16, int B, int N, int M, int D, int H,
                                                  int F) {
  (void)F;
  Carve ws{nullptr};
  carve(ws, B, N, M, D, is_bf16 ? 2 : 4);
  return ws.used;
}

// The attention part's plan on the current card: out [8] = CTAs per (element,
// head) (the cluster), key groups, feature tiles per warp, 64-key chunks per
// CTA, query tiles per CTA, whether FAVOR-softmax's keys stay resident,
// shared-memory bytes per CTA, and the SM count. Returns a CUDA error code (cudaErrorInvalidValue for a shape the
// layer refuses).
extern "C" int og_gnn_layer_features_plan(int is_bf16, int B, int N, int M, int D, int H, int F, int kind,
                                          int* out) {
  if (!shape_ok(D, H, M, F, kind)) return cudaErrorInvalidValue;
  const int sms = sm_count();
  const FeaturePlan p = make_feature_plan(B, H, N, M, F, D / H, is_bf16 != 0, kind, sms);
  const int v[8] = {p.cluster, p.key_groups, p.tiles_per_warp, p.chunks_per_cta, p.qtiles_per_cta, p.resident,
                    p.L.total, sms};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return cudaSuccess;
}

// One layer. is_bf16 selects the compute type T of x and the weights; kind is 0
// linear (F = dh, proj unused), 1 favor_relu, 2 favor_softmax (proj: f32 [F, dh], F a
// multiple of 16 up to 256). weights (T, [out, in]): wq, wk, wv, wo [D, D], w1
// [2D, 2D], w2 [D, 2D]. f32 vectors: bq, bk, bv, bo [D], b1, a1, c1 [2D], b2 [D].
// mask: [B, M] uint8 or null. out (T): [B, N, D]. D = dh * H with dh 32 or 64.
// Returns the CUDA error code of the launches (0 on success).
extern "C" int og_gnn_layer_features(int is_bf16, int B, int N, int M, int D, int H, int F,
                                     int kind, int use_offset, const void* xq, const void* xkv,
                                     const void* mask, const void* const* weights,
                                     const void* const* vectors, const void* proj,
                                     void* workspace, void* out, void* stream) {
  if (B == 0 || N == 0) return cudaSuccess;
  if (!shape_ok(D, H, M, F, kind)) return cudaErrorInvalidValue;
  if (kind != kLinear && proj == nullptr) return cudaErrorInvalidValue;
  const float* const* f = reinterpret_cast<const float* const*>(vectors);
  const float* pr = static_cast<const float*>(proj);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return layer_of_kind<bf16>(kind, B, N, M, D, H, F, use_offset, xq, xkv, mask, weights, f, pr, workspace, out, s);
  return layer_of_kind<float>(kind, B, N, M, D, H, F, use_offset, xq, xkv, mask, weights, f, pr, workspace, out, s);
}
