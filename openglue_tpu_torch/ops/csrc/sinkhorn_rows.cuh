// The on-chip Sinkhorn engine shared by the fused forward (sinkhorn.cu) and
// its adjoint (sinkhorn_adjoint.cu): the launch plan, a CTA's stripe of K held
// in shared memory, the two passes over it and the exchange of column sums
// between the CTAs of one batch element.
//
// Per batch element, P CTAs each own a contiguous stripe of S = ceil(R / P)
// rows of K = exp(M - rmax), formed once from M and kept in shared memory
// across every iteration. Only where the card as a whole has no room for an
// element do the rows past a CTA's shared memory go to device memory
// (spilled rows, read from L2 in every pass); the plan avoids that wherever
// it can. (Rows held in registers, one 16-byte vector a thread, were tried
// as a second tier and dropped: they spill, and with 229 KB of shared memory
// the L1 that would catch the spills is 27 KB.)
//
// The wide forward (K2s, past the fused kernel's columns, where an element
// is often larger than the card's shared memory) reads its spilled rows once
// per iteration: they come in turn through a ring of ``stages`` one-row
// buffers in shared memory, filled by bulk copies that complete on an
// mbarrier each (``sweep``). On each row the CTA forms the row's dot with the
// vector (a block reduction), its u, and adds u_i K_ij into the column sums
// of its threads' column vectors, held in registers until the columns pass
// adds the shared-memory rows to them: the one pass per stripe of the TPU's
// _blocked_scale_kernel. The ring's bytes come out of the shared-memory
// rows; the plan (``make_wide_plan``) keeps them few, so that the workspace
// stays small. Where an element spans many clusters its exchange has two
// levels (``two_level``): cluster sums meet in device memory, each CTA adds
// all clusters' sums of a 1/G part of its slice and posts that part of the
// next vector, and each CTA gathers its slice from those parts, so that the
// reads per exchange grow as G C rather than G^2 C.
//
// The P CTAs of an element form G clusters of cs CTAs (P = G * cs). Each
// iteration is a rows pass (a warp per row, up to six rows at a time, four
// with bf16 K, so that each read of the vector serves them all), then a
// columns pass (a thread per 16-byte column vector, summing coef_i K_ij over
// the stripe in registers), then the exchange, all by asynchronous stores
// into distributed shared memory that complete on the receiver's mbarrier (a
// store does not wait, a remote load or a cluster barrier would): the columns
// pass stores each slice of its sums into the slice owner's receive buffer
// (a reduce-scatter); the owner adds its slice over the cluster in rank
// order, forms those entries of the next vector and stores them into every
// peer's vector (a gather). A CTA waits only for the bytes it receives; the
// data dependencies order the reuse of both buffers (a peer can send the next
// sums only after it has the whole vector, which includes this CTA's slice,
// formed after its reads). Where an element spans G > 1 clusters, the
// clusters' slice sums meet in device memory: each float travels in an 8-byte
// word beside the exchange's number, so a reader polls the data itself (a
// word is written whole) and adds the clusters' sums in cluster order once
// every word carries this exchange's number (the protocol of NCCL's LL
// transfers); that launch is cooperative, so every CTA that polls is
// resident. Every sum is taken in a fixed order and no value goes through an
// atomic: two runs are bit-equal.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kStripeThreads = 384;  // a CTA of the on-chip kernels
constexpr int kStripeWarps = kStripeThreads / 32;
constexpr int kThreads = 256;  // a block of the streaming kernels (sinkhorn.cu)
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;  // the largest cluster the plan asks for (non-portable above 8)
constexpr int kSmemLimit = 232448;  // the shared memory one block may opt into on the H100
constexpr float kTiny = 1e-30f;
constexpr int kRingBars = 4;  // mbarriers reserved for the ring (32 bytes: the row values stay 16-byte aligned)
// the wide plan's exchange has two levels past this many clusters per element
constexpr int kFlatMaxGroups = 8;

template <typename KT> struct Store;
template <> struct Store<float> {
  static constexpr int kVec = 4;  // elements per 16-byte vector
  __device__ static void unpack(const uint4& raw, float* out) {
    out[0] = __uint_as_float(raw.x); out[1] = __uint_as_float(raw.y);
    out[2] = __uint_as_float(raw.z); out[3] = __uint_as_float(raw.w);
  }
  __device__ static uint4 pack(const float* in) {
    return make_uint4(__float_as_uint(in[0]), __float_as_uint(in[1]), __float_as_uint(in[2]),
                      __float_as_uint(in[3]));
  }
  __device__ static void pack_store(float* dst, const float* in) {
    *reinterpret_cast<uint4*>(dst) = pack(in);
  }
};
template <> struct Store<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static void unpack(const uint4& raw, float* out) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(p[i]);
      out[2 * i] = f.x; out[2 * i + 1] = f.y;
    }
  }
  __device__ static uint4 pack(const float* in) {
    uint4 raw;
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
    return raw;
  }
  __device__ static void pack_store(__nv_bfloat16* dst, const float* in) {
    *reinterpret_cast<uint4*>(dst) = pack(in);
  }
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// ---------------------------------------------------------------- the plan (host)
//
// Mirrored in ops/kernels/sinkhorn_kernel.py::launch_plan; a change here is a
// change there.

struct Plan {
  int cs;          // CTAs per cluster
  int groups;      // G, clusters per element
  int ctas;        // P = cs * G, CTAs per element
  int slots;       // elements in flight at once
  int waves;       // groups of elements taken in turn: ceil(B / slots)
  int grid;        // CTAs launched
  int rows;        // S, rows per CTA
  int smem_rows, spill_rows;  // S in shared memory and in device memory
  int smem_bytes;  // dynamic shared memory per CTA
  int cooperative;
  int stages;      // one-row buffers of the ring that streams the spilled rows (the wide plan)
  int ring_bytes;  // shared memory of the ring: its buffers, mbarriers and block-reduction slots
  int col_vecs;    // 16-byte column vectors a thread sums in registers (the wide plan; 2, 4 or 8)
  int exchange_levels;  // 0: one cluster per element; 1: every CTA polls every cluster; 2: two levels
  long long exchange_bytes;  // device memory for the cross-cluster exchange
  long long workspace_bytes;  // exchange and spilled rows
};

inline int fixed_smem_bytes(int C) {
  // the vector, the receive buffer (a slice per peer, up to kMaxCluster
  // float4 of rounding) and two mbarriers
  return 4 * C + (4 * C + 16 * kMaxCluster) + 16;
}

// rows of an S-row stripe that shared memory holds next to the vectors and
// the stripe's three per-row values
inline int smem_rows_for(int S, int C, int kbytes) {
  const int room = kSmemLimit - fixed_smem_bytes(C) - 12 * S;
  if (room <= 0) return 0;
  const int fit = room / (C * kbytes);
  return fit < S ? fit : S;
}

// caps[i]: clusters of 1 << i CTAs the card holds at once (i = 0..4), for a
// CTA at the full shared memory; sms: the card's SM count.
inline Plan make_plan(int B, int R, int C, int kbytes, int sms, const int* caps) {
  Plan p = {};
  // the most rows one CTA holds in shared memory
  int on_chip = kSmemLimit / (C * kbytes) + 1;
  while (on_chip > 1 && smem_rows_for(on_chip, C, kbytes) < on_chip) --on_chip;
  const int p_min = (R + on_chip - 1) / on_chip;
  int log_cs = -1;
  for (int i = 0; i <= 4; ++i) {
    if ((1 << i) >= p_min && caps[i] > 0) { log_cs = i; break; }
  }
  if (log_cs >= 0) {
    // one cluster per element: widen it while the card has room for every element
    while (log_cs < 4 && B * (2 << log_cs) <= sms && caps[log_cs + 1] > 0) ++log_cs;
    p.cs = 1 << log_cs;
    p.groups = 1;
    p.ctas = p.cs;
    p.slots = B < caps[log_cs] ? B : caps[log_cs];
    p.grid = B * p.ctas;  // the hardware runs the clusters as SMs free up
  } else {
    // several clusters per element, all resident at once (cooperative): of
    // the cluster sizes 16, 8, 4, 2, the one that spills the fewest rows,
    // then takes the fewest waves, then fills the most SMs, then needs the
    // fewest clusters (each adds a read to every exchange)
    long long best = -1;
    for (int i = 4; i >= 1; --i) {
      const int cs = 1 << i, cap = caps[i] * cs;
      if (cap == 0) continue;
      int groups = (p_min + cs - 1) / cs;
      if (groups * cs > cap) groups = cap / cs;  // past the card's on-chip room: the rest spills
      const int ctas = groups * cs;
      const int slots = cap / ctas < B ? cap / ctas : B;
      const int waves = (B + slots - 1) / slots;
      const int rows = (R + ctas - 1) / ctas;
      const long long key = (rows > on_chip ? static_cast<long long>(rows) : 0LL) * (1LL << 40) +
                            static_cast<long long>(waves) * (1LL << 24) +
                            static_cast<long long>(1024 - slots * ctas) * (1LL << 12) + groups;
      if (best < 0 || key < best) {
        best = key;
        p.cs = cs;
        p.groups = groups;
        p.ctas = ctas;
        p.slots = slots;
      }
    }
    p.grid = p.slots * p.ctas;
    p.cooperative = p.groups > 1;
  }
  if (p.ctas == 0 || p.slots == 0) return Plan{};
  p.exchange_levels = p.groups > 1 ? 1 : 0;
  p.waves = (B + p.slots - 1) / p.slots;
  p.rows = (R + p.ctas - 1) / p.ctas;
  p.smem_rows = smem_rows_for(p.rows, C, kbytes);
  p.spill_rows = p.rows - p.smem_rows;
  p.smem_bytes = p.smem_rows * C * kbytes + fixed_smem_bytes(C) + 12 * p.rows;
  if (p.smem_bytes > kSmemLimit) return Plan{};
  // two buffers (by the exchange's parity) of every cluster's sums, a float
  // and the exchange's number per 8 bytes
  if (p.groups > 1) p.exchange_bytes = 2LL * p.slots * p.groups * C * 8;
  p.workspace_bytes = p.exchange_bytes + static_cast<long long>(p.grid) * p.spill_rows * C * kbytes;
  return p;
}

// shared memory of a ring of ``stages`` one-row buffers: the buffers, the
// mbarriers and two slots per warp for the block reduction of a row's dot
inline int ring_bytes_for(int stages, int C, int kbytes) {
  return stages * C * kbytes + 8 * kRingBars + 2 * kStripeWarps * 4;
}

// The wide forward's plan (K2s): make_plan's layout of CTAs and clusters;
// where rows spill, a ring of two one-row buffers taken out of the
// shared-memory rows, and the spilled rows read through it (a third buffer
// costs a shared-memory row and gains nothing: scripts/sinkhorn_ablations.py);
// the column vectors a thread sums (the fewest of 2, 4, 8 that cover the
// row); two exchange levels past kFlatMaxGroups clusters per element. An
// empty plan past its reach: more columns than 8 vectors a thread cover, or
// no room for the ring beside the per-column buffers.
inline Plan make_wide_plan(int B, int R, int C, int kbytes, int sms, const int* caps) {
  Plan p = make_plan(B, R, C, kbytes, sms, caps);
  if (p.ctas == 0) return Plan{};
  const int nvec = C * kbytes / 16;
  p.col_vecs = nvec <= 2 * kStripeThreads ? 2 : nvec <= 4 * kStripeThreads ? 4 : nvec <= 8 * kStripeThreads ? 8 : 0;
  if (p.col_vecs == 0) return Plan{};
  if (p.spill_rows > 0) {
    const int fixed = fixed_smem_bytes(C) + 12 * p.rows;
    p.stages = 2;
    p.ring_bytes = ring_bytes_for(p.stages, C, kbytes);
    if (fixed + p.ring_bytes > kSmemLimit) return Plan{};
    const int fit = (kSmemLimit - fixed - p.ring_bytes) / (C * kbytes);
    p.smem_rows = fit < p.rows ? fit : p.rows;
    p.spill_rows = p.rows - p.smem_rows;
    p.smem_bytes = p.smem_rows * C * kbytes + fixed + p.ring_bytes;
  }
  if (p.groups > kFlatMaxGroups) {
    // single buffers: a CTA posts the next exchange's sums only after every
    // CTA that reads them has read this exchange's (see two_level)
    p.exchange_levels = 2;
    p.exchange_bytes = static_cast<long long>(p.slots) * (p.groups + 1) * C * 8;
  }
  p.workspace_bytes = p.exchange_bytes + static_cast<long long>(p.grid) * p.spill_rows * C * kbytes;
  return p;
}

// the plan as og_sinkhorn_plan / og_sinkhorn_adjoint_plan /
// og_sinkhorn_wide_plan report it: out [21] ints (the plan's first fifteen
// fields, the SM count, caps), bytes [2] (the exchange's and the whole
// workspace's)
inline void plan_report(const Plan& p, const int* caps, int sms, int* out, long long* bytes) {
  const int v[16] = {p.cs, p.groups, p.ctas, p.slots, p.waves, p.grid, p.rows, p.smem_rows,
                     p.spill_rows, p.smem_bytes, p.cooperative, p.stages, p.ring_bytes, p.col_vecs,
                     p.exchange_levels, sms};
  for (int i = 0; i < 16; ++i) out[i] = v[i];
  for (int i = 0; i < 5; ++i) out[16 + i] = caps[i];
  bytes[0] = p.exchange_bytes;
  bytes[1] = p.workspace_bytes;
}

// caps[] of ``kernel`` on the current device (cached per device): clusters of
// 1, 2, 4, 8, 16 CTAs of kStripeThreads threads at the full shared memory.
template <typename Kernel>
cudaError_t cluster_caps(Kernel kernel, int* caps, int* sms, int (&cache)[8][6]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 8) return cudaErrorInvalidDevice;
  if (cache[dev][5] == 0) {
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit)) !=
        cudaSuccess)
      return err;
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) != cudaSuccess)
      return err;
    for (int i = 0; i <= 4; ++i) {
      cudaLaunchConfig_t config = {};
      config.gridDim = dim3(1 << i);
      config.blockDim = dim3(kStripeThreads);
      config.dynamicSmemBytes = kSmemLimit;
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = 1 << i;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      config.attrs = attr;
      config.numAttrs = 1;
      int n = 0;
      if (cudaOccupancyMaxActiveClusters(&n, kernel, &config) != cudaSuccess) {
        cudaGetLastError();  // a size the card cannot place reads as none
        n = 0;
      }
      cache[dev][i] = n;
    }
    int count = 0;
    if ((err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
    cache[dev][5] = count;
  }
  for (int i = 0; i <= 4; ++i) caps[i] = cache[dev][i];
  *sms = cache[dev][5];
  return cudaSuccess;
}

// Launch ``kernel`` on ``plan`` (cluster dimension, cooperative where the
// element spans clusters); zeroes the exchange buffers first, so that no
// word carries an exchange's number before it is written.
template <typename Kernel, typename... Args>
cudaError_t launch_planned(const Plan& p, Kernel kernel, void* workspace, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (err != cudaSuccess) return err;
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) != cudaSuccess)
    return err;
  if (p.groups > 1) {
    err = cudaMemsetAsync(workspace, 0, p.exchange_bytes, stream);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(p.grid);
  config.blockDim = dim3(kStripeThreads);
  config.dynamicSmemBytes = p.smem_bytes;
  config.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  config.attrs = attr;
  config.numAttrs = p.cooperative ? 2 : 1;
  err = cudaLaunchKernelEx(&config, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ---------------------------------------------------------------- the stripe (device)

// What the kernel receives of the plan.
struct Shape {
  int B, R, C;
  int ctas, groups, rows, smem_rows;
  long long exchange_bytes;
  int stages, exchange_levels;  // the wide plan's ring and exchange (0 in K2's and K3's)
};

__device__ __forceinline__ void add4(float4& s, const float4& x) {
  s.x += x.x; s.y += x.y; s.z += x.z; s.w += x.w;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// the address of the same shared-memory location in cluster peer ``rank``
__device__ __forceinline__ uint32_t peer_addr(uint32_t local, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(local), "r"(rank));
  return remote;
}
__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}
// this phase's one arrival, with the bytes the peers' stores bring
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}
// a 16-byte store into a peer's shared memory that completes on its mbarrier
__device__ __forceinline__ void push4(uint32_t remote, uint32_t remote_bar, const float4& v) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(
                   remote),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(remote_bar)
               : "memory");
}
// ``bytes`` (a multiple of 16) from device memory into this CTA's shared
// memory, completing on its mbarrier ``bar``
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes), "r"(smem_u32(bar))
               : "memory");
}

template <typename KT>
struct Stripe {
  static constexpr int V = Store<KT>::kVec;
  // rows one warp reads at a time in the rows pass (bf16 K unpacks twice the
  // elements per load, and spills at six)
  static constexpr int kRowBlock = V == 4 ? 6 : 4;

  // geometry
  int C, nvec, nq;                 // columns, 16-byte vectors of K per row, float4 groups per row
  int ns;                          // the plan's shared-memory rows per CTA
  int stages, levels;              // the ring's buffers (0: none); the exchange's levels
  int P, G, cs, rank, g, part, slot, nslots;
  int lo, hi, width;               // this CTA's slice of the float4 groups; the widest slice
  // this element
  int r0, n, n_s, n_o;             // first row, rows, and rows in shared and in device memory
  // shared memory
  KT* ks;                          // [ns][C]
  KT* ring;                        // [stages][C] the spilled rows in turn (the wide kernel)
  float* vec;                      // [C] the vector of the rows pass (laid out by vec_slot)
  float4* recv;                    // [cs][width] the peers' column sums of this CTA's slice
  uint64_t* bars;                  // [2]: the receive buffer's and vec's mbarriers
  float* coef;                     // [S] the row values of the current pass
  float* rowa;                     // [S] a_i = exp(log_a_i)
  float* rowm;                     // [S] rmax_i
  uint64_t* ring_bars;             // [stages] a ring buffer's mbarrier (kRingBars reserved)
  float* dots;                     // [2][kStripeWarps] each warp's share of a spilled row's dot
  // device memory
  KT* kg;                          // this CTA's spilled rows [S - ns][C]
  uint4* xchg;                     // [2][slots][G][C / 4][2]: per float, the float and its exchange's number
                                   // (two levels: [slots][G][C / 4][2], then the next vector [slots][C / 4][2])
  uint32_t phase;                  // exchanges done (the parity of both mbarriers)
  uint32_t ring_seq;               // spilled rows read through the ring before this element

  __device__ Stripe(unsigned char* smem, const Shape& s, void* workspace, cg::cluster_group& cluster) {
    C = s.C; nvec = s.C / V; nq = s.C / 4;
    ns = s.smem_rows;
    stages = s.stages; levels = s.exchange_levels;
    P = s.ctas; G = s.groups; cs = static_cast<int>(cluster.num_blocks());
    rank = static_cast<int>(cluster.block_rank());
    part = blockIdx.x % P; g = part / cs; slot = blockIdx.x / P; nslots = gridDim.x / P;
    lo = rank * nq / cs; hi = (rank + 1) * nq / cs; width = (nq + cs - 1) / cs;
    ks = reinterpret_cast<KT*>(smem);
    ring = ks + static_cast<size_t>(ns) * C;
    vec = reinterpret_cast<float*>(ring + static_cast<size_t>(stages) * C);
    recv = reinterpret_cast<float4*>(vec + C);
    bars = reinterpret_cast<uint64_t*>(recv + nq + kMaxCluster);
    ring_bars = bars + 2;
    // the ring's mbarriers and the warps' shares of a row's dot (16-byte
    // aligned, as coef after them)
    dots = reinterpret_cast<float*>(ring_bars + kRingBars);
    coef = stages > 0 ? dots + 2 * kStripeWarps : reinterpret_cast<float*>(ring_bars);
    rowa = coef + s.rows;
    rowm = rowa + s.rows;
    char* ws = static_cast<char*>(workspace);
    xchg = reinterpret_cast<uint4*>(ws);
    kg = reinterpret_cast<KT*>(ws + s.exchange_bytes) + static_cast<size_t>(blockIdx.x) * (s.rows - ns) * C;
    phase = 0;
    ring_seq = 0;
  }

  // Before the first exchange: the mbarriers, initialized where every peer
  // may store to them (ends with a cluster barrier).
  __device__ void init(cg::cluster_group& cluster) {
    if (threadIdx.x == 0) {
      bar_init(bars);
      bar_init(bars + 1);
      for (int i = 0; i < stages; ++i) bar_init(full_bar(i));
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    cluster.sync();
  }

  __device__ void begin(int R, int S) {
    r0 = part * S;
    n = R - r0 < S ? R - r0 : S;
    if (n < 0) n = 0;
    n_s = n < ns ? n : ns;
    n_o = n - n_s;
  }

  // rmax_i of every own row of Mb (a warp per row, two rows at a time) into rowm
  __device__ void row_max(const float* Mb) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int lr = warp; lr < n; lr += 2 * kStripeWarps) {
      const int lr1 = lr + kStripeWarps < n ? lr + kStripeWarps : lr;
      const float* m0 = Mb + static_cast<size_t>(r0 + lr) * C;
      const float* m1 = Mb + static_cast<size_t>(r0 + lr1) * C;
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll 8
      for (int j = lane; j < nq; j += 32) {
        const float4 x = *reinterpret_cast<const float4*>(m0 + 4 * j);
        const float4 z = *reinterpret_cast<const float4*>(m1 + 4 * j);
        mx0 = fmaxf(mx0, fmaxf(fmaxf(x.x, x.y), fmaxf(x.z, x.w)));
        mx1 = fmaxf(mx1, fmaxf(fmaxf(z.x, z.y), fmaxf(z.z, z.w)));
      }
      mx0 = warp_max(mx0);
      mx1 = warp_max(mx1);
      if (lane == 0) {
        rowm[lr] = mx0;
        rowm[lr1] = mx1;
      }
    }
  }

  __device__ uint4 k_vector(const float* Mb, int lr, int j) const {
    const float* m = Mb + static_cast<size_t>(r0 + lr) * C + j * V;
    const float mx = rowm[lr];
    float e[V];
#pragma unroll
    for (int h = 0; h < V / 4; ++h) {
      const float4 x = *reinterpret_cast<const float4*>(m + 4 * h);
      e[4 * h] = expf(x.x - mx); e[4 * h + 1] = expf(x.y - mx);
      e[4 * h + 2] = expf(x.z - mx); e[4 * h + 3] = expf(x.w - mx);
    }
    return Store<KT>::pack(e);
  }

  // rmax_i and K = exp(M - rmax) of every own row (the wide kernel), a warp
  // per row: the warp reads its row a second time right after the first (from
  // L2), so M crosses device memory once where row_max then load_k would read
  // it twice (an element's M is larger than the L2 at these widths)
  __device__ void form_k(const float* Mb) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int lr = warp; lr < n; lr += kStripeWarps) {
      const float* m = Mb + static_cast<size_t>(r0 + lr) * C;
      float mx = -INFINITY;
#pragma unroll 8
      for (int j = lane; j < nq; j += 32) {
        const float4 x = *reinterpret_cast<const float4*>(m + 4 * j);
        mx = fmaxf(mx, fmaxf(fmaxf(x.x, x.y), fmaxf(x.z, x.w)));
      }
      mx = warp_max(mx);
      if (lane == 0) rowm[lr] = mx;
      KT* dst = lr < ns ? ks + static_cast<size_t>(lr) * C : kg + static_cast<size_t>(lr - ns) * C;
#pragma unroll 4
      for (int j = lane; j < nvec; j += 32) {
        float e[V];
#pragma unroll
        for (int h = 0; h < V / 4; ++h) {
          const float4 x = *reinterpret_cast<const float4*>(m + j * V + 4 * h);
          e[4 * h] = expf(x.x - mx); e[4 * h + 1] = expf(x.y - mx);
          e[4 * h + 2] = expf(x.z - mx); e[4 * h + 3] = expf(x.w - mx);
        }
        *reinterpret_cast<uint4*>(dst + j * V) = Store<KT>::pack(e);
      }
    }
  }

  // K = exp(M - rmax) of every own row into shared (or device) memory (rowm
  // must be complete)
  __device__ void load_k(const float* Mb) {
    const int t = threadIdx.x;
#pragma unroll 8
    for (int idx = t; idx < n_s * nvec; idx += kStripeThreads) {
      const int lr = idx / nvec, j = idx - lr * nvec;
      *reinterpret_cast<uint4*>(ks + static_cast<size_t>(lr) * C + j * V) = k_vector(Mb, lr, j);
    }
#pragma unroll 4
    for (int idx = t; idx < n_o * nvec; idx += kStripeThreads) {
      const int o = idx / nvec, j = idx - o * nvec;
      *reinterpret_cast<uint4*>(kg + static_cast<size_t>(o) * C + j * V) = k_vector(Mb, ns + o, j);
    }
  }

  // y = K_lr . vec of ``count`` rows of ``base`` (local rows first_lr + idx),
  // a warp per row: warp w takes rows w, w + kStripeWarps, ..., up to
  // kBlock (kRowBlock unless asked) of them per read of vec (so a stripe of
  // up to kBlock * kStripeWarps rows is one step for every warp); fn(lr, y)
  // on lane 0. A
  // warp's missing rows load nothing (predicated, no branch), so the loads of
  // a step issue together.
  template <int kBlock = kRowBlock, typename F>
  __device__ void rows_block(const KT* base, int count, int first_lr, F& fn) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int idx = warp; idx < count; idx += kBlock * kStripeWarps) {
      const KT* rows[kBlock];
      bool live[kBlock];
      float y[kBlock];
#pragma unroll
      for (int k = 0; k < kBlock; ++k) {
        live[k] = idx + k * kStripeWarps < count;
        rows[k] = base + static_cast<size_t>(live[k] ? idx + k * kStripeWarps : idx) * C + lane * V;
        y[k] = 0.f;
      }
      // the lane's vector c of vec: the float4s of V / 4 planes (see vec_slot)
      const float* v = vec + lane * 4;
#pragma unroll 2
      for (int off = 0; off < (nvec - lane + 31) / 32 * 32 * V; off += 32 * V) {
        float vv[V];
#pragma unroll
        for (int h = 0; h < V / 4; ++h) {
          const float4 x = *reinterpret_cast<const float4*>(v + off / (V / 4) + h * (C / (V / 4)));
          vv[4 * h] = x.x; vv[4 * h + 1] = x.y; vv[4 * h + 2] = x.z; vv[4 * h + 3] = x.w;
        }
        uint4 raw[kBlock];
#pragma unroll
        for (int k = 0; k < kBlock; ++k)
          raw[k] = live[k] ? *reinterpret_cast<const uint4*>(rows[k] + off) : make_uint4(0, 0, 0, 0);
#pragma unroll
        for (int k = 0; k < kBlock; ++k) {
          float kv[V];
          Store<KT>::unpack(raw[k], kv);
#pragma unroll
          for (int e = 0; e < V; ++e) y[k] = fmaf(kv[e], vv[e], y[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < kBlock; ++k) {
        const float s = warp_sum(y[k]);
        if (lane == 0 && live[k]) fn(first_lr + idx + k * kStripeWarps, s);
      }
    }
  }

  // y_lr = K_lr . vec for every own row; fn(lr, y) on the row's owner thread
  // (lane 0 of warp lr % kStripeWarps within its memory). Ends with every fn
  // done and visible to the block.
  template <typename F>
  __device__ void rows_pass(F&& fn) {
    rows_block(ks, n_s, 0, fn);
    rows_block(kg, n_o, ns, fn);
    __syncthreads();
  }
  // the same over the shared-memory rows only (the wide kernel's spilled
  // rows go through ``sweep``); two rows a warp where that covers them
  template <typename F>
  __device__ void rows_pass_shared(F&& fn) {
    if (n_s <= 2 * kStripeWarps) {
      rows_block<2>(ks, n_s, 0, fn);
    } else {
      rows_block(ks, n_s, 0, fn);
    }
    __syncthreads();
  }

  // the owner of float4 group j: the q with q * nq / cs <= j < (q + 1) * nq / cs
  __device__ int owner(int j) const { return ((j + 1) * cs + nq - 1) / nq - 1; }

  // where float4 group j (columns 4 j .. 4 j + 3) lies in vec: V / 4 planes,
  // plane h holding the h-th float4 of every 16-byte vector of K, so that a
  // lane's reads of one plane are 16 contiguous bytes beside its neighbours'
  // (bf16 K: one vector of K is two float4s of vec)
  __device__ int vec_slot(int j) const { return (j % (V / 4)) * (C / (V / 4)) + (j / (V / 4)) * 4; }

  // acc += the sums over the shared-memory rows of coef_lr K_lr,j of column
  // vector t, in row order
  __device__ void add_smem_rows(int t, float (&acc)[V]) const {
    // four rows at a time: their coefficients in one broadcast read
    const KT* col = ks + t * V;
    const float4* coef4 = reinterpret_cast<const float4*>(coef);
    int lr = 0;
#pragma unroll 2
    for (; lr + 4 <= n_s; lr += 4) {
      const float4 c = coef4[lr / 4];
      uint4 raw[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) raw[k] = *reinterpret_cast<const uint4*>(col + static_cast<size_t>(lr + k) * C);
      const float cf[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float kv[V];
        Store<KT>::unpack(raw[k], kv);
#pragma unroll
        for (int e = 0; e < V; ++e) acc[e] = fmaf(cf[k], kv[e], acc[e]);
      }
    }
    for (; lr < n_s; ++lr) {
      const float c = coef[lr];
      float kv[V];
      Store<KT>::unpack(*reinterpret_cast<const uint4*>(col + static_cast<size_t>(lr) * C), kv);
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = fmaf(c, kv[e], acc[e]);
    }
  }

  // column vector t's sums, stored into the owner of each float4's receive buffer
  __device__ void push_sums(int t, const float (&acc)[V]) {
#pragma unroll
    for (int h = 0; h < V / 4; ++h) {
      const int j = t * (V / 4) + h, q = owner(j);
      push4(peer_addr(smem_u32(recv + rank * width + (j - q * nq / cs)), q), peer_addr(smem_u32(bars), q),
            make_float4(acc[4 * h], acc[4 * h + 1], acc[4 * h + 2], acc[4 * h + 3]));
    }
  }

  // The columns pass: the sums over own rows of coef_lr K_lr,j (shared
  // memory rows, then spilled, each in row order; thread t the column
  // vectors t, t + kStripeThreads, ...), stored into the owner of each
  // float4's receive buffer
  __device__ void cols_pass() {
    for (int t = threadIdx.x; t < nvec; t += kStripeThreads) {
      float acc[V];
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = 0.f;
      add_smem_rows(t, acc);
      const KT* gcol = kg + t * V;
#pragma unroll 4
      for (int o = 0; o < n_o; ++o) {
        const float c = coef[ns + o];
        float kv[V];
        Store<KT>::unpack(*reinterpret_cast<const uint4*>(gcol + static_cast<size_t>(o) * C), kv);
#pragma unroll
        for (int e = 0; e < V; ++e) acc[e] = fmaf(c, kv[e], acc[e]);
      }
      push_sums(t, acc);
    }
  }

  // The wide kernel's columns pass: column vector threadIdx.x + k
  // kStripeThreads starts from the spilled rows' sums acc[k] (``sweep``) and
  // adds the shared-memory rows
  template <int NV>
  __device__ void cols_pass_from(float (&acc)[NV][V]) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int t = threadIdx.x + k * kStripeThreads;
      if (t < nvec) {
        add_smem_rows(t, acc[k]);
        push_sums(t, acc[k]);
      }
    }
  }

  // ring buffer b's mbarrier: its copy has landed (one arrival with its bytes)
  __device__ uint64_t* full_bar(int b) const { return ring_bars + b; }

  // spilled row o into ring buffer q % stages (one thread)
  __device__ void ring_issue(uint32_t q, int o) {
    const int b = static_cast<int>(q % stages);
    const uint32_t bytes = static_cast<uint32_t>(C * sizeof(KT));
    bar_expect(full_bar(b), bytes);
    bulk_load(ring + static_cast<size_t>(b) * C, kg + static_cast<size_t>(o) * C, bytes, full_bar(b));
  }

  // Before an element's first sweep, once its spilled rows are in device
  // memory and fenced for the bulk copies: the ring's first ``stages`` of
  // the element's ``total`` reads (spilled row k % n_o is read k-th).
  __device__ void ring_prime(int total) {
    if (threadIdx.x == 0)
      for (int k = 0; k < stages && k < total; ++k) ring_issue(ring_seq + k, k % n_o);
  }

  // A pass over the spilled rows, each read once: per row, in order, its
  // dot y with vec (each thread over its column vectors, then the warps'
  // shares added in a fixed order), then on_row(o, y, raw) on every thread
  // with ``raw`` the row's column vectors threadIdx.x + k kStripeThreads
  // (the iterations: u_hat and the column sums, ``add_row``; the last pass:
  // the output). ``done``: the element's reads so far, of ``total``. One
  // block barrier per row, after which the row's buffer is refilled with
  // the read ``stages`` ahead. Where a thread sums at most two column
  // vectors, it holds their entries of vec in registers for the whole pass
  // (vec is twice a bf16 row's bytes), and a row's on_row runs in the next
  // row's step, beside that row's dot (two independent chains between
  // barriers). Past two, the sums and two rows' vectors would crowd the
  // registers (spills of 8-400 bytes a thread): vec is read from shared
  // memory and on_row runs in the row's own step, after the barrier.
  template <int NV, typename Row>
  __device__ void sweep(int& done, int total, Row&& on_row) {
    constexpr bool kHold = NV <= 2, kPipe = kHold;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    float held[kHold ? NV : 1][V];
    if constexpr (kHold) {
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int t = threadIdx.x + k * kStripeThreads;
#pragma unroll
        for (int h = 0; h < V / 4; ++h) {
          const float4 x = t < nvec ? *reinterpret_cast<const float4*>(vec + h * (C / (V / 4)) + t * 4)
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
          held[k][4 * h] = x.x; held[k][4 * h + 1] = x.y; held[k][4 * h + 2] = x.z; held[k][4 * h + 3] = x.w;
        }
      }
    }
    uint4 prev[kPipe ? NV : 1];
    for (int o = 0; o < n_o; ++o, ++done) {
      const uint32_t q = ring_seq + static_cast<uint32_t>(done);
      const int b = static_cast<int>(q % stages);
      bar_wait(full_bar(b), (q / stages) & 1);
      const KT* row = ring + static_cast<size_t>(b) * C;
      uint4 raw[NV];
      float dot[V / 4] = {};  // independent partial sums, added in a fixed order
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int t = threadIdx.x + k * kStripeThreads;
        raw[k] = make_uint4(0, 0, 0, 0);
        if (t < nvec) {
          raw[k] = *reinterpret_cast<const uint4*>(row + t * V);
          float kv[V];
          Store<KT>::unpack(raw[k], kv);
#pragma unroll
          for (int h = 0; h < V / 4; ++h) {
            float4 x;
            if constexpr (kHold) {
              x = make_float4(held[k][4 * h], held[k][4 * h + 1], held[k][4 * h + 2], held[k][4 * h + 3]);
            } else {
              x = *reinterpret_cast<const float4*>(vec + h * (C / (V / 4)) + t * 4);
            }
            dot[h] = fmaf(kv[4 * h], x.x, dot[h]);
            dot[h] = fmaf(kv[4 * h + 1], x.y, dot[h]);
            dot[h] = fmaf(kv[4 * h + 2], x.z, dot[h]);
            dot[h] = fmaf(kv[4 * h + 3], x.w, dot[h]);
          }
        }
      }
      float d = dot[0];
#pragma unroll
      for (int h = 1; h < V / 4; ++h) d += dot[h];
      d = warp_sum(d);
      if constexpr (kPipe) {
        if (o > 0) on_row(o - 1, shares_sum(q - 1), prev);
      }
      if (lane == 0) dots[(q & 1) * kStripeWarps + warp] = d;
      __syncthreads();  // every share is in, and every thread has read the buffer
      if (threadIdx.x == 0 && done + stages < total) ring_issue(q + stages, (done + stages) % n_o);
      if constexpr (kPipe) {
#pragma unroll
        for (int k = 0; k < NV; ++k) prev[k] = raw[k];
      } else {
        on_row(o, shares_sum(q), raw);
      }
    }
    if constexpr (kPipe) {
      if (n_o > 0) on_row(n_o - 1, shares_sum(ring_seq + static_cast<uint32_t>(done) - 1), prev);
    }
  }

  // the dot of read q: the warps' shares added in a fixed order
  __device__ float shares_sum(uint32_t q) const {
    const float4* sh = reinterpret_cast<const float4*>(dots + (q & 1) * kStripeWarps);
    float4 s = sh[0];
#pragma unroll
    for (int w = 1; w < kStripeWarps / 4; ++w) add4(s, sh[w]);
    return (s.x + s.y) + (s.z + s.w);
  }

  // acc[k] += c K_row of column vector threadIdx.x + k kStripeThreads (raw[k])
  template <int NV>
  __device__ static void add_row(float (&acc)[NV][V], const uint4 (&raw)[NV], float c) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      float kv[V];
      Store<KT>::unpack(raw[k], kv);
#pragma unroll
      for (int e = 0; e < V; ++e) acc[k][e] = fmaf(c, kv[e], acc[k][e]);
    }
  }

  // this cluster's sums of four columns, each float beside the exchange's
  // number ``tag`` (two 16-byte stores of two whole 8-byte words each)
  __device__ static void post(uint4* dst, const float4& s, uint32_t tag) {
    asm volatile("st.volatile.global.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"l"(dst), "r"(__float_as_uint(s.x)),
                 "r"(tag), "r"(__float_as_uint(s.y)), "r"(tag) : "memory");
    asm volatile("st.volatile.global.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"l"(dst + 1), "r"(__float_as_uint(s.z)),
                 "r"(tag), "r"(__float_as_uint(s.w)), "r"(tag) : "memory");
  }
  __device__ static uint4 peek(const uint4* src) {
    uint4 v;
    asm volatile("ld.volatile.global.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(src) : "memory");
    return v;
  }

  // After a columns pass: the element's column sums of this CTA's slice ->
  // fn(j, sum, pre(j)), the float4 of the next vector at columns 4 j .. 4 j
  // + 3 (on the slice's owner, the same thread for the same j in every call;
  // pre's device-memory loads are issued before the wait) -> every peer's
  // vec. Ends with the whole vector in vec. Only a kernel that asks for it
  // (kTwoLevel: the wide kernel) holds the two-level exchange's code.
  template <bool kTwoLevel = false, typename Pre, typename F>
  __device__ void exchange(Pre&& pre, F&& fn) {
    const int j0 = lo + threadIdx.x;
    decltype(pre(j0)) first = {};
    if (j0 < hi) first = pre(j0);
    if (threadIdx.x == 0) bar_expect(bars, static_cast<uint32_t>(cs * (hi - lo) * 16));
    bar_wait(bars, phase & 1);  // every column sum of this slice is here
    // the cross-cluster buffer of this exchange (by parity; two levels: the
    // one buffer), and its number
    const uint32_t tag = phase + 1;
    const bool two = kTwoLevel && levels == 2;
    uint4* x8 = xchg + (static_cast<size_t>(two ? 0 : tag & 1) * nslots + slot) * G * nq * 2;
    for (int j = j0; j < hi; j += kStripeThreads) {
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int q = 0; q < cs; ++q) add4(s, recv[q * width + (j - lo)]);
      if (G == 1) {
        gather(j, fn(j, s, j == j0 ? first : pre(j)));
      } else {
        post(x8 + (static_cast<size_t>(g) * nq + j) * 2, s, tag);
      }
    }
    if constexpr (kTwoLevel) {
      if (two) {
        two_level(x8, tag, pre, fn);
      } else {
        flat(x8, tag, j0, first, pre, fn);
      }
    } else {
      flat(x8, tag, j0, first, pre, fn);
    }
    if (threadIdx.x == 0) bar_expect(bars + 1, static_cast<uint32_t>(nq * 16));
    bar_wait(bars + 1, phase & 1);  // every slice of the vector is here
    ++phase;
  }

  __device__ static bool tagged(const uint4& a, const uint4& b, uint32_t tag) {
    return a.y == tag && a.w == tag && b.y == tag && b.w == tag;
  }
  __device__ static float4 untag(const uint4& a, const uint4& b) {
    return make_float4(__uint_as_float(a.x), __uint_as_float(a.z), __uint_as_float(b.x), __uint_as_float(b.z));
  }

  // v, the float4 of the next vector at group j, into every peer's vec
  __device__ void gather(int j, const float4& v) const {
    const uint32_t local = smem_u32(vec + vec_slot(j)), vec_bar = smem_u32(bars + 1);
    for (int q = 0; q < cs; ++q) push4(peer_addr(local, q), peer_addr(vec_bar, q), v);
  }

  // One level (G > 1): every cluster's sums of this slice, eight clusters'
  // words in flight, polled until all carry this exchange's number, added
  // in cluster order; each cluster forms the whole slice of the next vector.
  template <typename T, typename Pre, typename F>
  __device__ void flat(uint4* x8, uint32_t tag, int j0, const T& first, Pre& pre, F& fn) {
    for (int j = j0; G > 1 && j < hi; j += kStripeThreads) {
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int h0 = 0; h0 < G; h0 += 8) {
        uint4 w[8][2];
        bool ready;
        do {
          ready = true;
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            if (h0 + k < G) {
              const uint4* src = x8 + (static_cast<size_t>(h0 + k) * nq + j) * 2;
              w[k][0] = peek(src);
              w[k][1] = peek(src + 1);
            }
          }
#pragma unroll
          for (int k = 0; k < 8; ++k)
            if (h0 + k < G) ready = ready && tagged(w[k][0], w[k][1], tag);
        } while (!ready);
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (h0 + k < G) add4(s, untag(w[k][0], w[k][1]));
      }
      gather(j, fn(j, s, j == j0 ? first : pre(j)));
    }
  }

  // Two levels: CTA rank r of cluster g owns part g of slice r (groups s0 ..
  // s0 + W - 1). Its threads poll the G clusters' words of that part, one
  // word pair each, into recv ([G][W]: the slice's sums from the cluster
  // were all read above, and no peer sends the next ones before this CTA's
  // gather below); the part's sums are added in cluster order, and the
  // part's next vector posted beside this exchange's number. Then each CTA
  // polls its whole slice from the G parts and gathers it into its cluster.
  // Buffers are single: a CTA posts the next exchange's sums of slice r only
  // after it has its next vector, so after every part owner of slice r has
  // posted that, which each did after adding this exchange's sums; and it
  // posts the next part of the vector only after every CTA of slice r has
  // posted its next sums, which each did after gathering this exchange's.
  template <typename Pre, typename F>
  __device__ void two_level(uint4* x8, uint32_t tag, Pre& pre, F& fn) {
    const int w = hi - lo, s0 = lo + g * w / G, W = lo + (g + 1) * w / G - s0;
    uint4* y8 = xchg + (static_cast<size_t>(nslots) * G + slot) * nq * 2;
    __syncthreads();  // every thread has added its slice's sums out of recv
    for (int idx = threadIdx.x; idx < G * W; idx += kStripeThreads) {
      const int h = idx / W;
      const uint4* src = x8 + (static_cast<size_t>(h) * nq + s0 + idx - h * W) * 2;
      uint4 a, b;
      do {
        a = peek(src);
        b = peek(src + 1);
      } while (!tagged(a, b, tag));
      recv[idx] = untag(a, b);
    }
    __syncthreads();
    for (int jl = threadIdx.x; jl < W; jl += kStripeThreads) {
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int h = 0; h < G; ++h) add4(s, recv[h * W + jl]);
      post(y8 + static_cast<size_t>(s0 + jl) * 2, fn(s0 + jl, s, pre(s0 + jl)), tag);
    }
    for (int j = lo + threadIdx.x; j < hi; j += kStripeThreads) {
      uint4 a, b;
      do {
        a = peek(y8 + static_cast<size_t>(j) * 2);
        b = peek(y8 + static_cast<size_t>(j) * 2 + 1);
      } while (!tagged(a, b, tag));
      gather(j, untag(a, b));
    }
  }
};

}  // namespace
