// Scale-domain Sinkhorn forward for Hopper (sm_90a).
//
// Replaces three Pallas TPU kernels of openglue_tpu/ops/pallas/sinkhorn_kernel.py:
// _sinkhorn_kernel_pair (two elements per grid step), _sinkhorn_kernel (one
// element) and _blocked_scale_kernel (bf16 K streamed from HBM). They run one
// recursion; here it is one kernel templated on K's storage type.
//
// Per batch element, on M [R, C] f32 (dustbin-augmented, masked/padded at -1e9):
//   rmax_i = max_j M_ij;  K = exp(M - rmax) stored once as KT (f32 or bf16)
//   v = 1;  T-1 times:  u_i = a_i / max((K v)_i, 1e-30)
//                       v_j = b_j / max((K^T u)_j, 1e-30)
//   out_i = log_a_i - rmax_i - log(max((K v)_i, 1e-30))
// with a = exp(log_a), b = exp(log_b). Arithmetic is f32; bf16 is storage only.
//
// What bounds it on the H100: every iteration reads all of K once (4.2 MB
// f32 per element at N=1024, 8.4 MB bf16 at N=2048), so it is a
// bandwidth-bound streaming recursion with a grid-wide dependency between
// iterations (each v needs every row's u).
//
// Design: the TPU kernels ran the grid in order and paired elements to hide
// matvec latency; neither carries over. Here a cluster of 8 CTAs owns one
// batch element and loops over all iterations: each CTA takes every 8th
// stripe of rows, and the one dependency between iterations (every v needs
// the column sums of all rows) is met through distributed shared memory and
// one cluster barrier per iteration. K stays in L2 where it fits. B elements
// fill 8*B of the 132 SMs (128 at the serving batch of 16, 8 for a single
// pair); a single pair's latency is bounded by 8 SMs' load rate.
// Each iteration is ONE pass over K: a warp takes two rows at a time, holds
// its slices in registers, reduces y = K_i . v across the warp, forms u_i and
// accumulates u_i K_i into per-lane column sums in registers; the warps'
// sums meet in shared memory, the CTAs' sums in the cluster. That holds a
// row in registers and 11 column vectors in shared memory, so it takes at
// most 1536 columns with f32 K and 4096 with bf16 K.
//
// Beyond those, the streaming variant (og_sinkhorn_scale_streaming, the
// counterpart of _blocked_scale_kernel) runs the same recursion with K read
// from device memory in every half-iteration: a warp per row forms u (rows
// pass); blocks of 256 columns sum u_i K_ij over splits of 64 rows into
// partials (columns pass); a last launch adds the partials in a fixed order
// and forms v. Three launches per iteration, any column count, no atomics.

#include "sinkhorn_rows.cuh"

namespace {

template <typename KT, int NC>
__global__ void __launch_bounds__(kThreads)
sinkhorn_scale_kernel(const float* __restrict__ M, const float* __restrict__ log_a,
                      const float* __restrict__ log_b, KT* __restrict__ K,
                      float* __restrict__ u_out, int R, int C, int num_iters) {
  constexpr int V = Store<KT>::kVec;
  extern __shared__ float smem[];
  float* v_hat = smem;               // [C]
  float* partial = smem + C;         // [kWarps][C]
  float* cta_sum = smem + (1 + kWarps) * C;  // [2][C], double-buffered by iteration

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / kCluster;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t off = static_cast<size_t>(b) * R * C;
  M += off; K += off; log_a += static_cast<size_t>(b) * R;
  log_b += static_cast<size_t>(b) * C; u_out += static_cast<size_t>(b) * R;
  // this CTA's rows: rank*kWarps + warp + s*kCluster*kWarps, s = 0, 1, ...
  const int first = rank * kWarps + warp;
  constexpr int kStride = kCluster * kWarps;

  // rmax and K = exp(M - rmax); rmax parks in u_out until the end
  for (int i = first; i < R; i += kStride) {
    const float* mrow = M + static_cast<size_t>(i) * C;
    float mx = -INFINITY;
    for (int j = lane * 4; j < C; j += 128) {
      float4 x = *reinterpret_cast<const float4*>(mrow + j);
      mx = fmaxf(mx, fmaxf(fmaxf(x.x, x.y), fmaxf(x.z, x.w)));
    }
    mx = warp_max(mx);
    if (lane == 0) u_out[i] = mx;
    KT* krow = K + static_cast<size_t>(i) * C;
    for (int j = lane * V; j < C; j += 32 * V) {
      float e[V];
#pragma unroll
      for (int q = 0; q < V; ++q) e[q] = expf(mrow[j + q] - mx);
      Store<KT>::pack_store(krow + j, e);
    }
  }
  for (int j = threadIdx.x; j < C; j += kThreads) v_hat[j] = 1.f;
  __syncthreads();

  uint4 k0[NC], k1[NC];
  for (int it = 0; it < num_iters - 1; ++it) {
    float r[NC][V];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < V; ++e) r[c][e] = 0.f;

    // two rows per step, so each lane has two rows' loads in flight
    for (int i = first; i < R; i += 2 * kStride) {
      const int i1 = i + kStride;
      load_row<KT, NC>(K + static_cast<size_t>(i) * C, true, C, lane, k0);
      load_row<KT, NC>(K + static_cast<size_t>(i1) * C, i1 < R, C, lane, k1);
      const float y0 = warp_sum(lane_dot<KT, NC>(k0, v_hat, C, lane));
      const float y1 = warp_sum(lane_dot<KT, NC>(k1, v_hat, C, lane));
      accumulate<KT, NC>(k0, expf(log_a[i]) / fmaxf(y0, kTiny), r);
      if (i1 < R) accumulate<KT, NC>(k1, expf(log_a[i1]) / fmaxf(y1, kTiny), r);
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = (c * 32 + lane) * V;
      if (col < C) {
#pragma unroll
        for (int e = 0; e < V; ++e) partial[warp * C + col + e] = r[c][e];
      }
    }
    __syncthreads();
    float* mine = cta_sum + (it & 1) * C;
    for (int j = threadIdx.x; j < C; j += kThreads) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += partial[w * C + j];
      mine[j] = s;
    }
    // every CTA's column sums of this iteration are complete after this
    // barrier; the buffer is rewritten two iterations later, after the next
    // barrier, which no CTA passes before all have read it
    cluster.sync();
    for (int j = threadIdx.x; j < C; j += kThreads) {
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < kCluster; ++q) s += cluster.map_shared_rank(mine, q)[j];
      v_hat[j] = expf(log_b[j]) / fmaxf(s, kTiny);
    }
    __syncthreads();
  }

  for (int i = first; i < R; i += kStride) {
    load_row<KT, NC>(K + static_cast<size_t>(i) * C, true, C, lane, k0);
    const float y = warp_sum(lane_dot<KT, NC>(k0, v_hat, C, lane));
    if (lane == 0) u_out[i] = log_a[i] - u_out[i] - logf(fmaxf(y, kTiny));
  }
  cluster.sync();  // no CTA leaves while another may still read its shared memory
}

template <typename KT, int NC>
cudaError_t launch(const float* M, const float* la, const float* lb, void* K, float* u,
                   int B, int R, int C, int num_iters, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(3 + kWarps) * C * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(sinkhorn_scale_kernel<KT, NC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(B * kCluster);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, sinkhorn_scale_kernel<KT, NC>, M, la, lb,
                           static_cast<KT*>(K), u, R, C, num_iters);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename KT, int NC = 1>
cudaError_t dispatch(int nc, const float* M, const float* la, const float* lb, void* K,
                     float* u, int B, int R, int C, int num_iters, cudaStream_t stream) {
  if constexpr (NC > 16) {
    return cudaErrorInvalidValue;
  } else {
    if (nc == NC) return launch<KT, NC>(M, la, lb, K, u, B, R, C, num_iters, stream);
    return dispatch<KT, NC + 1>(nc, M, la, lb, K, u, B, R, C, num_iters, stream);
  }
}


// ---------------------------------------------------------------- streaming

constexpr int kStreamRows = 64;  // rows per split of the column sums

__device__ __forceinline__ float k_value(float x) { return x; }
__device__ __forceinline__ float k_value(__nv_bfloat16 x) { return __bfloat162float(x); }

// rmax and K = exp(M - rmax), a warp per row of all B * R rows; rmax parks in
// u_out until the last rows pass
template <typename KT>
__global__ void __launch_bounds__(kThreads)
stream_prepare(const float* __restrict__ M, KT* __restrict__ K, float* __restrict__ u_out, int C, int rows) {
  constexpr int V = Store<KT>::kVec;
  const int row = blockIdx.x * kWarps + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float* mrow = M + static_cast<size_t>(row) * C;
  float mx = -INFINITY;
  for (int j = lane * 4; j < C; j += 128) {
    const float4 x = *reinterpret_cast<const float4*>(mrow + j);
    mx = fmaxf(mx, fmaxf(fmaxf(x.x, x.y), fmaxf(x.z, x.w)));
  }
  mx = warp_max(mx);
  if (lane == 0) u_out[row] = mx;
  KT* krow = K + static_cast<size_t>(row) * C;
  for (int j = lane * V; j < C; j += 32 * V) {
    float e[V];
#pragma unroll
    for (int q = 0; q < V; ++q) e[q] = expf(mrow[j + q] - mx);
    Store<KT>::pack_store(krow + j, e);
  }
}

// y_i = K_i . v (v null: all ones), a warp per row. kFinal false: u_hat_i =
// a_i / max(y_i, tiny); true: u_i = log_a_i - rmax_i - log(max(y_i, tiny)),
// rmax_i read from u where stream_prepare parked it
template <typename KT, bool kFinal>
__global__ void __launch_bounds__(kThreads)
stream_rows(const KT* __restrict__ K, const float* __restrict__ v, const float* __restrict__ log_a,
            float* __restrict__ u, int R, int C, int rows) {
  constexpr int V = Store<KT>::kVec;
  const int row = blockIdx.x * kWarps + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  const KT* krow = K + static_cast<size_t>(row) * C;
  const float* vb = v == nullptr ? nullptr : v + static_cast<size_t>(row / R) * C;
  float y = 0.f;
  for (int j = lane * V; j < C; j += 32 * V) {
    float kv[V];
    Store<KT>::unpack(*reinterpret_cast<const uint4*>(krow + j), kv);
#pragma unroll
    for (int e = 0; e < V; ++e) y = fmaf(kv[e], vb == nullptr ? 1.f : vb[j + e], y);
  }
  y = warp_sum(y);
  if (lane == 0) {
    if constexpr (kFinal) u[row] = log_a[row] - u[row] - logf(fmaxf(y, kTiny));
    else u[row] = expf(log_a[row]) / fmaxf(y, kTiny);
  }
}

// partial[b][s][j] = sum over the rows i of split s, in order, of u_hat_i K_ij
template <typename KT>
__global__ void __launch_bounds__(256)
stream_cols(const KT* __restrict__ K, const float* __restrict__ u_hat, float* __restrict__ partial, int R,
            int C, int splits) {
  const int j = blockIdx.x * 256 + threadIdx.x, sp = blockIdx.y, b = blockIdx.z;
  if (j >= C) return;
  const int r0 = sp * kStreamRows, r1 = min(R, r0 + kStreamRows);
  const KT* kb = K + static_cast<size_t>(b) * R * C + j;
  const float* ub = u_hat + static_cast<size_t>(b) * R;
  float acc = 0.f;
  for (int i = r0; i < r1; ++i) acc = fmaf(ub[i], k_value(kb[static_cast<size_t>(i) * C]), acc);
  partial[(static_cast<size_t>(b) * splits + sp) * C + j] = acc;
}

// v_j = b_j / max(sum of the splits' partials in order, tiny)
__global__ void __launch_bounds__(256)
stream_finish(const float* __restrict__ partial, const float* __restrict__ log_b, float* __restrict__ v, int C,
              int splits) {
  const int j = blockIdx.x * 256 + threadIdx.x, b = blockIdx.y;
  if (j >= C) return;
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp) s += partial[(static_cast<size_t>(b) * splits + sp) * C + j];
  v[static_cast<size_t>(b) * C + j] = expf(log_b[static_cast<size_t>(b) * C + j]) / fmaxf(s, kTiny);
}

struct StreamBuffers {
  float *u_hat, *v, *partial;
  int splits;
};

StreamBuffers stream_buffers(void* ws, int B, int R, int C, size_t* bytes) {
  StreamBuffers p;
  p.splits = (R + kStreamRows - 1) / kStreamRows;
  const size_t n_u = static_cast<size_t>(B) * R, n_v = static_cast<size_t>(B) * C;
  const size_t n_p = static_cast<size_t>(B) * p.splits * C;
  float* base = static_cast<float*>(ws);
  p.u_hat = base;
  p.v = base == nullptr ? nullptr : base + n_u;
  p.partial = base == nullptr ? nullptr : base + n_u + n_v;
  if (bytes != nullptr) *bytes = (n_u + n_v + n_p) * sizeof(float);
  return p;
}

template <typename KT>
cudaError_t streaming(const float* M, const float* la, const float* lb, KT* K, float* u, void* ws, int B,
                      int R, int C, int num_iters, cudaStream_t s) {
  const StreamBuffers p = stream_buffers(ws, B, R, C, nullptr);
  const int rows = B * R, row_blocks = (rows + kWarps - 1) / kWarps;
  const dim3 cols_grid((C + 255) / 256, p.splits, B), finish_grid((C + 255) / 256, B);
  stream_prepare<KT><<<row_blocks, kThreads, 0, s>>>(M, K, u, C, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  for (int it = 0; it < num_iters - 1; ++it) {
    stream_rows<KT, false><<<row_blocks, kThreads, 0, s>>>(K, it == 0 ? nullptr : p.v, la, p.u_hat, R, C, rows);
    stream_cols<KT><<<cols_grid, 256, 0, s>>>(K, p.u_hat, p.partial, R, C, p.splits);
    stream_finish<<<finish_grid, 256, 0, s>>>(p.partial, lb, p.v, C, p.splits);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  stream_rows<KT, true><<<row_blocks, kThreads, 0, s>>>(K, num_iters > 1 ? p.v : nullptr, la, u, R, C, rows);
  return cudaGetLastError();
}
}  // namespace

// k_is_bf16: K's storage type. M [B, R, C] f32 with C a multiple of 8;
// log_a [B, R], log_b [B, C] f32; K [B, R, C] scratch; u [B, R] f32 out.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int og_sinkhorn_scale(int k_is_bf16, const void* M, const void* log_a,
                                 const void* log_b, void* K, void* u, int B, int R, int C,
                                 int num_iters, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(M);
  const float* la = static_cast<const float*>(log_a);
  const float* lb = static_cast<const float*>(log_b);
  float* uo = static_cast<float*>(u);
  if (B == 0 || R == 0) return cudaSuccess;
  if (k_is_bf16) {
    const int nc = (C + 32 * 8 - 1) / (32 * 8);
    return dispatch<__nv_bfloat16>(nc, m, la, lb, K, uo, B, R, C, num_iters, s);
  }
  const int nc = (C + 32 * 4 - 1) / (32 * 4);
  if (nc > 12) return cudaErrorInvalidValue;
  return dispatch<float>(nc, m, la, lb, K, uo, B, R, C, num_iters, s);
}

// Bytes of workspace og_sinkhorn_scale_streaming needs.
extern "C" size_t og_sinkhorn_scale_streaming_workspace(int B, int R, int C) {
  size_t bytes = 0;
  stream_buffers(nullptr, B, R, C, &bytes);
  return bytes;
}

// The same recursion as og_sinkhorn_scale for any column count (C a multiple
// of 8), with K read from device memory in every half-iteration.
// workspace: og_sinkhorn_scale_streaming_workspace bytes. Returns the CUDA
// error code of the launches (0 on success).
extern "C" int og_sinkhorn_scale_streaming(int k_is_bf16, const void* M, const void* log_a,
                                           const void* log_b, void* K, void* u, void* workspace, int B, int R,
                                           int C, int num_iters, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(M);
  const float* la = static_cast<const float*>(log_a);
  const float* lb = static_cast<const float*>(log_b);
  float* uo = static_cast<float*>(u);
  if (B == 0 || R == 0) return cudaSuccess;
  if (C % 8 != 0 || num_iters < 1) return cudaErrorInvalidValue;
  if (k_is_bf16)
    return streaming(m, la, lb, static_cast<__nv_bfloat16*>(K), uo, workspace, B, R, C, num_iters, s);
  return streaming(m, la, lb, static_cast<float*>(K), uo, workspace, B, R, C, num_iters, s);
}
