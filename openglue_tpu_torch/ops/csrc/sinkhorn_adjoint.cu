// Sinkhorn backward as rank-2T factors, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel openglue_tpu/ops/pallas/sinkhorn_kernel.py::
// _sinkhorn_adjoint_factors_kernel, reached through _sinkhorn_vjp_kernel_path
// from the custom VJP of log_optimal_transport. Per batch element, on the
// padded cost M [R, C] f32 with its row max rmax and the seeds of the upstream
// cotangent g (row sums, column sums):
//   K = exp(M - rmax)
//   forward replay, t = 0..T-1 (v_0 = 1):
//     y_t = max(K v_{t-1}, 1e-30), u_t = a / y_t, r_t = max(K^T u_t, 1e-30), v_t = b / r_t
//   reverse recursion, t = T-1..0 (gv = colsum(g) at the start):
//     P[t] = u_t,        Q[t] = gv / r_t
//     gu = [t = T-1] rowsum(g) - u_t o (K (gv / r_t))
//     P[T+t] = gu / y_t, Q[T+t] = v_{t-1} (1 at t = 0)
//     gv = -v_{t-1} o (K^T (gu / y_t))
// so that the caller forms dM = g - K o (P^T Q) in one pass (torch).
//
// What bounds it on the H100: it reads K 2T times (T = 20: about 170 MB per
// element at N = 1024 from L2) and nothing else of size; the bound counts M
// once, 4.2 MB per element, so the kernel is bandwidth-bound with a
// dependency between iterations (every column needs every row).
//
// Design: the TPU kernel holds M in a single-buffered VMEM block and runs the
// grid in order; here each batch element is one cluster of 8 CTAs, as in the
// forward kernel (sinkhorn.cu): each CTA takes every 8th stripe of rows, a
// warp holds two rows of K in registers, reduces the row dot across the warp
// and accumulates the row times its scalar into per-lane column sums, which
// meet in shared memory and across the cluster through distributed shared
// memory, one cluster barrier per pass. Both recursions are one pass over K
// per step in this shape. The histories u, y (per row) and r, v (per column)
// go to global memory (about 330 KB per element at N = 1024, T = 20; they
// stay in L2). f32 K only: registers cap the columns at 1536.

#include "sinkhorn_rows.cuh"

namespace {

template <int NC>
__global__ void __launch_bounds__(kThreads)
sinkhorn_adjoint_kernel(const float* __restrict__ M, const float* __restrict__ log_a,
                        const float* __restrict__ log_b, const float* __restrict__ rmax,
                        const float* __restrict__ g_rowsum, const float* __restrict__ g_colsum,
                        float* __restrict__ K, float* __restrict__ hist, float* __restrict__ P,
                        float* __restrict__ Q, int R, int C, int T) {
  constexpr int V = Store<float>::kVec;
  extern __shared__ float smem[];
  float* vec = smem;                          // [C]: the vector of this pass
  float* partial = smem + C;                  // [kWarps][C]
  float* cta_sum = smem + (1 + kWarps) * C;   // [2][C], double-buffered by pass

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / kCluster;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t off = static_cast<size_t>(b) * R * C;
  M += off; K += off;
  log_a += static_cast<size_t>(b) * R; rmax += static_cast<size_t>(b) * R;
  g_rowsum += static_cast<size_t>(b) * R;
  log_b += static_cast<size_t>(b) * C; g_colsum += static_cast<size_t>(b) * C;
  // one step's history: u [R], y [R], r [C], v [C]
  const size_t step = 2 * static_cast<size_t>(R) + 2 * static_cast<size_t>(C);
  hist += static_cast<size_t>(b) * T * step;
  P += static_cast<size_t>(b) * 2 * T * R;
  Q += static_cast<size_t>(b) * 2 * T * C;
  // this CTA's rows: rank*kWarps + warp + s*kCluster*kWarps, s = 0, 1, ...
  const int first = rank * kWarps + warp;
  constexpr int kStride = kCluster * kWarps;

  // K = exp(M - rmax); each lane writes the columns it later loads
  for (int i = first; i < R; i += kStride) {
    const float* mrow = M + static_cast<size_t>(i) * C;
    float* krow = K + static_cast<size_t>(i) * C;
    const float mx = rmax[i];
    for (int j = lane * V; j < C; j += 32 * V) {
      const float4 x = *reinterpret_cast<const float4*>(mrow + j);
      *reinterpret_cast<float4*>(krow + j) =
          make_float4(expf(x.x - mx), expf(x.y - mx), expf(x.z - mx), expf(x.w - mx));
    }
  }
  for (int j = threadIdx.x; j < C; j += kThreads) vec[j] = 1.f;
  __syncthreads();

  int buf = 0;
  // the per-lane column sums r of this pass -> the cluster's column sums;
  // fn(j, sum) for every column j this thread visits. A CTA's buffer is
  // rewritten two passes later, after the next cluster barrier, which no CTA
  // passes before all have read it.
  auto columns = [&](float (&r)[NC][V], auto&& fn) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = (c * 32 + lane) * V;
      if (col < C) {
#pragma unroll
        for (int e = 0; e < V; ++e) partial[warp * C + col + e] = r[c][e];
      }
    }
    __syncthreads();
    float* mine = cta_sum + buf * C;
    for (int j = threadIdx.x; j < C; j += kThreads) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += partial[w * C + j];
      mine[j] = s;
    }
    cluster.sync();
    for (int j = threadIdx.x; j < C; j += kThreads) {
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < kCluster; ++q) s += cluster.map_shared_rank(mine, q)[j];
      fn(j, s);
    }
    __syncthreads();
    buf ^= 1;
  };

  uint4 k0[NC], k1[NC];
  // forward replay: u, y per row; r, v per column. Every CTA writes the
  // (identical) column histories, so each thread reads back its own writes.
  for (int t = 0; t < T; ++t) {
    float* hu = hist + t * step;
    float* hy = hu + R;
    float* hr = hu + 2 * R;
    float* hv = hr + C;
    float r[NC][V];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < V; ++e) r[c][e] = 0.f;
    for (int i = first; i < R; i += 2 * kStride) {
      const int i1 = i + kStride;
      load_row<float, NC>(K + static_cast<size_t>(i) * C, true, C, lane, k0);
      load_row<float, NC>(K + static_cast<size_t>(i1) * C, i1 < R, C, lane, k1);
      const float y0 = fmaxf(warp_sum(lane_dot<float, NC>(k0, vec, C, lane)), kTiny);
      const float y1 = fmaxf(warp_sum(lane_dot<float, NC>(k1, vec, C, lane)), kTiny);
      const float u0 = expf(log_a[i]) / y0;
      accumulate<float, NC>(k0, u0, r);
      if (lane == 0) { hu[i] = u0; hy[i] = y0; }
      if (i1 < R) {
        const float u1 = expf(log_a[i1]) / y1;
        accumulate<float, NC>(k1, u1, r);
        if (lane == 0) { hu[i1] = u1; hy[i1] = y1; }
      }
    }
    columns(r, [&](int j, float s) {
      const float rr = fmaxf(s, kTiny);
      const float v = expf(log_b[j]) / rr;
      vec[j] = v;
      hr[j] = rr;
      hv[j] = v;
    });
  }

  // reverse recursion; vec = gv / r_t
  {
    const float* hr = hist + (T - 1) * step + 2 * R;
    for (int j = threadIdx.x; j < C; j += kThreads) vec[j] = g_colsum[j] / hr[j];
  }
  __syncthreads();
  for (int tr = 0; tr < T; ++tr) {
    const int slot = T - 1 - tr;
    const bool last = tr == T - 1;  // gv of the first step is not needed
    const float* hu = hist + slot * step;
    const float* hy = hu + R;
    const float* hr_prev = slot > 0 ? hist + (slot - 1) * step + 2 * R : nullptr;
    const float* hv_prev = slot > 0 ? hr_prev + C : nullptr;
    if (rank == 0) {
      for (int j = threadIdx.x; j < C; j += kThreads) {
        Q[static_cast<size_t>(slot) * C + j] = vec[j];
        Q[static_cast<size_t>(T + slot) * C + j] = hv_prev != nullptr ? hv_prev[j] : 1.f;
      }
    }
    float r[NC][V];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < V; ++e) r[c][e] = 0.f;
    for (int i = first; i < R; i += 2 * kStride) {
      const int i1 = i + kStride;
      load_row<float, NC>(K + static_cast<size_t>(i) * C, true, C, lane, k0);
      load_row<float, NC>(K + static_cast<size_t>(i1) * C, i1 < R, C, lane, k1);
      const float d0 = warp_sum(lane_dot<float, NC>(k0, vec, C, lane));
      const float d1 = warp_sum(lane_dot<float, NC>(k1, vec, C, lane));
      const float u0 = hu[i];
      const float s0 = ((tr == 0 ? g_rowsum[i] : 0.f) - u0 * d0) / hy[i];
      if (!last) accumulate<float, NC>(k0, s0, r);
      if (lane == 0) {
        P[static_cast<size_t>(slot) * R + i] = u0;
        P[static_cast<size_t>(T + slot) * R + i] = s0;
      }
      if (i1 < R) {
        const float u1 = hu[i1];
        const float s1 = ((tr == 0 ? g_rowsum[i1] : 0.f) - u1 * d1) / hy[i1];
        if (!last) accumulate<float, NC>(k1, s1, r);
        if (lane == 0) {
          P[static_cast<size_t>(slot) * R + i1] = u1;
          P[static_cast<size_t>(T + slot) * R + i1] = s1;
        }
      }
    }
    if (!last) {
      columns(r, [&](int j, float s) { vec[j] = -hv_prev[j] * s / hr_prev[j]; });
    }
  }
  cluster.sync();  // no CTA leaves while another may still read its shared memory
}

template <int NC>
cudaError_t launch(const float* M, const float* la, const float* lb, const float* rmax,
                   const float* grow, const float* gcol, float* K, float* hist, float* P,
                   float* Q, int B, int R, int C, int T, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(3 + kWarps) * C * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(sinkhorn_adjoint_kernel<NC>,
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
  err = cudaLaunchKernelEx(&config, sinkhorn_adjoint_kernel<NC>, M, la, lb, rmax, grow, gcol, K,
                           hist, P, Q, R, C, T);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int NC = 1>
cudaError_t dispatch(int nc, const float* M, const float* la, const float* lb, const float* rmax,
                     const float* grow, const float* gcol, float* K, float* hist, float* P,
                     float* Q, int B, int R, int C, int T, cudaStream_t stream) {
  if constexpr (NC > 12) {
    return cudaErrorInvalidValue;
  } else {
    if (nc == NC) return launch<NC>(M, la, lb, rmax, grow, gcol, K, hist, P, Q, B, R, C, T, stream);
    return dispatch<NC + 1>(nc, M, la, lb, rmax, grow, gcol, K, hist, P, Q, B, R, C, T, stream);
  }
}

}  // namespace

// M [B, R, C] f32 with C a multiple of 8 and at most 1536; log_a, rmax,
// g_rowsum [B, R]; log_b, g_colsum [B, C] (all f32). Scratch: K [B, R, C] and
// hist [B, T, 2R + 2C] f32. Outputs P [B, 2T, R] and Q [B, 2T, C] f32.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int og_sinkhorn_adjoint(const void* M, const void* log_a, const void* log_b,
                                   const void* rmax, const void* g_rowsum, const void* g_colsum,
                                   void* K, void* hist, void* P, void* Q, int B, int R, int C,
                                   int T, void* stream) {
  if (B == 0 || R == 0) return cudaSuccess;
  if (T < 1 || C % 8 != 0) return cudaErrorInvalidValue;
  const int nc = (C + 32 * 4 - 1) / (32 * 4);
  return dispatch(nc, static_cast<const float*>(M), static_cast<const float*>(log_a),
                  static_cast<const float*>(log_b), static_cast<const float*>(rmax),
                  static_cast<const float*>(g_rowsum), static_cast<const float*>(g_colsum),
                  static_cast<float*>(K), static_cast<float*>(hist), static_cast<float*>(P),
                  static_cast<float*>(Q), B, R, C, T, static_cast<cudaStream_t>(stream));
}
