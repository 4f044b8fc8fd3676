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
// What bounds it on the H100: the work that must be done is one read of M
// (4.2 MB f32 per element at N=1024, 16.9 MB at N=2048) and 4 FMAs per entry
// of K per iteration, so its bound is the bytes of M. A kernel that keeps K in
// device memory reads all of it again in every iteration (67.7 MB at B=16
// N=1024 f32: past the 50 MB L2), and each iteration waits on every row of
// its element before the next can start (each v needs every row's u).
//
// Design (sinkhorn_rows.cuh): K never goes to device memory where the card
// has room for it. The launch plan spreads each element over P CTAs, enough
// that each CTA's stripe of rows fits its shared memory; the CTAs of an
// element form one cluster (up to 16) or several clusters of 2-16 that meet
// behind a barrier of their own in a cooperative launch. Elements past what
// the card holds at once wait for SMs (one cluster) or are taken in turn
// (several). Each iteration reads the stripe twice from shared memory (rows
// pass: u; columns pass: this CTA's column sums) and exchanges C floats:
// reduce-scatter and gather by stores into distributed shared memory, plus
// one trip through L2 where an element spans clusters.
//
// Beyond the fused kernel's columns (1536 with f32 K, 4096 with bf16 K), the
// wide kernel (K2s, og_sinkhorn_scale_wide, the counterpart of
// _blocked_scale_kernel) runs the whole recursion in one launch on the same
// engine under make_wide_plan: K formed once from M, the rows past the card's
// shared memory written once to the workspace and read back once per
// iteration through a ring of one-row buffers filled by bulk copies (each row
// read once: its dot, its u and its share of the column sums in one visit,
// the sums held in registers), and a two-level exchange where an element
// spans more than eight clusters. What bounds it at B=1 N=4352 (bf16 K, 37.9
// MB, past the card's 30.7 MB of shared memory): one read of M (75.9 MB f32),
// then per iteration the spilled rows (a third of K) from L2 and the
// exchange's round trips through L2 between 66 clusters.
//
// Past the wide plan's reach (more columns than eight 16-byte vectors a
// thread cover, or no room for a ring of two rows beside the per-column
// buffers: about 19,000 bf16 columns where rows spill, 24,576 where none do,
// 12,288 f32), the streaming variant
// (og_sinkhorn_scale_streaming) runs the same recursion with K read from
// device memory in every half-iteration: a warp per row forms u (rows pass);
// blocks of 256 columns sum u_i K_ij over splits of 64 rows into partials
// (columns pass); a last launch adds the partials in a fixed order and forms
// v. Three launches per iteration, any column count, no atomics.

#include "sinkhorn_rows.cuh"

namespace {

template <typename KT>
__global__ void __launch_bounds__(kStripeThreads, 1)
sinkhorn_scale_kernel(const float* __restrict__ M, const float* __restrict__ log_a,
                      const float* __restrict__ log_b, float* __restrict__ u_out, void* workspace,
                      const Shape shape, int num_iters) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  Stripe<KT> st(smem, shape, workspace, cluster);
  const int R = shape.R, C = shape.C;
  st.init(cluster);
  for (int b = st.slot; b < shape.B; b += st.nslots) {
    const float* Mb = M + static_cast<size_t>(b) * R * C;
    const float* la = log_a + static_cast<size_t>(b) * R;
    const float* lb = log_b + static_cast<size_t>(b) * C;
    float* ub = u_out + static_cast<size_t>(b) * R;
    st.begin(R, shape.rows);
    st.row_max(Mb);
    for (int lr = threadIdx.x; lr < st.n; lr += kStripeThreads) st.rowa[lr] = expf(la[st.r0 + lr]);
    for (int j = threadIdx.x; j < C; j += kStripeThreads) st.vec[j] = 1.f;
    __syncthreads();
    st.load_k(Mb);
    __syncthreads();
    for (int it = 0; it + 1 < num_iters; ++it) {
      st.rows_pass([&](int lr, float y) { st.coef[lr] = st.rowa[lr] / fmaxf(y, kTiny); });
      st.cols_pass();
      st.exchange(
          [&](int j) {
            const float4 l = *reinterpret_cast<const float4*>(lb + 4 * j);
            return make_float4(expf(l.x), expf(l.y), expf(l.z), expf(l.w));
          },
          [&](int j, float4 s, float4 bj) {
            return make_float4(bj.x / fmaxf(s.x, kTiny), bj.y / fmaxf(s.y, kTiny), bj.z / fmaxf(s.z, kTiny),
                               bj.w / fmaxf(s.w, kTiny));
          });
    }
    st.rows_pass([&](int lr, float y) {
      ub[st.r0 + lr] = la[st.r0 + lr] - st.rowm[lr] - logf(fmaxf(y, kTiny));
    });
  }
  cluster.sync();  // no CTA leaves while a peer's store to it may be in flight
}

// The wide kernel (K2s): the same recursion with the spilled rows read once
// per iteration (Stripe::sweep) and the column sums of NV column vectors a
// thread kept in registers across the sweep.
template <typename KT, int NV>
__global__ void __launch_bounds__(kStripeThreads, 1)
sinkhorn_wide_kernel(const float* __restrict__ M, const float* __restrict__ log_a,
                     const float* __restrict__ log_b, float* __restrict__ u_out, void* workspace,
                     const Shape shape, int num_iters) {
  constexpr int V = Store<KT>::kVec;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  Stripe<KT> st(smem, shape, workspace, cluster);
  const int R = shape.R, C = shape.C;
  st.init(cluster);
  for (int b = st.slot; b < shape.B; b += st.nslots) {
    const float* Mb = M + static_cast<size_t>(b) * R * C;
    const float* la = log_a + static_cast<size_t>(b) * R;
    const float* lb = log_b + static_cast<size_t>(b) * C;
    float* ub = u_out + static_cast<size_t>(b) * R;
    st.begin(R, shape.rows);
    for (int lr = threadIdx.x; lr < st.n; lr += kStripeThreads) st.rowa[lr] = expf(la[st.r0 + lr]);
    for (int j = threadIdx.x; j < C; j += kStripeThreads) st.vec[j] = 1.f;
    st.form_k(Mb);
    // the spilled rows just stored are read back by bulk copies (the async proxy)
    asm volatile("fence.proxy.async;\n" ::: "memory");
    __syncthreads();
    // the spilled rows are read once in each iteration and once in the last pass
    const int total = num_iters * st.n_o;
    st.ring_prime(total);
    int done = 0;
    for (int it = 0; it + 1 < num_iters; ++it) {
      st.rows_pass_shared([&](int lr, float y) { st.coef[lr] = st.rowa[lr] / fmaxf(y, kTiny); });
      float acc[NV][V];
#pragma unroll
      for (int k = 0; k < NV; ++k)
#pragma unroll
        for (int e = 0; e < V; ++e) acc[k][e] = 0.f;
      st.template sweep<NV>(done, total, [&](int o, float y, const uint4 (&raw)[NV]) {
        st.add_row(acc, raw, st.rowa[st.ns + o] / fmaxf(y, kTiny));
      });
      st.template cols_pass_from<NV>(acc);
      st.template exchange<true>(
          [&](int j) {
            const float4 l = *reinterpret_cast<const float4*>(lb + 4 * j);
            return make_float4(expf(l.x), expf(l.y), expf(l.z), expf(l.w));
          },
          [&](int j, float4 s, float4 bj) {
            return make_float4(bj.x / fmaxf(s.x, kTiny), bj.y / fmaxf(s.y, kTiny), bj.z / fmaxf(s.z, kTiny),
                               bj.w / fmaxf(s.w, kTiny));
          });
    }
    const auto out = [&](int lr, float y) {
      ub[st.r0 + lr] = la[st.r0 + lr] - st.rowm[lr] - logf(fmaxf(y, kTiny));
    };
    st.rows_pass_shared(out);
    st.template sweep<NV>(done, total, [&](int o, float y, const uint4 (&)[NV]) {
      if (threadIdx.x == 0) out(st.ns + o, y);
    });
    st.ring_seq += static_cast<uint32_t>(total);
  }
  cluster.sync();  // no CTA leaves while a peer's store to it may be in flight
}

template <typename KT>
cudaError_t plan_for(int B, int R, int C, Plan* plan, int* caps, int* sms) {
  static int cache[8][6] = {};
  const cudaError_t err = cluster_caps(sinkhorn_scale_kernel<KT>, caps, sms, cache);
  if (err != cudaSuccess) return err;
  *plan = make_plan(B, R, C, static_cast<int>(sizeof(KT)), *sms, caps);
  return plan->ctas > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

template <typename KT>
cudaError_t fused(const float* M, const float* la, const float* lb, float* u, void* ws, int B, int R, int C,
                  int num_iters, cudaStream_t s) {
  Plan p;
  int caps[5], sms = 0;
  const cudaError_t err = plan_for<KT>(B, R, C, &p, caps, &sms);
  if (err != cudaSuccess) return err;
  const Shape shape = {B, R, C, p.ctas, p.groups, p.rows, p.smem_rows, p.exchange_bytes};
  return launch_planned(p, sinkhorn_scale_kernel<KT>, ws, s, M, la, lb, u, ws, shape, num_iters);
}

template <typename KT>
cudaError_t wide_plan_for(int B, int R, int C, Plan* plan, int* caps, int* sms) {
  // every instance holds one CTA of kStripeThreads threads per SM at the full
  // shared memory (__launch_bounds__(kStripeThreads, 1)): one reads the caps
  static int cache[8][6] = {};
  const cudaError_t err = cluster_caps(sinkhorn_wide_kernel<KT, 8>, caps, sms, cache);
  if (err != cudaSuccess) return err;
  *plan = make_wide_plan(B, R, C, static_cast<int>(sizeof(KT)), *sms, caps);
  return plan->ctas > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

template <typename KT>
cudaError_t wide(const float* M, const float* la, const float* lb, float* u, void* ws, int B, int R, int C,
                 int num_iters, cudaStream_t s) {
  Plan p;
  int caps[5], sms = 0;
  const cudaError_t err = wide_plan_for<KT>(B, R, C, &p, caps, &sms);
  if (err != cudaSuccess) return err;
  const Shape shape = {B, R, C, p.ctas, p.groups, p.rows, p.smem_rows, p.exchange_bytes, p.stages,
                       p.exchange_levels};
  switch (p.col_vecs) {
    case 2: return launch_planned(p, sinkhorn_wide_kernel<KT, 2>, ws, s, M, la, lb, u, ws, shape, num_iters);
    case 4: return launch_planned(p, sinkhorn_wide_kernel<KT, 4>, ws, s, M, la, lb, u, ws, shape, num_iters);
    case 8: return launch_planned(p, sinkhorn_wide_kernel<KT, 8>, ws, s, M, la, lb, u, ws, shape, num_iters);
    default: return cudaErrorInvalidConfiguration;
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

// The fused kernel's launch plan for B elements of R x C with K in bf16 or
// f32: out [21] ints (cluster size, clusters per element, CTAs per element,
// elements in flight, waves, grid, rows per CTA in all / in shared memory /
// in device memory, shared bytes per CTA, cooperative, ring buffers, ring
// bytes, column vectors a thread, exchange levels, SMs, then the clusters
// of 1..16 CTAs the card holds at once); bytes [2] (the exchange's and the
// whole workspace's). Returns a CUDA error code.
extern "C" int og_sinkhorn_plan(int k_is_bf16, int B, int R, int C, int* out, long long* bytes) {
  Plan p;
  int caps[5], sms = 0;
  const cudaError_t err = k_is_bf16 ? plan_for<__nv_bfloat16>(B, R, C, &p, caps, &sms)
                                    : plan_for<float>(B, R, C, &p, caps, &sms);
  if (err != cudaSuccess) return err;
  plan_report(p, caps, sms, out, bytes);
  return cudaSuccess;
}

// k_is_bf16: K's storage type. M [B, R, C] f32 with C a multiple of 8; log_a [B, R], log_b [B, C] f32; u [B, R]
// f32 out; workspace: og_sinkhorn_plan's bytes[1] (null where 0). Returns
// the CUDA error code of the launch (0 on success).
extern "C" int og_sinkhorn_scale(int k_is_bf16, const void* M, const void* log_a, const void* log_b, void* u,
                                 void* workspace, int B, int R, int C, int num_iters, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(M);
  const float* la = static_cast<const float*>(log_a);
  const float* lb = static_cast<const float*>(log_b);
  float* uo = static_cast<float*>(u);
  if (B == 0 || R == 0) return cudaSuccess;
  if (C % 8 != 0 || num_iters < 1) return cudaErrorInvalidValue;
  if (k_is_bf16) return fused<__nv_bfloat16>(m, la, lb, uo, workspace, B, R, C, num_iters, s);
  return fused<float>(m, la, lb, uo, workspace, B, R, C, num_iters, s);
}

// The wide kernel's launch plan (make_wide_plan), reported as
// og_sinkhorn_plan reports the fused one's; cudaErrorInvalidConfiguration
// where the plan places nothing (past its reach).
extern "C" int og_sinkhorn_wide_plan(int k_is_bf16, int B, int R, int C, int* out, long long* bytes) {
  Plan p;
  int caps[5], sms = 0;
  const cudaError_t err = k_is_bf16 ? wide_plan_for<__nv_bfloat16>(B, R, C, &p, caps, &sms)
                                    : wide_plan_for<float>(B, R, C, &p, caps, &sms);
  if (err != cudaSuccess) return err;
  plan_report(p, caps, sms, out, bytes);
  return cudaSuccess;
}

// The same recursion as og_sinkhorn_scale on the wide kernel, one launch
// (and a memset of the exchange where an element spans clusters);
// workspace: og_sinkhorn_wide_plan's bytes[1] (null where 0). Returns the
// CUDA error code of the launch (0 on success).
extern "C" int og_sinkhorn_scale_wide(int k_is_bf16, const void* M, const void* log_a, const void* log_b, void* u,
                                      void* workspace, int B, int R, int C, int num_iters, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(M);
  const float* la = static_cast<const float*>(log_a);
  const float* lb = static_cast<const float*>(log_b);
  float* uo = static_cast<float*>(u);
  if (B == 0 || R == 0) return cudaSuccess;
  if (C % 8 != 0 || num_iters < 1) return cudaErrorInvalidValue;
  if (k_is_bf16) return wide<__nv_bfloat16>(m, la, lb, uo, workspace, B, R, C, num_iters, s);
  return wide<float>(m, la, lb, uo, workspace, B, R, C, num_iters, s);
}

// Bytes of workspace og_sinkhorn_scale_streaming needs.
extern "C" size_t og_sinkhorn_scale_streaming_workspace(int B, int R, int C) {
  size_t bytes = 0;
  stream_buffers(nullptr, B, R, C, &bytes);
  return bytes;
}

// The same recursion as og_sinkhorn_scale for any column count (C a multiple
// of 8), with K read from device memory in every half-iteration (the route
// past the wide plan's reach).
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
