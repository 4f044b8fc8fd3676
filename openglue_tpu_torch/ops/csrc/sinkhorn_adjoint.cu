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
// What bounds it on the H100: 2T passes of 2 FMAs per entry of K (8T - 2
// FMAs per entry in all) against one read of M (4.2 MB per element at
// N = 1024), so at T = 20 it is bound by operations; a kernel that keeps K
// in device memory reads it 2T times instead (B=12 N=1024: 50.8 MB, the size
// of the L2, 40 times).
//
// Design: the forward kernel's engine (sinkhorn_rows.cuh, sinkhorn.cu): K
// stays in each CTA's stripe of shared memory under the same launch plan;
// every step of both recursions is a rows pass and a columns pass over the
// stripe and one exchange of C floats. The histories u, y (per row) and r, v
// (per column) go to device memory, about 330 KB per element at N = 1024,
// T = 20, each read back only by the thread that wrote it (every cluster of
// an element writes the same column histories). f32 K only; the wrapper caps
// the columns at 1536.

#include "sinkhorn_rows.cuh"

namespace {

__device__ __forceinline__ float4 ldcg4(const float* p) {
  return make_float4(__ldcg(p), __ldcg(p + 1), __ldcg(p + 2), __ldcg(p + 3));
}
__device__ __forceinline__ void st4(float* p, float4 x) {
  p[0] = x.x; p[1] = x.y; p[2] = x.z; p[3] = x.w;
}

struct Column {  // v_{t-1} and r_{t-1} of four columns, from the histories
  float4 v, r;
};

__global__ void __launch_bounds__(kStripeThreads, 1)
sinkhorn_adjoint_kernel(const float* __restrict__ M, const float* __restrict__ log_a,
                        const float* __restrict__ log_b, const float* __restrict__ rmax,
                        const float* __restrict__ g_rowsum, const float* __restrict__ g_colsum,
                        float* __restrict__ hist, float* __restrict__ P, float* __restrict__ Q,
                        void* workspace, const Shape shape, int T) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  Stripe<float> st(smem, shape, workspace, cluster);
  const int R = shape.R, C = shape.C;
  // one step's history: u [R], y [R], r [C], v [C]
  const size_t step = 2 * static_cast<size_t>(R) + 2 * static_cast<size_t>(C);
  const bool writer = st.g == 0;  // the element's first cluster writes Q
  const float4 ones = make_float4(1.f, 1.f, 1.f, 1.f);
  st.init(cluster);
  for (int b = st.slot; b < shape.B; b += st.nslots) {
    const float* Mb = M + static_cast<size_t>(b) * R * C;
    const float* la = log_a + static_cast<size_t>(b) * R;
    const float* rm = rmax + static_cast<size_t>(b) * R;
    const float* grow = g_rowsum + static_cast<size_t>(b) * R;
    const float* lb = log_b + static_cast<size_t>(b) * C;
    const float* gcol = g_colsum + static_cast<size_t>(b) * C;
    float* hb = hist + static_cast<size_t>(b) * T * step;
    float* Pb = P + static_cast<size_t>(b) * 2 * T * R;
    float* Qb = Q + static_cast<size_t>(b) * 2 * T * C;
    st.begin(R, shape.rows);
    for (int lr = threadIdx.x; lr < st.n; lr += kStripeThreads) {
      st.rowm[lr] = rm[st.r0 + lr];
      st.rowa[lr] = expf(la[st.r0 + lr]);
    }
    for (int j = threadIdx.x; j < C; j += kStripeThreads) st.vec[j] = 1.f;
    __syncthreads();
    st.load_k(Mb);
    __syncthreads();

    // forward replay: u, y per row; r, v per column
    for (int t = 0; t < T; ++t) {
      float* hu = hb + t * step;
      float* hy = hu + R;
      float* hr = hu + 2 * R;
      float* hv = hr + C;
      st.rows_pass([&](int lr, float y) {
        const float yc = fmaxf(y, kTiny);
        const float u = st.rowa[lr] / yc;
        st.coef[lr] = u;
        hu[st.r0 + lr] = u;
        hy[st.r0 + lr] = yc;
      });
      st.cols_pass();
      const bool last = t == T - 1;
      st.exchange(
          [&](int j) {
            const float4 l = *reinterpret_cast<const float4*>(lb + 4 * j);
            return make_float4(expf(l.x), expf(l.y), expf(l.z), expf(l.w));
          },
          [&](int j, float4 s, float4 bj) {
            const float4 rr =
                make_float4(fmaxf(s.x, kTiny), fmaxf(s.y, kTiny), fmaxf(s.z, kTiny), fmaxf(s.w, kTiny));
            const float4 v = make_float4(bj.x / rr.x, bj.y / rr.y, bj.z / rr.z, bj.w / rr.w);
            // every cluster writes the same column histories: each reader
            // later reads back what its own thread wrote
            st4(hr + 4 * j, rr);
            st4(hv + 4 * j, v);
            if (!last) return v;
            // the reverse recursion's first vector, gv / r_{T-1}
            const float4 gc = *reinterpret_cast<const float4*>(gcol + 4 * j);
            const float4 w = make_float4(gc.x / rr.x, gc.y / rr.y, gc.z / rr.z, gc.w / rr.w);
            if (writer) {
              *reinterpret_cast<float4*>(Qb + static_cast<size_t>(T - 1) * C + 4 * j) = w;
              *reinterpret_cast<float4*>(Qb + static_cast<size_t>(2 * T - 1) * C + 4 * j) =
                  T > 1 ? ldcg4(hb + static_cast<size_t>(T - 2) * step + 2 * R + C + 4 * j) : ones;
            }
            return w;
          });
    }

    // reverse recursion; vec holds gv / r_slot
    for (int tr = 0; tr < T; ++tr) {
      const int slot = T - 1 - tr;
      const float* hu = hb + slot * step;
      const float* hy = hu + R;
      st.rows_pass([&](int lr, float d) {
        const int i = st.r0 + lr;
        const float u = hu[i];
        const float s = ((tr == 0 ? grow[i] : 0.f) - u * d) / hy[i];
        st.coef[lr] = s;
        Pb[static_cast<size_t>(slot) * R + i] = u;
        Pb[static_cast<size_t>(T + slot) * R + i] = s;
      });
      if (slot == 0) break;  // the gradient of the first v is not needed
      st.cols_pass();
      const float* hr_prev = hb + static_cast<size_t>(slot - 1) * step + 2 * R;
      const float* hv_prev = hr_prev + C;
      st.exchange(
          [&](int j) { return Column{ldcg4(hv_prev + 4 * j), ldcg4(hr_prev + 4 * j)}; },
          [&](int j, float4 s, const Column& c) {
            const float4 w = make_float4(-c.v.x * s.x / c.r.x, -c.v.y * s.y / c.r.y, -c.v.z * s.z / c.r.z,
                                         -c.v.w * s.w / c.r.w);
            if (writer) {
              *reinterpret_cast<float4*>(Qb + static_cast<size_t>(slot - 1) * C + 4 * j) = w;
              *reinterpret_cast<float4*>(Qb + static_cast<size_t>(T + slot - 1) * C + 4 * j) =
                  slot > 1 ? ldcg4(hb + static_cast<size_t>(slot - 2) * step + 2 * R + C + 4 * j) : ones;
            }
            return w;
          });
    }
  }
  cluster.sync();  // no CTA leaves while a peer's store to it may be in flight
}

cudaError_t plan_for(int B, int R, int C, Plan* plan, int* caps, int* sms) {
  static int cache[8][6] = {};
  const cudaError_t err = cluster_caps(sinkhorn_adjoint_kernel, caps, sms, cache);
  if (err != cudaSuccess) return err;
  *plan = make_plan(B, R, C, 4, *sms, caps);
  return plan->ctas > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

}  // namespace

// The adjoint kernel's launch plan, reported as og_sinkhorn_plan reports the
// forward's (f32 K). Returns a CUDA error code.
extern "C" int og_sinkhorn_adjoint_plan(int B, int R, int C, int* out, long long* bytes) {
  Plan p;
  int caps[5], sms = 0;
  const cudaError_t err = plan_for(B, R, C, &p, caps, &sms);
  if (err != cudaSuccess) return err;
  plan_report(p, caps, sms, out, bytes);
  return cudaSuccess;
}

// M [B, R, C] f32 with C a multiple of 8 and at most 1536; log_a, rmax,
// g_rowsum [B, R]; log_b, g_colsum [B, C] (all f32). Scratch: hist
// [B, T, 2R + 2C] f32 and the workspace of og_sinkhorn_adjoint_plan's
// bytes[1] (null where 0). Outputs P [B, 2T, R] and Q [B, 2T, C] f32.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int og_sinkhorn_adjoint(const void* M, const void* log_a, const void* log_b, const void* rmax,
                                   const void* g_rowsum, const void* g_colsum, void* hist, void* P, void* Q,
                                   void* workspace, int B, int R, int C, int T, void* stream) {
  if (B == 0 || R == 0) return cudaSuccess;
  if (T < 1 || C % 8 != 0) return cudaErrorInvalidValue;
  Plan p;
  int caps[5], sms = 0;
  const cudaError_t err = plan_for(B, R, C, &p, caps, &sms);
  if (err != cudaSuccess) return err;
  const Shape shape = {B, R, C, p.ctas, p.groups, p.rows, p.smem_rows, p.exchange_bytes};
  const float* m = static_cast<const float*>(M);
  const float* la = static_cast<const float*>(log_a);
  const float* lb = static_cast<const float*>(log_b);
  const float* rm = static_cast<const float*>(rmax);
  const float* gr = static_cast<const float*>(g_rowsum);
  const float* gc = static_cast<const float*>(g_colsum);
  float* h = static_cast<float*>(hist);
  float* pp = static_cast<float*>(P);
  float* qq = static_cast<float*>(Q);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return launch_planned(p, sinkhorn_adjoint_kernel, workspace, s, m, la, lb, rm, gr, gc, h, pp, qq, workspace, shape,
                        T);
}
