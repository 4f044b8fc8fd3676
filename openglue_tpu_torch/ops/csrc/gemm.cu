// The dense GEMMs of the layer kernels on their own, for tests and timing
// (ops/kernels/gemm_kernel.py): gemm.cuh's tiled GEMM with each epilogue, and
// tn_gemm.cuh's weight-gradient GEMM with its ordered reduction. Nothing on
// the model's path calls these entries; the layer kernels (K1, K4, K5, K6,
// K8) launch the same device code from their own entries.

#include "gemm.cuh"
#include "tn_gemm.cuh"

namespace {

template <typename T>
cudaError_t run_epilogue(const GemmArgs<T>& p, int epilogue, int kn, cudaStream_t s) {
  if (kn) return epilogue == kBias ? gemm<T, kBias, true>(p, s) : cudaErrorInvalidValue;
  switch (epilogue) {
    case kBias: return gemm<T, kBias>(p, s);
    case kConcat: return gemm<T, kConcat>(p, s);
    case kReluAffine: return gemm<T, kReluAffine>(p, s);
    case kResidual: return gemm<T, kResidual>(p, s);
    case kBiasF32: return gemm<T, kBiasF32>(p, s);
    case kRelu: return gemm<T, kRelu>(p, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
GemmArgs<T> args_of(int rows, int n_out, int k, const void* a, int lda, const void* w, const void* bias,
                    void* out, int ldo, const void* x, int ldx, const void* scale, const void* shift,
                    int use_offset, const void* w2, const void* bias2, int split, int k_split) {
  GemmArgs<T> p{static_cast<const T*>(a), lda, static_cast<const T*>(w), static_cast<const float*>(bias),
                rows, n_out, k, static_cast<T*>(out), ldo, static_cast<const T*>(x), ldx,
                static_cast<const float*>(scale), static_cast<const float*>(shift), use_offset};
  p.W2 = static_cast<const T*>(w2);
  p.bias2 = static_cast<const float*>(bias2);
  p.split = split;
  p.k_split = k_split;
  return p;
}

TnPlan plan_of(int is_bf16, int problems, const int* rows, int P, int Q) {
  int most = 0;
  for (int i = 0; i < problems; ++i) most = rows[i] > most ? rows[i] : most;
  return is_bf16 ? tn_plan<bf16>(most, P, Q, problems) : tn_plan<float>(most, P, Q, problems);
}

}  // namespace

// out = epilogue(a . w^T + bias) over `rows` rows (with kn, a . w for w
// [k, n_out]). is_bf16 selects the type T of a, w, x and out (kBiasF32
// writes f32 out). epilogue: 0 bias, 1 concat (out [rows, 2 n_out]: [x or
// x - m, m]), 2 relu_affine (relu, then * scale + shift), 3 residual (x +
// y), 4 bias_f32, 5 relu; kn takes epilogue 0 only. Output columns from
// `split` on take w2 and bias2; with kn, rows of w from `k_split` on are rows
// of w2. n_out a multiple of 64, k of 32, every row stride a multiple of 16
// bytes; in bf16, split and k_split multiples of 8.
// Returns the CUDA error code (0 on success).
extern "C" int og_gemm(int is_bf16, int epilogue, int kn, int rows, int n_out, int k, const void* a,
                       int lda, const void* w, const void* bias, void* out, int ldo, const void* x, int ldx,
                       const void* scale, const void* shift, int use_offset, const void* w2, const void* bias2,
                       int split, int k_split, void* stream) {
  if (rows <= 0 || n_out <= 0 || n_out % 64 != 0 || k <= 0 || k % kBK != 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return run_epilogue<bf16>(args_of<bf16>(rows, n_out, k, a, lda, w, bias, out, ldo, x, ldx, scale, shift,
                                            use_offset, w2, bias2, split, k_split),
                              epilogue, kn, s);
  return run_epilogue<float>(args_of<float>(rows, n_out, k, a, lda, w, bias, out, ldo, x, ldx, scale, shift,
                                            use_offset, w2, bias2, split, k_split),
                             epilogue, kn, s);
}

// Bytes of workspace og_tn_gemm needs for `problems` products of P x Q over
// rows[i] rows each.
extern "C" size_t og_tn_gemm_workspace(int is_bf16, int problems, const int* rows, int P, int Q) {
  const TnPlan pl = plan_of(is_bf16, problems, rows, P, Q);
  return static_cast<size_t>(problems) * pl.splits * P * Q * sizeof(float);
}

// outs[i] = xs[i]^T ys[i] (f32, [P, Q]) for i < problems (1 to 4), xs[i]
// [rows[i], >= P] with row stride ldx[i], ys[i] [rows[i], >= Q] with ldy[i],
// in the type is_bf16 selects, through per-chunk partials in the workspace
// summed in a fixed order. P and Q multiples of 64. Returns the CUDA error
// code.
extern "C" int og_tn_gemm(int is_bf16, int problems, const void* const* xs, const int* ldx,
                          const void* const* ys, const int* ldy, const int* rows, int P, int Q,
                          void* const* outs, void* workspace, void* stream) {
  if (problems < 1 || problems > 4 || P <= 0 || Q <= 0 || P % 64 != 0 || Q % 64 != 0) return cudaErrorInvalidValue;
  const TnPlan pl = plan_of(is_bf16, problems, rows, P, Q);
  if (pl.splits <= 0) return cudaErrorInvalidValue;
  TnArgs a{};
  Outputs4 o{};
  for (int i = 0; i < problems; ++i) {
    a.p[i] = {xs[i], ldx[i], ys[i], ldy[i], rows[i]};
    o.out[i] = static_cast<float*>(outs[i]);
  }
  a.P = P; a.Q = Q; a.chunk = pl.chunk; a.splits = pl.splits; a.partial = static_cast<float*>(workspace);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return tn_gemm<bf16>(a, problems, pl.tile, o, s);
  return tn_gemm<float>(a, problems, pl.tile, o, s);
}
