// Device primitives shared by the layer and message kernels: type conversion,
// ldmatrix, mma.sync m16n8k16 (bf16 in, f32 accumulate), mma.sync m16n8k8 in
// TF32 with the 3xTF32 split, cp.async, and the head widths the kernels take.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kMasked = -1e9f;

// The head widths the attention kernels are instantiated for, with the
// logit scale dh^-1/2 and the FAVOR data norm dh^-1/4 of each (f32 of the
// exact value).
template <int DH> struct Head;
template <> struct Head<32> {
  static constexpr float scale = 0.17677669529663687f;
  static constexpr float data_norm = 0.42044820762685725f;
};
template <> struct Head<64> {
  static constexpr float scale = 0.125f;
  static constexpr float data_norm = 0.35355339059327373f;
};

// D = H * dh with dh an instantiated head width
inline bool head_width_ok(int D, int H) { return H > 0 && D % H == 0 && (D / H == 32 || D / H == 64); }

// f(std::integral_constant<int, dh>{}) for an instantiated head width, else
// cudaErrorInvalidValue
template <typename F>
cudaError_t with_head_width(int dh, F&& f) {
  switch (dh) {
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
  }
  return cudaErrorInvalidValue;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A operand of an m16n8k16 product from two 16x8 accumulator tiles (the
// 16 columns lo, hi), rounded to bf16: how a row-major f32 result feeds the
// next product without leaving registers.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&lo)[4], const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// TF32 of x, rounded to nearest (ties away), in a 32-bit register. Volatile,
// so that a split stays where it is written among the volatile loads and
// products of tf32_tiles.cuh instead of being hoisted ahead of them.
__device__ __forceinline__ uint32_t tf32_of(float x) {
  uint32_t r;
  asm volatile("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
// x = hi + lo + O(2^-22 |x|): the 3xTF32 split of one f32 operand
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_of(x);
  lo = tf32_of(x - __uint_as_float(hi));
}
template <int N>
__device__ __forceinline__ void split_tf32(const float (&x)[N], uint32_t (&hi)[N], uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split_tf32(x[i], hi[i], lo[i]);
}

// d += a (16x8, row) * b (8x8, col), tf32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16-byte asynchronous copy global -> shared; a false predicate zero-fills
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
template <typename T> __device__ __forceinline__ float round_to(float x) { return to_f(from_f<T>(x)); }

// additive key mask: 0 valid, -1e9 masked, -inf beyond the key set
__device__ __forceinline__ float mask_add(const uint8_t* mask, int b, int M, int key) {
  if (key >= M) return -INFINITY;  // beyond the key set: no weight at all
  return (mask != nullptr && mask[static_cast<size_t>(b) * M + key] == 0) ? kMasked : 0.f;
}

// Where a [B, H, L, dh] attention operand lies: element (b, h, r, c) is at
// base + b * batch + h * head + r * row + c, counted in elements. The kernels
// load 16 bytes at a time, so every stride and the base are multiples of 16
// bytes.
struct HeadLayout {
  long long batch, head, row;
};
// head h in columns [h * dh, h * dh + dh) of a [B, L, ld] buffer
inline HeadLayout column_heads(int L, int ld, int dh) {
  return {static_cast<long long>(L) * ld, dh, ld};
}

// A bump allocator over one workspace; every block 256-byte aligned. With a
// null base it only measures (the wrapper asks for the size first).
struct Carve {
  char* base;
  size_t used = 0;
  template <typename T>
  T* take(size_t count) {
    T* p = base ? reinterpret_cast<T*>(base + used) : nullptr;
    used += (count * sizeof(T) + 255) / 256 * 256;
    return p;
  }
};

}  // namespace
