// Row-stripe helpers shared by the Sinkhorn forward (sinkhorn.cu) and its
// adjoint (sinkhorn_adjoint.cu): one cluster of kCluster CTAs per batch
// element, each warp holding whole rows of K in registers as 16-byte vectors.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;  // CTAs per batch element
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kTiny = 1e-30f;

template <typename KT> struct Store;
template <> struct Store<float> {
  static constexpr int kVec = 4;  // elements per 16-byte vector
  __device__ static void unpack(const uint4& raw, float* out) {
    out[0] = __uint_as_float(raw.x); out[1] = __uint_as_float(raw.y);
    out[2] = __uint_as_float(raw.z); out[3] = __uint_as_float(raw.w);
  }
  __device__ static void pack_store(float* dst, const float* in) {
    *reinterpret_cast<float4*>(dst) = make_float4(in[0], in[1], in[2], in[3]);
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
  __device__ static void pack_store(__nv_bfloat16* dst, const float* in) {
    uint4 raw;
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
    *reinterpret_cast<uint4*>(dst) = raw;
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

// Load one row's slice into registers (NC chunks of one 16-byte vector per
// lane; chunk c covers columns [c*32*V, (c+1)*32*V)); a missing row loads 0.
template <typename KT, int NC>
__device__ __forceinline__ void load_row(const KT* row, bool present, int C, int lane,
                                         uint4 (&k)[NC]) {
  constexpr int V = Store<KT>::kVec;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int col = (c * 32 + lane) * V;
    k[c] = present && col < C ? *reinterpret_cast<const uint4*>(row + col) : make_uint4(0, 0, 0, 0);
  }
}

// This lane's part of the dot of a row slice with v (not yet warp-reduced).
template <typename KT, int NC>
__device__ __forceinline__ float lane_dot(const uint4 (&k)[NC], const float* v, int C, int lane) {
  constexpr int V = Store<KT>::kVec;
  float y = 0.f;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int col = (c * 32 + lane) * V;
    if (col < C) {
      float kv[V];
      Store<KT>::unpack(k[c], kv);
#pragma unroll
      for (int e = 0; e < V; ++e) y = fmaf(kv[e], v[col + e], y);
    }
  }
  return y;
}

template <typename KT, int NC>
__device__ __forceinline__ void accumulate(const uint4 (&k)[NC], float uh,
                                           float (&r)[NC][Store<KT>::kVec]) {
  constexpr int V = Store<KT>::kVec;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    float kv[V];
    Store<KT>::unpack(k[c], kv);
#pragma unroll
    for (int e = 0; e < V; ++e) r[c][e] = fmaf(uh, kv[e], r[c][e]);
  }
}

}  // namespace
