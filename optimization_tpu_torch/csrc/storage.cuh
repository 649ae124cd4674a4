// Storage access shared by the port's CUDA kernels: f32 or bf16 vectors in
// device memory, f32 in registers, W elements per 16-byte vector load with a
// masked tail, so any n works.  Loads past n read 0; stores past n are
// dropped.  The vector path needs 16-byte aligned base pointers (the Python
// wrappers ensure it, kernels/streamed_cg.py:_aligned).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

template <typename T> struct Store;

template <> struct Store<float> {
  static constexpr int W = 4;
  __device__ static float get(const float* p, long long i) { return p[i]; }
  // the value a store then a load gives back
  __device__ static float rounded(float v) { return v; }
  __device__ static void load(const float* p, long long i, long long n,
                              float (&v)[W]) {
    if (i + W <= n) {
      const float4 t = *reinterpret_cast<const float4*>(p + i);
      v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
    } else {
#pragma unroll
      for (int e = 0; e < W; ++e) v[e] = (i + e < n) ? p[i + e] : 0.f;
    }
  }
  __device__ static void store(float* p, long long i, long long n,
                               const float (&v)[W]) {
    if (i + W <= n) {
      *reinterpret_cast<float4*>(p + i) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int e = 0; e < W; ++e)
        if (i + e < n) p[i + e] = v[e];
    }
  }
};

template <> struct Store<__nv_bfloat16> {
  static constexpr int W = 8;
  __device__ static float get(const __nv_bfloat16* p, long long i) {
    return __bfloat162float(p[i]);
  }
  __device__ static float rounded(float v) {
    return __bfloat162float(__float2bfloat16(v));
  }
  __device__ static void load(const __nv_bfloat16* p, long long i, long long n,
                              float (&v)[W]) {
    if (i + W <= n) {
      const uint4 t = *reinterpret_cast<const uint4*>(p + i);
      const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&t);
#pragma unroll
      for (int e = 0; e < W; ++e) v[e] = __bfloat162float(h[e]);
    } else {
#pragma unroll
      for (int e = 0; e < W; ++e)
        v[e] = (i + e < n) ? __bfloat162float(p[i + e]) : 0.f;
    }
  }
  __device__ static void store(__nv_bfloat16* p, long long i, long long n,
                               const float (&v)[W]) {
    if (i + W <= n) {
      uint4 t;
      __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&t);
#pragma unroll
      for (int e = 0; e < W; ++e) h[e] = __float2bfloat16(v[e]);
      *reinterpret_cast<uint4*>(p + i) = t;
    } else {
#pragma unroll
      for (int e = 0; e < W; ++e)
        if (i + e < n) p[i + e] = __float2bfloat16(v[e]);
    }
  }
};
