// Per-element terms of the streamed CG kernels (csrc/streamed_cg.cu, the
// register instantiations K = 1-4 and the sphere layout, and
// csrc/streamed_cg_any.cu, any K): the descriptor the Python wrapper passes
// (kernels/streamed_cg.py:_Term) and its evaluation for W consecutive
// indices.

#pragma once

#include <cuda_runtime.h>

#include "storage.cuh"

namespace {

// The preconditioner's form (template parameter PK of the kernels).
constexpr int kPrecNone = 0;
constexpr int kPrecJacobi = 1;   // p = (|a0| + c)^(-e), generated
constexpr int kPrecStored = 2;   // p read from a stored f32 vector

// A per-element term t(i) (a0 or a weight).
constexpr int kTermOne = 0;      // the weight 1 (u = x); weights only
constexpr int kTermStored = 2;   // ptr[i]; 1 is c + b * i, regenerated
constexpr int kFormSelf = 0;     // t
constexpr int kFormTwice = 1;    // 2t
constexpr int kFormShift = 2;    // 2t - aux0

// Layout shared with the ctypes Structure in kernels/streamed_cg.py.
struct Term {
  const float* ptr;
  float c;
  float b;
  int mode;
  int form;
};

// W consecutive f32 values of a stored vector (16-byte loads; 0 past n).
template <int W>
__device__ __forceinline__ void load_f32(const float* v, long long i,
                                         long long n, float (&out)[W]) {
#pragma unroll
  for (int h = 0; h < W; h += 4) {
    float q[4];
    Store<float>::load(v, i + h, n, q);
#pragma unroll
    for (int e = 0; e < 4; ++e) out[h + e] = q[e];
  }
}

// A term's t(i) for W consecutive indices: read, or exactly as f32
// evaluates c + b * f32(i) (no fused multiply-add, so it matches the plain
// version's separate multiply and add).
template <int W>
__device__ __forceinline__ void term_base(const Term& t, long long i,
                                          long long n, float (&v)[W]) {
  if (t.mode == kTermStored) {
    load_f32<W>(t.ptr, i, n, v);
  } else {
#pragma unroll
    for (int e = 0; e < W; ++e)
      v[e] = __fadd_rn(t.c, __fmul_rn(t.b, __ll2float_rn(i + e)));
  }
}

// t, 2t or 2t - aux0 of a group's t(i) (one uniform branch a group).
template <int W>
__device__ __forceinline__ void term_form(int form, float aux0,
                                          const float (&t)[W], float (&v)[W]) {
  if (form == kFormTwice) {
#pragma unroll
    for (int e = 0; e < W; ++e) v[e] = 2.f * t[e];
  } else if (form == kFormShift) {
#pragma unroll
    for (int e = 0; e < W; ++e) v[e] = __fsub_rn(2.f * t[e], aux0);
  } else {
#pragma unroll
    for (int e = 0; e < W; ++e) v[e] = t[e];
  }
}

template <int W>
__device__ __forceinline__ void term_group(const Term& t, float aux0,
                                           long long i, long long n,
                                           float (&v)[W]) {
  float base[W];
  term_base<W>(t, i, n, base);
  term_form<W>(t.form, aux0, base, v);
}

__device__ __forceinline__ float pow_static(float x, float e) {
  if (e == 0.f) return 1.f;
  if (e == 0.5f) return sqrtf(x);
  if (e == 1.f) return x;
  return expf(e * logf(x));
}

}  // namespace
