// The sphere Rayleigh quotient's TNT trial step for the H100 (sm_90a): the
// evaluator linalg/flat_cg.py:sphere_rayleigh_step and the flat engine's
// init dot group (flat_init_dots) at its output, in one launch.
//
// It replaces no Pallas kernel: the JAX package leaves the trial step to
// XLA, which fuses it on the TPU.  In eager PyTorch the same evaluator is
// ~140 ATen launches an outer iteration, 82 of them over n-length vectors;
// this kernel is that work in two passes.  From x and h (f32 or bf16) and
// the diagonal a (regenerated in registers as c + b*i), with
// u = x + h, n2 = <u,u>, fu = <u, a u>, c = 1/sqrt(n2):
//
//   x_prop = c u,   f_prop = fu / n2,   rq = 2 f_prop,
//   g      = 2c (a u) - (rq c) u,
//
// and at the stored (x_prop, g), with A0 = 2a - rq and U = (x_prop,
// 2a x_prop), the ten dots of FlatCGInit: rv = <g,g>, ar = <A0 g, g>,
// nr = |A0 g|^2, m = (<x_prop, g>, <x_prop, 2a g>), mA = (<x_prop, A0 g>,
// <x_prop, 2a A0 g>), UU = (<x_prop, x_prop>, <x_prop, 2a x_prop>,
// <x_prop, 2a 2a x_prop>); |g| = sqrt(rv), and the with_init=False norm
// sqrt(max(4 na2/n2 - rq^2, 0)) from na2 = |a u|^2.
//
// What bounds it: device-memory bytes.  Pass 1 reads x and h (2n words);
// pass 2 reads them again and writes x_prop and g (4n): 6n words, 0.12 ms at
// f32 and n = 2^24 at 3.35 TB/s, against ~30 flops an element.  Pass 2 walks
// each thread's groups in the reverse of pass 1's order, so its first reads
// are the lines pass 1 read last, which the L2 still holds.  The design
// touches each vector the fewest times the data dependence allows (every
// output needs n2 and fu, sums over all of u): the diagonal is regenerated
// in registers, A0 g and the U columns are recomputed from the stored
// values, and all ten dots fold into the pass that writes.
//
// Numbers: n2, fu and na2 sum f32 products in double, as the plain version
// does (an f32 sum at n = 2^24 is off by ~1e-6 relative, the size of the
// objective's late decreases); c, f_prop and the norm are computed in
// double from them and rounded once, as there.  x_prop and g use
// __fmul_rn/__fadd_rn/__fsub_rn in the plain version's order, so no
// multiply-add is contracted and they equal its outputs bit for bit when
// n2 and fu round to the same f32 scalars.  The ten dots are direct dots of
// the stored values (never moments of u, which cancel near the optimum):
// f32 within a thread, then double across warps, blocks and the grid.
// The affine diagonal is c + b * fl32(i) with a separate multiply and add,
// bit for bit AffineDiagonal.values and csrc/streamed_cg.cu's.
//
// Structure: one persistent cooperative grid.  Each pass's per-thread
// partials go by warp shuffle and shared memory to one double a block, the
// block sums to a scratch buffer (one region a pass), and the grid crosses
// a grid.sync(); every block then sums all block partials of pass 1 in the
// same fixed order, so every thread holds bitwise identical scalars, and
// block 0 sums pass 2's and writes the scalars.  No atomics: two runs on
// the same card are bitwise equal.
//
// Plain C interface for ctypes; see optimization_tpu_torch/kernels/
// sphere_step.py for the wrapper and the plain PyTorch version.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "storage.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kN1 = 3;    // pass 1: n2, fu, na2
constexpr int kN2 = 10;   // pass 2: rv, ar, nr, m[2], mA[2], UU00, UU01, UU11

// The scalar outputs' slots (kernels/sphere_step.py:_OUT reads them).
enum Out {
  kFProp, kRq, kGnorm, kGnormNoInit, kRv, kAr, kNr, kM0, kM1, kMA0, kMA1,
  kUU00, kUU01, kUU10, kUU11, kNOut
};

struct Params {
  const void* x;
  const void* h;
  float c;               // the diagonal: a(i) = c + b * i
  float b;
  void* xp;
  void* g;
  float* out;            // [kNOut]
  double* partial;       // [gridDim.x][kN1], then [gridDim.x][kN2]
  long long n;
};

// The diagonal at index i.
__device__ __forceinline__ float diag(const Params& P, long long i) {
  return __fadd_rn(P.c, __fmul_rn(P.b, __ll2float_rn(i)));
}

// This block's sums of N per-thread partials (double), written to
// part[blockIdx.x][N]; `red` is shared [kWarps][N].
template <int N, typename A>
__device__ __forceinline__ void block_partials(const A (&acc)[N],
                                               double (*red)[N],
                                               double* part) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < N; ++q) {
    double v = (double)acc[q];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp][q] = v;
  }
  __syncthreads();
  if (threadIdx.x < N) {
    double v = 0.0;
    for (int w = 0; w < kWarps; ++w) v += red[w][threadIdx.x];
    part[(size_t)blockIdx.x * N + threadIdx.x] = v;
  }
}

// The grid totals of part[gridDim.x][N] into shared tot[N], summed in one
// fixed order (the same in every block).
template <int N>
__device__ __forceinline__ void grid_totals(const double* part, double* tot) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int q = warp; q < N; q += kWarps) {
    double v = 0.0;
    for (unsigned b = lane; b < gridDim.x; b += 32) v += part[(size_t)b * N + q];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) tot[q] = v;
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 4) sphere_step_kernel(Params P) {
  constexpr int W = Store<T>::W;
  cg::grid_group grid = cg::this_grid();
  __shared__ double red1[kWarps][kN1];
  __shared__ double red2[kWarps][kN2];
  __shared__ double tot[kN2];

  const T* x = static_cast<const T*>(P.x);
  const T* h = static_cast<const T*>(P.h);
  T* xp = static_cast<T*>(P.xp);
  T* g = static_cast<T*>(P.g);
  const long long ngroups = (P.n + W - 1) / W;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  double* part1 = P.partial;
  double* part2 = P.partial + (size_t)gridDim.x * kN1;

  // pass 1: n2, fu, na2 (f32 products, double sums)
  double s1[kN1] = {0.0, 0.0, 0.0};
  long long last = -1;
  for (long long gi = t0; gi < ngroups; gi += stride) {
    const long long i = gi * W;
    float xv[W], hv[W];
    Store<T>::load(x, i, P.n, xv);
    Store<T>::load(h, i, P.n, hv);
#pragma unroll
    for (int e = 0; e < W; ++e) {
      const float u = __fadd_rn(xv[e], hv[e]);
      const float au = __fmul_rn(diag(P, i + e), u);
      s1[0] += (double)__fmul_rn(u, u);
      s1[1] += (double)__fmul_rn(u, au);
      s1[2] += (double)__fmul_rn(au, au);
    }
    last = gi;
  }
  block_partials<kN1>(s1, red1, part1);
  grid.sync();
  grid_totals<kN1>(part1, tot);
  const double n2 = tot[0], fu = tot[1], na2 = tot[2];

  const float c = (float)(1.0 / sqrt(n2));
  const float f_prop = (float)(fu / n2);
  const float rq = 2.f * f_prop;
  const float c2 = 2.f * c;
  const float rc = __fmul_rn(rq, c);

  // pass 2, backwards: x_prop, g and the init group's dots of their stored
  // values (f32 a thread)
  float s2[kN2];
#pragma unroll
  for (int q = 0; q < kN2; ++q) s2[q] = 0.f;
  for (long long gi = last; gi >= 0; gi -= stride) {
    const long long i = gi * W;
    float xv[W], hv[W], pv[W], gv[W];
    Store<T>::load(x, i, P.n, xv);
    Store<T>::load(h, i, P.n, hv);
#pragma unroll
    for (int e = 0; e < W; ++e) {
      const float a = diag(P, i + e);
      const float u = __fadd_rn(xv[e], hv[e]);
      const float au = __fmul_rn(a, u);
      pv[e] = __fmul_rn(c, u);
      gv[e] = __fsub_rn(__fmul_rn(c2, au), __fmul_rn(rc, u));
      const float xs = Store<T>::rounded(pv[e]);
      const float gs = Store<T>::rounded(gv[e]);
      const float ag2 = 2.f * __fmul_rn(a, gs);              // 2a g
      const float a0g = __fsub_rn(ag2, __fmul_rn(rq, gs));   // A0 g
      const float ax2 = 2.f * __fmul_rn(a, xs);              // 2a x_prop
      s2[0] += gs * gs;
      s2[1] += a0g * gs;
      s2[2] += a0g * a0g;
      s2[3] += xs * gs;
      s2[4] += xs * ag2;
      s2[5] += xs * a0g;
      s2[6] += xs * (2.f * __fmul_rn(a, a0g));
      s2[7] += xs * xs;
      s2[8] += xs * ax2;
      s2[9] += xs * (2.f * __fmul_rn(a, ax2));
    }
    Store<T>::store(xp, i, P.n, pv);
    Store<T>::store(g, i, P.n, gv);
  }
  block_partials<kN2>(s2, red2, part2);
  grid.sync();
  if (blockIdx.x != 0) return;
  grid_totals<kN2>(part2, tot);
  if (threadIdx.x == 0) {
    const float rv = (float)tot[0];
    const double gn2 = 4.0 * na2 / n2 - (fu / n2 * 2.0) * (fu / n2 * 2.0);
    P.out[kFProp] = f_prop;
    P.out[kRq] = rq;
    P.out[kGnorm] = __fsqrt_rn(rv);
    P.out[kGnormNoInit] = (float)sqrt(gn2 > 0.0 ? gn2 : 0.0);
    P.out[kRv] = rv;
    P.out[kAr] = (float)tot[1];
    P.out[kNr] = (float)tot[2];
    P.out[kM0] = (float)tot[3];
    P.out[kM1] = (float)tot[4];
    P.out[kMA0] = (float)tot[5];
    P.out[kMA1] = (float)tot[6];
    P.out[kUU00] = (float)tot[7];
    P.out[kUU01] = (float)tot[8];
    P.out[kUU10] = (float)tot[8];
    P.out[kUU11] = (float)tot[9];
  }
}

const void* kernel_of(int bf16) {
  return bf16 ? (const void*)sphere_step_kernel<__nv_bfloat16>
              : (const void*)sphere_step_kernel<float>;
}

}  // namespace

extern "C" {

// The most blocks of the storage dtype's instance that are co-resident on
// the current device: a cooperative launch's cap, which the caller sizes
// the scratch by (cap * kN1 + cap * kN2 doubles).
int sphere_step_capacity(int bf16, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel_of(bf16),
                                                    kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  *blocks = per_sm * sms;
  return (int)cudaSuccess;
}

const char* sphere_step_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// One trial step on `stream`, on at most `cap` blocks (the capacity) and no
// more than n needs; the diagonal is c + b * i.  Returns a cudaError_t
// code: the cooperative launch's own refusal, or cudaGetLastError() after
// it.
int sphere_step_launch(int bf16, const void* x, const void* h, float c,
                       float b, void* xp, void* g, float* out,
                       double* partial, int cap, long long n, void* stream) {
  const long long w = bf16 ? Store<__nv_bfloat16>::W : Store<float>::W;
  const long long want = ((n + w - 1) / w + kThreads - 1) / kThreads;
  const int grid = want < 1 ? 1 : (want < cap ? (int)want : cap);
  Params P;
  P.x = x;
  P.h = h;
  P.c = c;
  P.b = b;
  P.xp = xp;
  P.g = g;
  P.out = out;
  P.partial = partial;
  P.n = n;
  void* args[] = {&P};
  cudaError_t e = cudaLaunchCooperativeKernel(
      kernel_of(bf16), dim3(grid), dim3(kThreads), args, 0,
      (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
