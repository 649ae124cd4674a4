// Fused reductions and the stencil operator for the H100 (sm_90a).
//
// Replaces the Pallas TPU kernels of optimization_tpu/kernels/fused.py:
//
//   cg_dots_kernel       <- cg_dots (fused.py:86, pallas_call :103):
//                           <p,Hp>, <Hp,Hp>, <p,p>, <p,r> in one read of
//                           (p, Hp, r);
//   axpy_selfdot_kernel  <- axpy_selfdot (fused.py:130, :146):
//                           out = alpha x + y and <out,out> in one pass;
//   stencil_kernel       <- diag_stencil_matvec (fused.py:279, :309) and
//                           affine_stencil_matvec (fused.py:370, :395):
//                           scale ((d + 2) v - v[i+1] - v[i-1]), zeros
//                           outside [0, n), d stored or d = a + b i;
//   stream3_kernel       <- stream3_probe (fused.py:325, :345):
//                           (d + 2) v scale, the read-read-write stream the
//                           stencil moves with no stencil work: the measured
//                           bandwidth ceiling of the others.
//
// The sixth kernel of that file, gram_pair (fused.py:185), has a source of
// its own: csrc/gram_pair.cu.
//
// What bounds the vector kernels: device-memory bytes.  Per element cg_dots
// reads 3 words for 8 flops, axpy_selfdot moves 3 words (2 reads, 1 write)
// for 4 flops, the stencil 3 words with a stored diagonal and 2 with the
// affine one for 6 flops, stream3 3 words for 3 flops: all far below the
// H100's ~20 flops per byte of f32 balance.  The design answers that by
// touching each vector once: 16-byte vector loads and stores in a
// grid-stride loop, a masked tail (any n, no padding), the affine diagonal
// regenerated in registers, and the stencil's neighbours v[i-1], v[i+W]
// read as scalars that hit the lines the neighbouring threads' vector loads
// bring into L1/L2 (no halo pass, no side arrays).
//
// The Pallas kernels carry their sums across a sequential grid in SMEM.
// Blocks on Hopper run in any order, so the reductions take two passes:
// each thread accumulates f32 partials,
// warp shuffles and one shared-memory step combine them per block in
// double, the block sums go to a scratch buffer, and a one-block second
// pass adds them in a fixed order.  No float atomics: two runs on the same
// card and the same n are bitwise equal.
//
// Arithmetic is f32 for f32 and bf16 storage, rounded once on store.  The
// elementwise results use __fmul_rn/__fadd_rn/__fsub_rn in the order of the
// plain PyTorch versions (kernels/fused.py), so no multiply-add is
// contracted and f32 results equal theirs bit for bit.  The affine index i
// is converted with __ll2float_rn: exact up to 2^24; above that it rounds
// to the nearest f32, as torch.arange(n, dtype=float32) does in the plain
// version, so d = a + b fl32(i) there (still a diagonal, so the operator
// stays symmetric).
//
// Plain C interface for ctypes; see optimization_tpu_torch/kernels/fused.py
// for the wrappers and the plain versions.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "storage.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Resident blocks per SM the grid is capped at: 2048 threads per SM.
constexpr int kBlocksPerSm = 8;

// Per-block sums of NACC per-thread partials (warp shuffles, then one
// shared-memory step, in double), written to part[blockIdx.x][NACC].
template <int NACC>
__device__ void block_partials(const float (&acc)[NACC], double* part) {
  __shared__ double red[kWarps][NACC];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int a = 0; a < NACC; ++a) {
    double v = acc[a];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp][a] = v;
  }
  __syncthreads();
  if (threadIdx.x < NACC) {
    double v = 0.0;
    for (int w = 0; w < kWarps; ++w) v += red[w][threadIdx.x];
    part[(size_t)blockIdx.x * NACC + threadIdx.x] = v;
  }
}

// The second pass: one block adds the per-block partials in a fixed order
// and writes the NACC totals as f32.
template <int NACC>
__global__ void __launch_bounds__(kThreads)
    finish_kernel(const double* part, int nblocks, float* out) {
  __shared__ double red[kWarps][NACC];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int a = 0; a < NACC; ++a) {
    double v = 0.0;
    for (int b = threadIdx.x; b < nblocks; b += kThreads)
      v += part[(size_t)b * NACC + a];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp][a] = v;
  }
  __syncthreads();
  if (threadIdx.x < NACC) {
    double v = 0.0;
    for (int w = 0; w < kWarps; ++w) v += red[w][threadIdx.x];
    out[threadIdx.x] = (float)v;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    cg_dots_kernel(const T* p, const T* hp, const T* r, long long n,
                   double* part) {
  constexpr int W = Store<T>::W;
  const long long ngroups = (n + W - 1) / W;
  const long long stride = (long long)gridDim.x * kThreads;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (long long gi = (long long)blockIdx.x * kThreads + threadIdx.x;
       gi < ngroups; gi += stride) {
    float pv[W], hv[W], rv[W];
    Store<T>::load(p, gi * W, n, pv);
    Store<T>::load(hp, gi * W, n, hv);
    Store<T>::load(r, gi * W, n, rv);
#pragma unroll
    for (int e = 0; e < W; ++e) {
      acc[0] += pv[e] * hv[e];
      acc[1] += hv[e] * hv[e];
      acc[2] += pv[e] * pv[e];
      acc[3] += pv[e] * rv[e];
    }
  }
  block_partials<4>(acc, part);
}

// alpha is read from device memory (a 0-d tensor the CG loop computed), so
// the caller never reads it back to the host.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    axpy_selfdot_kernel(const float* alpha, const T* x, const T* y, T* out,
                        long long n, double* part) {
  constexpr int W = Store<T>::W;
  const long long ngroups = (n + W - 1) / W;
  const long long stride = (long long)gridDim.x * kThreads;
  const float a = *alpha;
  float acc[1] = {0.f};
  for (long long gi = (long long)blockIdx.x * kThreads + threadIdx.x;
       gi < ngroups; gi += stride) {
    float xv[W], yv[W], o[W];
    Store<T>::load(x, gi * W, n, xv);
    Store<T>::load(y, gi * W, n, yv);
#pragma unroll
    for (int e = 0; e < W; ++e) o[e] = __fadd_rn(__fmul_rn(a, xv[e]), yv[e]);
    Store<T>::store(out, gi * W, n, o);
    // the norm of the vector as stored (past n, o is 0)
#pragma unroll
    for (int e = 0; e < W; ++e) {
      const float s = Store<T>::rounded(o[e]);
      acc[0] += s * s;
    }
  }
  block_partials<1>(acc, part);
}

// d == nullptr selects the affine diagonal a + b i.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    stencil_kernel(const T* d, const T* v, T* out, long long n, float a,
                   float b, float scale) {
  constexpr int W = Store<T>::W;
  const long long ngroups = (n + W - 1) / W;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long gi = (long long)blockIdx.x * kThreads + threadIdx.x;
       gi < ngroups; gi += stride) {
    const long long i = gi * W;
    float vv[W], dd[W], o[W];
    Store<T>::load(v, i, n, vv);
    if (d != nullptr) {
      Store<T>::load(d, i, n, dd);
    } else {
#pragma unroll
      for (int e = 0; e < W; ++e)
        dd[e] = __fadd_rn(__fmul_rn(b, __ll2float_rn(i + e)), a);
    }
    const float left = i > 0 ? Store<T>::get(v, i - 1) : 0.f;
    const float right = i + W < n ? Store<T>::get(v, i + W) : 0.f;
#pragma unroll
    for (int e = 0; e < W; ++e) {
      const float up = e + 1 < W ? vv[e + 1] : right;    // v[i+e+1]
      const float down = e > 0 ? vv[e - 1] : left;       // v[i+e-1]
      const float t = __fmul_rn(__fadd_rn(dd[e], 2.f), vv[e]);
      o[e] = __fmul_rn(__fsub_rn(__fsub_rn(t, up), down), scale);
    }
    Store<T>::store(out, i, n, o);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    stream3_kernel(const T* d, const T* v, T* out, long long n, float scale) {
  constexpr int W = Store<T>::W;
  const long long ngroups = (n + W - 1) / W;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long gi = (long long)blockIdx.x * kThreads + threadIdx.x;
       gi < ngroups; gi += stride) {
    const long long i = gi * W;
    float dd[W], vv[W], o[W];
    Store<T>::load(d, i, n, dd);
    Store<T>::load(v, i, n, vv);
#pragma unroll
    for (int e = 0; e < W; ++e)
      o[e] = __fmul_rn(__fmul_rn(__fadd_rn(dd[e], 2.f), vv[e]), scale);
    Store<T>::store(out, i, n, o);
  }
}

template <typename T>
cudaError_t grid_for(long long n, int* grid) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long long groups = (n + Store<T>::W - 1) / Store<T>::W;
  long long want = (groups + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * kBlocksPerSm;
  if (want < 1) want = 1;
  *grid = (int)(want < cap ? want : cap);
  return cudaSuccess;
}

template <typename T>
int cg_dots_launch(const void* p, const void* hp, const void* r, long long n,
                   int grid, double* part, float* out, cudaStream_t st) {
  cg_dots_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(p), static_cast<const T*>(hp),
      static_cast<const T*>(r), n, part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  finish_kernel<4><<<1, kThreads, 0, st>>>(part, grid, out);
  return (int)cudaGetLastError();
}

template <typename T>
int axpy_selfdot_launch(const float* alpha, const void* x, const void* y,
                        void* out, long long n, int grid, double* part,
                        float* dot, cudaStream_t st) {
  axpy_selfdot_kernel<T><<<grid, kThreads, 0, st>>>(
      alpha, static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<T*>(out), n, part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  finish_kernel<1><<<1, kThreads, 0, st>>>(part, grid, dot);
  return (int)cudaGetLastError();
}

template <typename T>
int stencil_launch(const void* d, const void* v, void* out, long long n,
                   float a, float b, float scale, int grid, cudaStream_t st) {
  stencil_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(d), static_cast<const T*>(v), static_cast<T*>(out),
      n, a, b, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int stream3_launch(const void* d, const void* v, void* out, long long n,
                   float scale, int grid, cudaStream_t st) {
  stream3_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(d), static_cast<const T*>(v), static_cast<T*>(out),
      n, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Blocks a launch over n elements uses; the caller sizes a reduction's
// scratch buffer as grid * (4 for cg_dots, 1 for axpy_selfdot) doubles.
int fused_grid(int bf16, long long n, int* grid) {
  return bf16 ? (int)grid_for<__nv_bfloat16>(n, grid)
              : (int)grid_for<float>(n, grid);
}

const char* fused_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Each launch function enqueues on `stream` and returns cudaGetLastError()
// after its launches (0 when both were accepted).

// out[4] = (<p,Hp>, <Hp,Hp>, <p,p>, <p,r>) in f32.
int fused_cg_dots(int bf16, const void* p, const void* hp, const void* r,
                  long long n, int grid, double* part, float* out,
                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? cg_dots_launch<__nv_bfloat16>(p, hp, r, n, grid, part, out, st)
              : cg_dots_launch<float>(p, hp, r, n, grid, part, out, st);
}

// out = alpha x + y (alpha an f32 on the device), dot[0] = <out, out>.
int fused_axpy_selfdot(int bf16, const float* alpha, const void* x,
                       const void* y, void* out, long long n, int grid,
                       double* part, float* dot, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? axpy_selfdot_launch<__nv_bfloat16>(alpha, x, y, out, n, grid,
                                                   part, dot, st)
              : axpy_selfdot_launch<float>(alpha, x, y, out, n, grid, part,
                                           dot, st);
}

// out = scale ((d + 2) v - v[i+1] - v[i-1]); d stored (same dtype as v) or,
// when d is NULL, a + b i.
int fused_stencil(int bf16, const void* d, const void* v, void* out,
                  long long n, float a, float b, float scale, int grid,
                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? stencil_launch<__nv_bfloat16>(d, v, out, n, a, b, scale, grid,
                                              st)
              : stencil_launch<float>(d, v, out, n, a, b, scale, grid, st);
}

// out = (d + 2) v scale (d, v and out of one dtype).
int fused_stream3(int bf16, const void* d, const void* v, void* out,
                  long long n, float scale, int grid, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? stream3_launch<__nv_bfloat16>(d, v, out, n, scale, grid, st)
              : stream3_launch<float>(d, v, out, n, scale, grid, st);
}

}  // extern "C"
