// The edge->vertex segment sum of the port's graph models for the H100
// (sm_90a): out[v] = the sum, over the run of slots that the plan sorted
// onto vertex v, of the contribution rows of those slots, every row of
// `width` words (f32 or f64).
//
// It replaces no Pallas kernel.  The JAX package sums per-edge contributions
// onto vertices with `.at[idx].add` and `segment_sum`
// (optimization_tpu/models/graph.py:84-86, 135), which XLA lowers, and its
// results repeat from run to run.  PyTorch's index_add adds with atomics on
// the card, in an order that varies from run to run, and its deterministic
// index_put(accumulate=True) sorts the indices again at every call.  This
// kernel takes the order that the plan (kernels/segment_sum.py:segment_plan)
// sorted once: each thread owns one word (v, c) of the output and adds the
// words of v's run one after another, in the plan's order (the slots' order,
// stable), starting from zero.  No atomics: two runs are bitwise equal, and
// the order of the adds is that of index_add on the CPU, one part after the
// other in index order, so the plain version on the CPU gives the same bits.
//
// What bounds it: device-memory bytes (one add a word read): the
// contributions once, the plan's order and run bounds, the output once.
// Neighbouring threads take neighbouring words of a row, so a row of the
// connection Laplacian (d k words) is read by neighbouring lanes; the rows
// of a run lie where the edges put them.  A vertex with a long run (a hub)
// is summed by its own threads alone, one word at a time (first version:
// right and simple).
//
// Plain C interface for ctypes; see optimization_tpu_torch/kernels/segment_sum.py

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxGrid = 1LL << 20;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    segment_sum_kernel(const T* __restrict__ a0, const T* __restrict__ a1,
                       long long rows0, const long long* __restrict__ order,
                       const long long* __restrict__ starts, long long n,
                       long long width, T* __restrict__ out) {
  const long long total = n * width;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
       t < total; t += stride) {
    const long long v = t / width;
    const long long c = t - v * width;
    const long long end = starts[v + 1];
    T acc = T(0);
    for (long long j = starts[v]; j < end; ++j) {
      const long long s = order[j];
      const T* row = s < rows0 ? a0 + s * width : a1 + (s - rows0) * width;
      acc += row[c];
    }
    out[t] = acc;
  }
}

template <typename T>
int launch(const T* a0, const T* a1, long long rows0, const long long* order,
           const long long* starts, long long n, long long width, T* out,
           void* stream) {
  if (n < 0 || width < 1 || rows0 < 0) return (int)cudaErrorInvalidValue;
  const long long total = n * width;
  if (total == 0) return 0;
  long long grid = (total + kThreads - 1) / kThreads;
  if (grid > kMaxGrid) grid = kMaxGrid;
  segment_sum_kernel<T><<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      a0, a1, rows0, order, starts, n, width, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* segment_sum_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// out (n, width) = the segment sum of the plan (order over slots, starts
// (n + 1,) run bounds) over the rows of a0 (slots [0, rows0)) and a1 (slots
// from rows0 on; null when the plan has one part), on `stream`.  Returns a
// cudaError_t.
int segment_sum_f32(const float* a0, const float* a1, long long rows0,
                    const long long* order, const long long* starts,
                    long long n, long long width, float* out, void* stream) {
  return launch<float>(a0, a1, rows0, order, starts, n, width, out, stream);
}

int segment_sum_f64(const double* a0, const double* a1, long long rows0,
                    const long long* order, const long long* starts,
                    long long n, long long width, double* out, void* stream) {
  return launch<double>(a0, a1, rows0, order, starts, n, width, out, stream);
}

}  // extern "C"
