// The edge->vertex segment sum of the port's graph models for the H100
// (sm_90a): out[v] = the sum, over the run of slots that the plan sorted
// onto vertex v, of the contribution rows of those slots, every row of
// `width` words (f32 or f64).  The pullback of every gather by a graph
// index (kernels/segment_sum.py:planned_gather) is this sum too.
//
// It replaces no Pallas kernel.  The JAX package sums per-edge contributions
// onto vertices with `.at[idx].add` and `segment_sum`
// (optimization_tpu/models/graph.py:84-86, 135), which XLA lowers, and its
// results repeat from run to run.  PyTorch's index_add adds with atomics on
// the card, in an order that varies from run to run, and its deterministic
// index_put(accumulate=True), the pullback of x[idx], sorts the indices
// again at every call.  This kernel takes the order that the plan
// (kernels/segment_sum.py:segment_plan) sorted once: each thread owns one
// word (v, c) of the output and adds the words of v's run in the plan's
// order (the slots' order, stable), starting from zero.  No atomics: two
// runs are bitwise equal, and the order of the adds is that of index_add on
// the CPU, one part after the other in index order, so the plain version on
// the CPU gives the same bits.
//
// What bounds it: device-memory bytes (one add a word read): the
// contributions once, the plan's order and run bounds, the output once.
// The rows of a run lie where the edges put them, so each row is a gather;
// a 36-byte row (3 x 3 f32, the connection Laplacian's) spans two 32-byte
// sectors wherever it lies.  A run walked one slot at a time is two
// dependent loads a slot, one load in flight a thread: too little for the
// card's memory.  What the design does:
// - loads issued ahead, adds in order: a thread loads the slot ids of a
//   batch of kBatch slots of its run, then all their words (unconditional
//   loads, clamped to the run), then adds them in order; the next batch's
//   ids are loaded before this batch's adds, so a long run (a hub) keeps a
//   batch of ids and a batch of words in flight;
// - instances by width (1, 3, 9, 24, 72: the degree, a 3-vector, a 3 x 3
//   block, LOBPCG's 3 x 8 and 3 x 24 blocks; a generic one for the rest), so
//   the word index divides by a constant;
// - 32-bit ids and word indices where the plan has them (below 2^31 slots,
//   and n * width below 2^31), 64-bit otherwise;
// - neighbouring threads take neighbouring words of a row, so a vertex's
//   threads read its rows' words side by side and its ids by broadcast.
// A split sum (the pullback of a gather by an edge's two endpoints) adds
// each vertex's part-0 and part-1 slots into two sums, each in order from
// zero, and then the two: what autograd does with two gathers' pullbacks.
// A padded table's padding (planned_gather(..., padded=True)) sorts past the
// last vertex's run, so no thread reads it.
//
// Plain C interface for ctypes; see optimization_tpu_torch/kernels/segment_sum.py

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kBatch = 8;
constexpr long long kMaxGrid = 1LL << 20;

// The ids of the run's slots j, j + 1, ..., j + kBatch - 1, each past the
// run's end clamped to its last slot (left = end - j >= 1): every load is
// made, so none waits on a branch, and the surplus ones hit L1.
template <typename I>
__device__ __forceinline__ void load_ids(I (&s)[kBatch],
                                         const I* __restrict__ order, I j,
                                         I left) {
#pragma unroll
  for (int k = 0; k < kBatch; ++k)
    s[k] = __ldg(order + j + (I(k) < left ? I(k) : left - 1));
}

// I: the plan's id type (int32 or int64), also that of the word index;
// W: the row's width in words, 0 for the generic instance (width_rt);
// Split: part 1's slots summed apart from part 0's (own instances, so the
// plain sum keeps its registers).
template <typename T, typename I, int W, bool Split>
__global__ void __launch_bounds__(kThreads)
    segment_sum_kernel(const T* __restrict__ a0, const T* __restrict__ a1,
                       I rows0, const I* __restrict__ order,
                       const I* __restrict__ starts, I n, I width_rt,
                       T* __restrict__ out) {
  using U = std::make_unsigned_t<I>;
  const U width = W > 0 ? U(W) : U(width_rt);
  const U total = U(n) * width;
  const U stride = U(gridDim.x) * kThreads;
  for (U t = U(blockIdx.x) * kThreads + threadIdx.x; t < total; t += stride) {
    const U v = t / width;
    const U c = t - v * width;
    I j = __ldg(starts + v);
    const I end = __ldg(starts + v + 1);
    T acc = T(0);
    T acc1 = T(0);  // part 1's words when split (part 0's come first)
    if (j < end) {
      I s[kBatch];
      load_ids(s, order, j, I(end - j));
      for (;;) {
        const I left = end - j;
        T x[kBatch];
        bool second[kBatch];  // a part-1 slot of a split sum
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          const T* row = s[k] < rows0
                             ? a0 + (unsigned long long)s[k] * width
                             : a1 + (unsigned long long)(s[k] - rows0) * width;
          x[k] = __ldg(row + c);
          second[k] = Split && s[k] >= rows0;
        }
        // a long run's next ids in flight before this batch's adds
        const bool more = left > kBatch;
        if (more) load_ids(s, order, I(j + kBatch), I(left - kBatch));
        // in order from zero; past the run's end +0.0, which changes no
        // bit of a sum that starts at +0.0 (it is never -0.0)
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          if constexpr (Split) {
            acc += I(k) < left && !second[k] ? x[k] : T(0);
            acc1 += I(k) < left && second[k] ? x[k] : T(0);
          } else {
            acc += I(k) < left ? x[k] : T(0);
          }
        }
        if (!more) break;
        j += kBatch;
      }
    }
    out[t] = Split ? acc + acc1 : acc;
  }
}

template <typename T, typename I, int W>
void launch_width(const T* a0, const T* a1, long long rows0, bool split,
                  const void* order, const void* starts, long long n,
                  long long width, T* out, long long grid,
                  cudaStream_t stream) {
  if (split)
    segment_sum_kernel<T, I, W, true><<<(unsigned)grid, kThreads, 0, stream>>>(
        a0, a1, (I)rows0, (const I*)order, (const I*)starts, (I)n, (I)width,
        out);
  else
    segment_sum_kernel<T, I, W, false>
        <<<(unsigned)grid, kThreads, 0, stream>>>(
            a0, a1, (I)rows0, (const I*)order, (const I*)starts, (I)n,
            (I)width, out);
}

template <typename T, typename I>
void launch_ids(const T* a0, const T* a1, long long rows0, bool split,
                const void* order, const void* starts, long long n,
                long long width, T* out, long long grid,
                cudaStream_t stream) {
  switch (width) {
    case 1:
      return launch_width<T, I, 1>(a0, a1, rows0, split, order, starts, n,
                                   width, out, grid, stream);
    case 3:
      return launch_width<T, I, 3>(a0, a1, rows0, split, order, starts, n,
                                   width, out, grid, stream);
    case 9:
      return launch_width<T, I, 9>(a0, a1, rows0, split, order, starts, n,
                                   width, out, grid, stream);
    case 24:
      return launch_width<T, I, 24>(a0, a1, rows0, split, order, starts, n,
                                    width, out, grid, stream);
    case 72:
      return launch_width<T, I, 72>(a0, a1, rows0, split, order, starts, n,
                                    width, out, grid, stream);
    default:
      return launch_width<T, I, 0>(a0, a1, rows0, split, order, starts, n,
                                   width, out, grid, stream);
  }
}

template <typename T>
int launch(const T* a0, const T* a1, long long rows0, int split,
           const void* order, const void* starts, int wide, long long n,
           long long width, T* out, void* stream) {
  if (n < 0 || width < 1 || rows0 < 0) return (int)cudaErrorInvalidValue;
  const long long total = n * width;
  if (total == 0) return 0;
  // 32-bit ids index words in 32 bits: the wrapper widens the plan past that
  if (!wide && (total >= (1LL << 31) || rows0 >= (1LL << 31)))
    return (int)cudaErrorInvalidValue;
  long long grid = (total + kThreads - 1) / kThreads;
  if (grid > kMaxGrid) grid = kMaxGrid;
  if (wide)
    launch_ids<T, long long>(a0, a1, rows0, split != 0, order, starts, n,
                             width, out, grid, (cudaStream_t)stream);
  else
    launch_ids<T, int>(a0, a1, rows0, split != 0, order, starts, n, width,
                       out, grid, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* segment_sum_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// out (n, width) = the segment sum of the plan (order over slots, starts
// (n + 1,) run bounds; int32 ids, or int64 when `wide`) over the rows of a0
// (slots [0, rows0)) and a1 (slots from rows0 on; null when the plan has one
// part), on `stream`; with `split`, each vertex's part-0 and part-1 slots
// summed apart and the two sums added.  Returns a cudaError_t.
int segment_sum_f32(const float* a0, const float* a1, long long rows0,
                    int split, const void* order, const void* starts,
                    int wide, long long n, long long width, float* out,
                    void* stream) {
  return launch<float>(a0, a1, rows0, split, order, starts, wide, n, width,
                       out, stream);
}

int segment_sum_f64(const double* a0, const double* a1, long long rows0,
                    int split, const void* order, const void* starts,
                    int wide, long long n, long long width, double* out,
                    void* stream) {
  return launch<double>(a0, a1, rows0, split, order, starts, wide, n, width,
                        out, stream);
}

}  // extern "C"
