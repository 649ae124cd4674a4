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
//                           bandwidth ceiling of the others;
//   gram_pair_kernel     <- gram_pair (fused.py:185, kernel :164, call
//                           :209): (S'AS, S'BS) from (m, k) blocks on the
//                           tensor cores, the LOBPCG Gram stage (below).
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
// Blocks on Hopper run in any order, so the reductions take two passes
// (gram_pair's its own way, below): each thread accumulates f32 partials,
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
// gram_pair (replaces optimization_tpu/kernels/fused.py:185 gram_pair,
// kernel :164, call :209).  Per instance it is the product of S' (k x m)
// and [AS | BS] (m x 2k): a split-K skinny GEMM, the reduction over
// m = 10^4..10^5 rows, any k.
//
// What bounds it: bytes up to k ~ 150 in f32, operations above.  It reads
// 3 m k words, or 2 m k when BS is S (the LOBPCG call without B): at
// m = 10^5, k = 48, f32 that is 57.6 MB (17.2 us at 3.35 TB/s) or 38.4 MB
// (11.5 us), for 2 m k^2 = 0.46 G multiply-adds, 3 x that on the tensor
// cores with the 3xTF32 split below (2.8 GFLOP, ~6 us at the 495 TFLOP/s
// TF32 peak); the products grow as k^2, the bytes as k.
//
// The design:
// - tensor cores through mma.sync, fragments read from shared memory.  Not
//   wgmma: TF32 wgmma takes K-major operands only, and here K is S's row
//   index while S, AS, BS are row-major, so both operands are MN-major;
//   mma.sync fragments gather from any layout at no cost, and the product
//   is small beside the stream.  f32 storage runs m16n8k8 TF32 with the
//   3xTF32 split: x = hi + lo, hi = tf32(x), lo = tf32(x - hi), and each
//   product is lo*hi + hi*lo + hi*hi in the f32 accumulators.  bf16 storage
//   runs m16n8k16 bf16 products (fragments by ldmatrix.trans);
// - row tiles of S, AS (and BS) staged in a ring of kStages shared-memory
//   stages by cp.async 16-byte copies, the next tiles' loads in flight
//   while this tile's products run; a k whose rows are not 16-byte aligned
//   (or a misaligned base) takes scalar copies into the same ring.  Rows
//   past the block's range load as zeros, so padding adds nothing;
// - when BS is S the wrapper says so, S is staged once, and its tile is
//   both the left operand and the second right operand (2 m k words);
// - split-K over the card: one fleet instance per blockIdx.y, one wave of
//   blocks (from the occupancy query: one 256-thread block an SM at
//   k = 48), block x taking row tiles x, x + grid, ...; the warps split
//   each tile's k-steps into WK groups and the output into WO panels; the
//   groups add their accumulators in shared memory in group order, each
//   block writes its partial Grams, and a finishing kernel, launched as a
//   programmatic dependent launch so its blocks are resident before the
//   partials are done, adds the blocks' partials of each entry in block
//   order in double and rounds once to f32.  No float atomics: runs
//   repeat bitwise;
// - k <= kGramMaxK = 96: one block holds both whole Grams (KT = ceil(k/16)
//   output tiles a side, instances KT = 1..6).  Above that neither the
//   (2, 16 KT, 16 KT) f32 reduction buffer nor a warp's accumulators fit,
//   so the output is cut into npan x npan panels of KP = 16 KT columns
//   (KT = 4..6, the fewest panels of at most 96 columns): the block
//   (x npan^2 + q, f) computes panel q = (pi, pj) of both Grams, rows
//   pi KP .., columns pj KP .., from S's columns pi KP .. and AS's and BS's
//   columns pj KP .. of row tiles x, x + grid, ... .  The npan^2 blocks of
//   one x stream the same rows in the same order, all in one wave, so that
//   a row tile should come from device memory once and from L2 to the
//   other panels, keeping the bytes at 3 m k (2 m k when BS is S; an
//   off-diagonal panel then stages S's columns pj KP .. as its third
//   array).  That is the design's intent, not a measured fact: no profiler
//   has counted the device-memory bytes (profile_gram_pair.py's
//   ``stagger`` variants time the same loads with the panels' streams
//   apart).  Panels write disjoint entries of the block's partial Grams,
//   so the finishing kernel and the summation order are those of k <= 96;
// - the tensor cores' f32 accumulation drifts one way along a chain of
//   products (GramStep), so a warp whose chain would pass kSplitSteps
//   k-steps (a long row stream at k <= 96) and every panel launch add each
//   k-step's products into their f32 sums by rounded adds.
//
// Accuracy: the JAX contract is f32 products and f32 sums (gram_pair casts
// to f32; the LOBPCG Gram GEMMs run at HIGHEST precision, lobpcg.py:46-50).
// tf32 keeps 11 significant bits, so |x - hi| <= 2^-11 |x| and lo carries
// x - hi to 2^-22 |x|; the three kept products miss lo*lo and the lo
// roundings, under 3 2^-22 |x y| together, and each adds into f32: the
// per-entry error stays far inside 1e-5 sum_r |S[r,i] X[r,j]|, the
// tolerance chip_smoke.py holds it to.  Plain 1xTF32 (2^-11) would not.  A
// bf16 x bf16 product is exact in f32.  k has no cap.
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

// ---- gram_pair ----

constexpr int kGramMaxK = 96;
constexpr int kStepsPerTile = 8;      // mma k-steps in one staged row tile
// The longest chain of k-steps a warp runs into one accumulator (SPLIT
// above it): config10's fleet, 16 x 10,000 x 48 in f32, runs 40.
constexpr int kSplitSteps = 40;
// The cp.async ring: as many stages (2 .. kMaxStages) as kRingBytes holds
// with three staged arrays: a block keeps 65-155 KB of loads in flight.
constexpr size_t kRingBytes = 200 * 1024;
constexpr int kMaxStages = 8;
constexpr int kFinishSlices = 8;

// Per storage type: the mma k-step (rows per product) and the rows of a
// staged tile (kStepsPerTile k-steps: 256 bytes of every column).
template <typename T> struct GramTile;
template <> struct GramTile<float> {
  static constexpr int kStep = 8;       // m16n8k8 TF32
  static constexpr int kRows = kStepsPerTile * kStep;
};
template <> struct GramTile<__nv_bfloat16> {
  static constexpr int kStep = 16;      // m16n8k16 bf16
  static constexpr int kRows = kStepsPerTile * kStep;
};

// The warp tiling for k <= 16 KT: each Gram is KT x 2KT output tiles of
// 16 x 8; a warp owns MW x NW of them (MW * NW * 4 f32 accumulators a
// thread).  WO = 2 (KT / MW) (2KT / NW) warps cover both Grams and the
// block's kWarps / WO groups of WO warps split each tile's k-steps.
template <int KT> struct GramWarps;
template <> struct GramWarps<1> { static constexpr int MW = 1, NW = 2; };
template <> struct GramWarps<2> { static constexpr int MW = 2, NW = 4; };
template <> struct GramWarps<3> { static constexpr int MW = 3, NW = 6; };
template <> struct GramWarps<4> { static constexpr int MW = 4, NW = 4; };
template <> struct GramWarps<5> { static constexpr int MW = 5, NW = 5; };
template <> struct GramWarps<6> { static constexpr int MW = 3, NW = 6; };

// The warp groups that split each tile's k-steps.
template <int KT>
__host__ __device__ constexpr int gram_wk() {
  return kWarps / (2 * (KT / GramWarps<KT>::MW) * (2 * KT / GramWarps<KT>::NW));
}

// Shared-memory row stride of a staged tile: KP + 8 elements, so the
// fragment reads of a warp (and ldmatrix's eight 16-byte rows) fall in
// distinct banks.
template <int KT>
__host__ __device__ constexpr int gram_ld() {
  return 16 * KT + 8;
}

template <typename T, int KT>
__host__ __device__ constexpr size_t gram_tile_bytes() {
  return (size_t)GramTile<T>::kRows * gram_ld<KT>() * sizeof(T);
}

template <typename T, int KT>
__host__ __device__ constexpr int gram_stages() {
  return kRingBytes / (3 * gram_tile_bytes<T, KT>()) < 2 ? 2
         : kRingBytes / (3 * gram_tile_bytes<T, KT>()) > kMaxStages
             ? kMaxStages
             : (int)(kRingBytes / (3 * gram_tile_bytes<T, KT>()));
}

// Dynamic shared memory of a launch: the ring (2 arrays a stage when BS is
// S, else 3), at least the block's f32 reduction buffer [2][KP][KP].
template <typename T, int KT>
size_t gram_smem_bytes(int same) {
  const size_t ring = (size_t)gram_stages<T, KT>() * (same ? 2 : 3) *
                      gram_tile_bytes<T, KT>();
  const size_t red = 2 * (size_t)(16 * KT) * (16 * KT) * sizeof(float);
  return ring > red ? ring : red;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zeros when !valid (no read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);    // exact
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One k-step (rows rk .. rk + kStep of the staged tile) of a warp's MW x NW
// output tiles: acc[a][b] += S[rows, 16 (m0 + a) ..]' X[rows, 8 (n0 + b) ..].
// The mma A operand is S' (A[i][r] = S[r][i]), B is X (B[r][j] = X[r][j]);
// both tiles are row-major [r][column] with row stride LD.  SPLIT: the
// k-step's products go into a zeroed fragment first, then into acc by f32
// adds (round to nearest): the tensor cores' own f32 accumulation drifts
// one way over a long chain (on the card: the diagonal of S'S at
// m = 100,000 off by 1.6e-5 of sum|S||S| where a block ran 3,000 rows, a
// warp 192 or more k-steps, into one accumulator; config10's fleet, 40
// k-steps of three mma, reads 0.32 of the 1e-5 sum|S||X| tolerance against
// an f64 product), so every chain longer than kSplitSteps k-steps is cut
// to one.
template <typename T, int LD, int MW, int NW, bool SPLIT>
struct GramStep;

template <int LD, int MW, int NW, bool SPLIT>
struct GramStep<float, LD, MW, NW, SPLIT> {
  __device__ static void run(float (&acc)[MW][NW][4], const float* sS,
                             const float* sX, int rk, int m0, int n0) {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const float* s0 = sS + (rk + t) * LD;
    const float* s4 = sS + (rk + t + 4) * LD;
    uint32_t bh[NW][2], bl[NW][2];
#pragma unroll
    for (int b = 0; b < NW; ++b) {
      const int j = 8 * (n0 + b) + g;
      split_tf32(sX[(rk + t) * LD + j], bh[b][0], bl[b][0]);
      split_tf32(sX[(rk + t + 4) * LD + j], bh[b][1], bl[b][1]);
    }
#pragma unroll
    for (int a = 0; a < MW; ++a) {
      const int i = 16 * (m0 + a) + g;
      uint32_t ah[4], al[4];
      split_tf32(s0[i], ah[0], al[0]);
      split_tf32(s0[i + 8], ah[1], al[1]);
      split_tf32(s4[i], ah[2], al[2]);
      split_tf32(s4[i + 8], ah[3], al[3]);
#pragma unroll
      for (int b = 0; b < NW; ++b) {
        // the small terms first, then hi * hi
        if (SPLIT) {
          float d[4] = {0.f, 0.f, 0.f, 0.f};
          mma_tf32(d, al, bh[b]);
          mma_tf32(d, ah, bl[b]);
          mma_tf32(d, ah, bh[b]);
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[a][b][c] += d[c];
        } else {
          mma_tf32(acc[a][b], al, bh[b]);
          mma_tf32(acc[a][b], ah, bl[b]);
          mma_tf32(acc[a][b], ah, bh[b]);
        }
      }
    }
  }
};

template <int LD, int MW, int NW, bool SPLIT>
struct GramStep<__nv_bfloat16, LD, MW, NW, SPLIT> {
  __device__ static void run(float (&acc)[MW][NW][4], const __nv_bfloat16* sS,
                             const __nv_bfloat16* sX, int rk, int m0,
                             int n0) {
    const int lane = threadIdx.x & 31;
    const int p = lane & 7;
    // ldmatrix.trans of the 8 x 8 blocks [r][column] gives each thread the
    // (r, r + 1) pairs of one column: the k-pairs of the A and B fragments
    uint32_t bf[NW][2];
#pragma unroll
    for (int b = 0; b < NW; ++b) {
      const __nv_bfloat16* q =
          sX + (rk + p + (((lane >> 3) & 1) << 3)) * LD + 8 * (n0 + b);
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
          : "=r"(bf[b][0]), "=r"(bf[b][1])
          : "r"(smem_addr(q))
          : "memory");
    }
#pragma unroll
    for (int a = 0; a < MW; ++a) {
      const __nv_bfloat16* q = sS + (rk + p + ((lane >> 4) << 3)) * LD +
                               16 * (m0 + a) + (((lane >> 3) & 1) << 3);
      uint32_t af[4];
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
          "[%4];\n"
          : "=r"(af[0]), "=r"(af[1]), "=r"(af[2]), "=r"(af[3])
          : "r"(smem_addr(q))
          : "memory");
#pragma unroll
      for (int b = 0; b < NW; ++b) {
        if (SPLIT) {
          float d[4] = {0.f, 0.f, 0.f, 0.f};
          mma_bf16(d, af, bf[b]);
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[a][b][c] += d[c];
        } else {
          mma_bf16(acc[a][b], af, bf[b]);
        }
      }
    }
  }
};

// Per-thread staging plan of the 16-byte path: the chunks this thread
// copies from a tile of `cols` columns (chunk e is row e / (cols / W),
// columns from (e mod (cols / W)) W on), each chunk's row and
// shared-memory offset, worked out once per block.  With cols = k the
// tile's rows are one contiguous run, and chunk e starts at element e W.
template <typename T, int KT>
struct GramPlan {
  static constexpr int W = 16 / sizeof(T);
  static constexpr int kIters =
      (GramTile<T>::kRows * kGramMaxK / W + kThreads - 1) / kThreads;
  int row[kIters];
  int soff[kIters];
  __device__ GramPlan(int cols) {
    const int cpr = cols / W > 0 ? cols / W : 1;   // chunks per row
    const int n = GramTile<T>::kRows * cpr;
#pragma unroll
    for (int c = 0; c < kIters; ++c) {
      const int e = threadIdx.x + c * kThreads;
      const int r = e / cpr;
      row[c] = e < n ? r : GramTile<T>::kRows;   // past the tile: no copy
      soff[c] = r * gram_ld<KT>() + (e - r * cpr) * W;
    }
  }
};

// Copy one row tile (rows r0 .. r0 + kRows, zeros past `rows` valid ones)
// of each staged array into stage `dst`, then commit the cp.async group.
// The arrays' rows are k elements apart.  PANEL: each array's tile is
// KP = 16 KT columns from its own src pointer, of which the first cols[a]
// are read and the rest load as zeros (the plan covers KP columns);
// otherwise it is the rows' first k columns (the plan covers k).
template <typename T, int KT, bool PANEL>
__device__ void gram_stage(T* dst, const T* const (&src)[3],
                           const int (&cols)[3], int narr, size_t base,
                           int rows, int k, bool vec,
                           const GramPlan<T, KT>& plan) {
  constexpr int LD = gram_ld<KT>();
  constexpr int KP = 16 * KT;
  constexpr int ROWS = GramTile<T>::kRows;
  constexpr size_t TILE = (size_t)ROWS * LD;
  for (int a = 0; a < narr; ++a) {
    const T* g = src[a] + base;
    T* s = dst + a * TILE;
    if (vec) {
#pragma unroll
      for (int c = 0; c < GramPlan<T, KT>::kIters; ++c) {
        if (plan.row[c] < ROWS) {
          if (PANEL) {
            const int r = plan.row[c];
            const int col = plan.soff[c] - r * LD;
            const bool valid = r < rows && col < cols[a];
            cp_async16(s + plan.soff[c],
                       valid ? g + (size_t)r * k + col : g, valid);
          } else {
            const bool valid = plan.row[c] < rows;
            const size_t e = (size_t)(threadIdx.x + c * kThreads) *
                             GramPlan<T, KT>::W;
            cp_async16(s + plan.soff[c], valid ? g + e : g, valid);
          }
        }
      }
    } else {
      // rows not 16-byte aligned: scalar copies, one warp a row
      const int lane = threadIdx.x & 31;
      const int width = PANEL ? KP : k;
      for (int r = threadIdx.x >> 5; r < ROWS; r += kWarps)
        for (int c = lane; c < width; c += 32)
          s[r * LD + c] = r < rows && c < cols[a] ? g[(size_t)r * k + c]
                                                  : T{};
    }
  }
  cp_async_commit();
}

// S, AS, BS: (F, m, k) row-major.  Without PANEL (k <= kGramMaxK), block
// (x, f) takes the row tiles x, x + gridDim.x, x + 2 gridDim.x, ... of
// instance f (so the blocks stream neighbouring tiles at any moment) and
// writes its partial Grams to part[f][x][2][k][k] (S'AS first, then S'BS).
// PANEL: gridDim.x = grid npan^2 and block (x npan^2 + q, f) does the same
// for panel q of the output (file comment), writing its entries of
// part[f][x].  same: BS is S (not read).  vec: k elements are a multiple of
// 16 bytes and the three bases 16-byte aligned (cp.async); otherwise
// scalar copies.  SPLIT: GramStep's.
template <typename T, int KT, bool PANEL, bool SPLIT>
__global__ void __launch_bounds__(kThreads, 1)
    gram_pair_kernel(const T* S, const T* AS, const T* BS, long long m, int k,
                     int same, int vec, float* part) {
  using Cfg = GramWarps<KT>;
  constexpr int MW = Cfg::MW, NW = Cfg::NW;
  constexpr int KP = 16 * KT;
  constexpr int LD = gram_ld<KT>();
  constexpr int ROWS = GramTile<T>::kRows;
  constexpr int STEP = GramTile<T>::kStep;
  constexpr int PM = KT / MW, PN = 2 * KT / NW;   // panels of one Gram
  constexpr int WO = 2 * PM * PN;
  constexpr int WK = gram_wk<KT>();
  static_assert(KT % MW == 0 && (2 * KT) % NW == 0 && WO * WK == kWarps,
                "warp tiling");
  static_assert(ROWS == kStepsPerTile * STEP, "tile rows");
  constexpr size_t TILE = (size_t)ROWS * LD;
  constexpr int kStages = gram_stages<T, KT>();

  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);

  // this block's row stream (bx of gx) and output panel (rows i0 .., ki of
  // them; columns j0 .., kj of them)
  const int npan = PANEL ? (k + KP - 1) / KP : 1;
  const int bx = PANEL ? (int)blockIdx.x / (npan * npan) : (int)blockIdx.x;
  const int gx = PANEL ? (int)gridDim.x / (npan * npan) : (int)gridDim.x;
  const int q = PANEL ? (int)blockIdx.x % (npan * npan) : 0;
  const int i0 = PANEL ? (q / npan) * KP : 0;
  const int j0 = PANEL ? (q % npan) * KP : 0;
  const int ki = PANEL ? min(KP, k - i0) : k;
  const int kj = PANEL ? min(KP, k - j0) : k;
  // BS is S and the panel is on the diagonal: S's tile is BS's too
  const int narr = same && i0 == j0 ? 2 : 3;

  const size_t inst = (size_t)blockIdx.y * (size_t)m * (size_t)k;
  const T* const src[3] = {S + inst + i0, AS + inst + j0, BS + inst + j0};
  const int cols[3] = {ki, kj, kj};
  const long long all_tiles = (m + ROWS - 1) / ROWS;
  const int ntiles = (int)((all_tiles - bx + gx - 1) / gx);

  // Columns past the panel (PANEL) or k .. LD of the ring hold zeros or
  // whatever was there: that reaches only output rows or columns past the
  // panel (an mma entry (i, j) reads row i of A and column j of B alone),
  // which are never written out.

  const GramPlan<T, KT> plan(PANEL ? KP : k);
  auto stage = [&](int tile) {
    const long long r0 = ((long long)tile * gx + bx) * ROWS;
    const long long left = m - r0;
    gram_stage<T, KT, PANEL>(ring + (tile % kStages) * narr * TILE, src,
                             cols, narr, (size_t)r0 * (size_t)k,
                             left < ROWS ? (int)left : ROWS, k, vec != 0,
                             plan);
  };

  const int warp = threadIdx.x >> 5;
  const int wo = warp % WO, wk = warp / WO;
  const int gram = wo / (PM * PN);
  const int m0 = ((wo / PN) % PM) * MW, n0 = (wo % PN) * NW;

  float acc[MW][NW][4];
#pragma unroll
  for (int a = 0; a < MW; ++a)
#pragma unroll
    for (int b = 0; b < NW; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = 0.f;

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < ntiles) stage(t);
    else cp_async_commit();          // keep one group per tile slot
  }
  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<kStages - 2>();    // this thread's copies of tile it
    __syncthreads();                 // everyone's; and tile it - 1 is done
    if (it + kStages - 1 < ntiles) stage(it + kStages - 1);
    else cp_async_commit();
    const T* sS = ring + (it % kStages) * narr * TILE;
    const T* sX = gram == 0 ? sS + TILE : (narr == 2 ? sS : sS + 2 * TILE);
#pragma unroll
    for (int st = wk; st < kStepsPerTile; st += WK)
      GramStep<T, LD, MW, NW, SPLIT>::run(acc, sS, sX, st * STEP, m0, n0);
  }
  cp_async_wait<0>();
  // the finishing kernel may start launching (it waits for this grid)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  __syncthreads();

  // the k-step groups add their accumulators in group order (f32), then
  // the block writes its partial Grams (its panel of them)
  float* red = reinterpret_cast<float*>(smem);
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  for (int grp = 0; grp < WK; ++grp) {
    if (wk == grp) {
#pragma unroll
      for (int a = 0; a < MW; ++a)
#pragma unroll
        for (int b = 0; b < NW; ++b)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int i = 16 * (m0 + a) + g + ((c >> 1) << 3);
            const int j = 8 * (n0 + b) + 2 * t + (c & 1);
            float& r = red[(gram * KP + i) * KP + j];
            r = grp == 0 ? acc[a][b][c] : r + acc[a][b][c];
          }
    }
    __syncthreads();
  }
  const size_t kk = (size_t)k * (size_t)k;
  float* out = part + ((size_t)blockIdx.y * gx + bx) * 2 * kk;
  for (int gi = warp; gi < 2 * ki; gi += kWarps) {
    const int o = gi >= ki;
    const int i = gi - o * ki;
    for (int j = lane; j < kj; j += 32)
      out[o * kk + (size_t)(i0 + i) * k + j0 + j] =
          red[(o * KP + i) * KP + j];
  }
}

// out[f][e] = sum over blocks x of part[f][x][e], e < nent = 2 k^2: slice y
// of a (32, kFinishSlices) block adds x = y, y + 8, ... in order in double,
// then slice 0 adds the slices in order and rounds to f32.
__global__ void __launch_bounds__(32 * kFinishSlices)
    gram_finish_kernel(const float* part, int nblk, int nent, float* out) {
  __shared__ double red[kFinishSlices][32];
  // launched early (programmatic dependent launch): wait for the partials
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int e = blockIdx.x * 32 + threadIdx.x;
  double v = 0.0;
  if (e < nent) {
    const float* p = part + (size_t)blockIdx.y * nblk * nent + e;
#pragma unroll 4
    for (int x = threadIdx.y; x < nblk; x += kFinishSlices)
      v += (double)p[(size_t)x * nent];
  }
  red[threadIdx.y][threadIdx.x] = v;
  __syncthreads();
  if (threadIdx.y == 0 && e < nent) {
    double s = 0.0;
#pragma unroll
    for (int y = 0; y < kFinishSlices; ++y) s += red[y][threadIdx.x];
    out[(size_t)blockIdx.y * nent + e] = (float)s;
  }
}

template <typename T>
using GramKernel = void (*)(const T*, const T*, const T*, long long, int,
                            int, int, float*);

// The panel side of a k > kGramMaxK launch: the fewest panels of at most
// kGramMaxK columns, ceil(k / P) columns each rounded up to whole 16-column
// tiles: KT = 4..6 (ceil(k / P) > 48 for P >= 2).
inline int gram_panel_kt(int k) {
  const int p = (k + kGramMaxK - 1) / kGramMaxK;
  return ((k + p - 1) / p + 15) / 16;
}

// The kernel instance for k columns and the panels a side (npan; 1 for
// k <= kGramMaxK, whose instance is KT = ceil(k / 16), split or not).
template <typename T>
GramKernel<T> gram_instance(int k, bool split, int* npan) {
  if (k > kGramMaxK) {
    static const GramKernel<T> panels[3] = {
        gram_pair_kernel<T, 4, true, true>, gram_pair_kernel<T, 5, true, true>,
        gram_pair_kernel<T, 6, true, true>};
    const int kt = gram_panel_kt(k);
    *npan = (k + 16 * kt - 1) / (16 * kt);
    return panels[kt - 4];
  }
  static const GramKernel<T> kernels[2][kGramMaxK / 16] = {
      {gram_pair_kernel<T, 1, false, false>,
       gram_pair_kernel<T, 2, false, false>,
       gram_pair_kernel<T, 3, false, false>,
       gram_pair_kernel<T, 4, false, false>,
       gram_pair_kernel<T, 5, false, false>,
       gram_pair_kernel<T, 6, false, false>},
      {gram_pair_kernel<T, 1, false, true>,
       gram_pair_kernel<T, 2, false, true>,
       gram_pair_kernel<T, 3, false, true>,
       gram_pair_kernel<T, 4, false, true>,
       gram_pair_kernel<T, 5, false, true>,
       gram_pair_kernel<T, 6, false, true>}};
  *npan = 1;
  return kernels[split][(k + 15) / 16 - 1];
}

// Whether a k <= kGramMaxK launch of `grid` row streams splits: a warp runs
// ceil(tiles / grid) tiles of ceil(kStepsPerTile / WK) k-steps each into
// one accumulator.
template <typename T>
bool gram_split(long long m, int k, int grid) {
  static const int wk[kGramMaxK / 16] = {gram_wk<1>(), gram_wk<2>(),
                                         gram_wk<3>(), gram_wk<4>(),
                                         gram_wk<5>(), gram_wk<6>()};
  const int w = wk[(k + 15) / 16 - 1];
  const long long tiles = (m + GramTile<T>::kRows - 1) / GramTile<T>::kRows;
  const long long chain =
      (tiles + grid - 1) / grid * ((kStepsPerTile + w - 1) / w);
  return chain > kSplitSteps;
}

// The dynamic shared memory of a launch.  A panel launch sizes its ring
// for three arrays: off-diagonal panels stage S's columns apart from BS's
// even when BS is S.
template <typename T>
size_t gram_smem_for(int k, int same) {
  using Bytes = size_t (*)(int);
  static const Bytes bytes[kGramMaxK / 16] = {
      gram_smem_bytes<T, 1>, gram_smem_bytes<T, 2>, gram_smem_bytes<T, 3>,
      gram_smem_bytes<T, 4>, gram_smem_bytes<T, 5>, gram_smem_bytes<T, 6>};
  if (k > kGramMaxK) return bytes[gram_panel_kt(k) - 1](0);
  return bytes[(k + 15) / 16 - 1](same);
}

// Row streams per instance (the blocks of one panel): one wave over the
// fleet's npan^2 panels, each stream at least one tile of rows.
template <typename T>
cudaError_t gram_geometry(int fleet, long long m, int k, int same,
                          int* grid) {
  int npan = 1;
  const GramKernel<T> kernel = gram_instance<T>(k, false, &npan);
  const size_t smem = gram_smem_for<T>(k, same);
  const size_t most = gram_smem_for<T>(k, 0);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  // above 48 KB only after this opt-in; the largest ring of this instance
  // (both of k's instances: the launch picks one)
  for (int split = 0; split < 2; ++split) {
    e = cudaFuncSetAttribute(gram_instance<T>(k, split != 0, &npan),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)most);
    if (e != cudaSuccess) return e;
  }
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                    smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) per_sm = 1;
  // one wave over the whole fleet (never more blocks than fit at once),
  // each block at least one tile of rows
  const long long tiles = (m + GramTile<T>::kRows - 1) / GramTile<T>::kRows;
  long long want = (long long)sms * per_sm / ((long long)fleet * npan * npan);
  if (want > tiles) want = tiles;
  *grid = want < 1 ? 1 : (int)want;
  return cudaSuccess;
}

template <typename T>
int gram_pair_launch(const void* s, const void* as, const void* bs, int fleet,
                     long long m, int k, int same, int grid, float* part,
                     float* out, cudaStream_t st) {
  int npan = 1;
  const GramKernel<T> kernel =
      gram_instance<T>(k, k <= kGramMaxK && gram_split<T>(m, k, grid), &npan);
  const bool aligned = ((uintptr_t)s | (uintptr_t)as | (uintptr_t)bs) % 16 == 0;
  const int vec = aligned && (k * (int)sizeof(T)) % 16 == 0;
  kernel<<<dim3(grid * npan * npan, fleet), kThreads,
           gram_smem_for<T>(k, same), st>>>(
      static_cast<const T*>(s), static_cast<const T*>(as),
      static_cast<const T*>(bs), m, k, same, vec, part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int nent = 2 * k * k;
  // a programmatic dependent launch: its blocks are scheduled while the
  // partials' grid drains, and wait for it to complete
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((nent + 31) / 32, fleet);
  cfg.blockDim = dim3(32, kFinishSlices);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, gram_finish_kernel,
                                 static_cast<const float*>(part), grid, nent,
                                 out);
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

// Row streams per instance of a gram_pair launch over a fleet of (m, k)
// blocks, k >= 1, m >= 1, same = 1 when BS will be S (the blocks' partial
// Grams of each entry; a launch at k > 96 runs that many blocks for each
// output panel); the caller sizes the partials as fleet * grid * 2 k^2
// floats.  Also opts the kernel instance in to its dynamic shared memory:
// call it once per shape before the first launch.
int fused_gram_geometry(int bf16, int fleet, long long m, int k, int same,
                        int* grid) {
  return bf16 ? (int)gram_geometry<__nv_bfloat16>(fleet, m, k, same, grid)
              : (int)gram_geometry<float>(fleet, m, k, same, grid);
}

// out[f][0] = S_f' AS_f and out[f][1] = S_f' BS_f, (k, k) f32 each, for the
// fleet's (m, k) row-major blocks (S, AS, BS of one dtype).  same = 1: BS
// is S (S is read once and bs is not read).
int fused_gram_pair(int bf16, const void* s, const void* as, const void* bs,
                    int fleet, long long m, int k, int same, int grid,
                    float* part, float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? gram_pair_launch<__nv_bfloat16>(s, as, bs, fleet, m, k, same,
                                                grid, part, out, st)
              : gram_pair_launch<float>(s, as, bs, fleet, m, k, same, grid,
                                        part, out, st);
}

}  // extern "C"
