// The probe kernels for the H100 (sm_90a).  The two CG-body residency
// probes: what does it buy to keep a loop-invariant vector, or the loop's
// own state, on chip across the iterations of a streamed CG-like loop?  And
// the graph probe's chunk reader: what rate does the card deliver when a
// kernel gathers chunks of a vector at random offsets?
//
// pinned_stream replaces benchmarks/probe_pallas_stream.py:mk_pallas (the
// Pallas TPU kernel that pins x in VMEM and streams r, p (and s) in place):
// K iterations of
//
//   a = 1e-12 acc;  pn = -r + a p;  rn = r + a (d .* pn) + a^2 x;
//   [sn = s + a pn;]  acc = sum rn^2 + sum x .* rn,   d(i) = 1 + b i,
//
// f32, acc starting at 1, the diagonal regenerated from the index.
//
// resident_body replaces benchmarks/probe_resident_kernel.py:mk_pallas (x, r
// and p pinned in VMEM, no traffic in the loop): K iterations of the streamed
// CG kernel's chunk body (a0 = 2a - rq regenerated, u1 = 2a x, the p and r
// updates, six dots) coupled through coefs_from(dots), bf16 or f32 storage,
// f32 arithmetic, r and p rounded to storage at the end of every iteration.
//
// What bounds them: device-memory bytes (a few tens of flops an element).
// The TPU kernels hold whole 64 MiB vectors in VMEM.  This card has no such
// memory: a block can use at most 227 KB of shared memory, 132 SMs hold
// about 30 MB together, and a part of the 50 MB L2 can be set aside for
// persisting lines.  So the design keeps what fits and streams the rest:
//
// - one persistent cooperative launch for all K iterations (pinned_stream:
//   kBlocksPerSM blocks of kThreads threads on every SM; resident_body:
//   one block of kBodyThreads);
// - the vector's 16-byte groups are split into contiguous regions (held /
//   streamed); every block owns a fixed slice of each held region for the
//   whole loop (pinned_stream walks its streamed region grid-wide), so a
//   thread meets the same elements in every iteration and what it keeps in
//   shared memory never has to be exchanged;
// - pinned_stream copies its slice of x's held region into shared memory
//   once, and may put an L2 access-policy window (persisting hits, streaming
//   misses) over the rest of x;
// - resident_body keeps its slices of r and p (then x, if room is left) in
//   shared memory in the storage type, rounding as a store would, and writes
//   r back once.  At n = 2^24 that is 0.45 of r and p, and each iteration
//   streams the rest of r and p (2.2 n words) and reads all of x (n words,
//   33.5 MB in bf16, which fits the 50 MB L2 only if the streamed lines do
//   not push it out).  A thread walks its held and its streamed items in
//   one loop, one of each a trip, with the next trip's loads in flight
//   while this one computes and the next iteration's first loads issued
//   before the grid-wide sum, so that device memory is not idle while the
//   held items compute or while the grid waits at its barrier; and odd
//   iterations walk the trips backwards, so that each iteration starts on
//   the lines of x (and of the streamed r and p) that the last one touched
//   last, which L2 still holds.  Per-access L2 eviction priority (x
//   evict_last, the streamed r and p evict_first) and the persisting L2
//   carve-out were measured and left out: neither kept x in L2, and the
//   evict_first lines cost the streamed r and p that reuse
//   (profile_resident_body.py, PERF.md);
// - the per-thread f32 partial sums are reduced per block and then over the
//   grid in double in a fixed order after one grid.sync() per iteration, and
//   every thread advances the scalar recurrence redundantly: no atomics, no
//   scalar ever goes to the host, two runs are bitwise equal;
// - the held and the not-held arm of a kernel use ONE geometry (grid,
//   regions, thread-to-element map, order of the items) and differ only in
//   where an operand is read from, so their results are bitwise equal too.
//
// chunk_reader replaces benchmarks/probe_graph_stream.py:mk_chunk_reader (the
// Pallas TPU kernel that DMAs n_fetch chunks of gr x 128 f32 words from device
// memory at contiguous or LCG-random chunk offsets and sums them): the gather
// primitive any chunked graph-operator kernel would be built from.  It is
// bound by device-memory bytes (one add a word) and, at small chunks, by how
// many independent requests are in flight.  The TPU kernel double-buffers
// whole-chunk DMAs; here the fetch stream is cut into 512-byte rows, the
// grid's warps (eight blocks on every SM) take consecutive rows, compute
// each chunk offset themselves and read a row with one 16-byte non-coherent
// load a lane, four rows in flight a warp: thousands of independent requests
// at every granularity.  Each lane sums in f32 in a fixed order, each warp
// writes one partial, and a second kernel adds the partials in double in a
// fixed order: two runs are bitwise equal.  (cp.async.bulk / TMA with an
// mbarrier, the direct counterpart of the TPU's async copies, is later
// work.)
//
// Plain C interface for ctypes; see optimization_tpu_torch/kernels/probes.py
// for the wrappers and the plain PyTorch versions.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "storage.cuh"

namespace cg = cooperative_groups;

namespace {

// Two blocks of 512 threads on every SM, each with half the SM's shared
// memory.  Of the geometries tried on the H100 (1024 x 1, 512 x 2, 256 x 4,
// 256 x 6 blocks; one, two or four groups in flight a thread; the streamed
// region walked block by block or grid-wide) this one streamed fastest.
constexpr int kThreads = 512;
constexpr int kBlocksPerSM = 2;
constexpr int kWarps = kThreads / 32;
// groups a thread has in flight per trip of pinned_stream's sweep (their
// loads all start before the first of them is used)
constexpr int kUnroll = 2;
constexpr int kMaxAcc = 6;               // resident_body's dot group
constexpr int kSlot = 16;                // bytes of one group in shared memory
constexpr long long kNoBound = 1LL << 62;

// The groups [begin, begin + len) of a region that this block owns.
struct Slice {
  long long begin;
  long long len;
};

__host__ __device__ inline long long ceil_div(long long a, long long b) {
  return (a + b - 1) / b;
}

__device__ __forceinline__ Slice block_slice(long long g0, long long g1) {
  const long long per = ceil_div(g1 - g0, (long long)gridDim.x);
  long long b = g0 + (long long)blockIdx.x * per;
  long long e = b + per;
  if (b > g1) b = g1;
  if (e > g1) e = g1;
  return Slice{b, e - b};
}

// Block + grid reduction of NACC per-thread partials over blocks of NT
// threads: this block's sums go to partial[par], one grid.sync(), then
// every block adds all the blocks' sums in one fixed order, so `out` is
// bitwise the same in every thread.
template <int NT, int NACC>
__device__ void grid_sum(cg::grid_group& grid, double* partial, int par,
                         double (*red)[kMaxAcc], double* tot,
                         const float (&acc)[NACC], float (&out)[NACC]) {
  constexpr int NW = NT / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int a = 0; a < NACC; ++a) {
    double v = acc[a];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp][a] = v;
  }
  __syncthreads();
  double* part = partial + (size_t)par * gridDim.x * kMaxAcc;
  if (threadIdx.x < NACC) {
    double v = 0.0;
    for (int w = 0; w < NW; ++w) v += red[w][threadIdx.x];
    part[(size_t)blockIdx.x * kMaxAcc + threadIdx.x] = v;
  }
  grid.sync();
  for (int a = warp; a < NACC; a += NW) {
    // lane l adds the partials of blocks l, l + 32, ... in that order; the
    // loads of eight of them are issued before the first add
    double v = 0.0;
    for (unsigned b0 = lane; b0 < gridDim.x; b0 += 32 * 8) {
      double t[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const unsigned b = b0 + 32 * q;
        t[q] = b < gridDim.x ? part[(size_t)b * kMaxAcc + a] : 0.0;
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) v += t[q];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) tot[a] = v;
  }
  __syncthreads();
#pragma unroll
  for (int a = 0; a < NACC; ++a) out[a] = (float)tot[a];
  // tot is rewritten only after the next grid_sum's first __syncthreads
}

// d(i) = 1 + b * f32(i): a separate multiply and add, as the plain version
// and the JAX code evaluate it (exact index up to 2^24).
__device__ __forceinline__ float affine_diag(float b, long long i) {
  return __fadd_rn(1.f, __fmul_rn(b, __ll2float_rn(i)));
}

// ------------------------------------------------------------ pinned_stream

struct PinnedParams {
  const float* r_in;
  const float* p_in;
  const float* x;
  const float* s_in;
  float* r;
  float* p;
  float* s;
  float* acc_out;
  double* partial;     // [2][gridDim.x][kMaxAcc]
  long long n;
  long long g_held;    // x's groups [0, g_held) are the held region
  int hold;            // the held region's x is read from shared memory
  int iterations;
  float b;
};

// One iteration's pass over a slice.  xs: this block's copy of the slice's x
// in shared memory, or nullptr to read x from device memory.  A thread
// takes the slice's groups first + j, j = t, t + step, ... (first = 0 and
// step = the block's threads for a block's own slice; for the streamed
// region walked grid-wide, first and step span the grid), kUnroll of them a
// trip, always in this order, so its partial sums do not depend on kUnroll.
template <bool WITH_S>
__device__ __forceinline__ void pinned_sweep(
    const PinnedParams& P, Slice sl, long long first, long long step,
    const float* xs, const float* rs, const float* ps, const float* ss,
    float a, float a2, float (&part)[2]) {
  constexpr int W = 4;
  constexpr int U = kUnroll;
  for (long long j0 = first; j0 < sl.len; j0 += U * step) {
    float rc[U][W], pc[U][W], xc[U][W], sc[U][W];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long j = j0 + u * step;
      if (j < sl.len) {
        const long long i = (sl.begin + j) * W;
        Store<float>::load(rs, i, P.n, rc[u]);
        Store<float>::load(ps, i, P.n, pc[u]);
        if (xs != nullptr) Store<float>::load(xs, j * W, kNoBound, xc[u]);
        else Store<float>::load(P.x, i, P.n, xc[u]);
        if (WITH_S) Store<float>::load(ss, i, P.n, sc[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long j = j0 + u * step;
      if (j < sl.len) {
        const long long i = (sl.begin + j) * W;
        float rn[W], pn[W];
#pragma unroll
        for (int e = 0; e < W; ++e) {
          const float d = affine_diag(P.b, i + e);
          pn[e] = -rc[u][e] + a * pc[u][e];
          rn[e] = rc[u][e] + a * (d * pn[e]) + a2 * xc[u][e];
          part[0] += rn[e] * rn[e];
          part[1] += xc[u][e] * rn[e];
        }
        if (WITH_S) {
#pragma unroll
          for (int e = 0; e < W; ++e) sc[u][e] = sc[u][e] + a * pn[e];
          Store<float>::store(P.s, i, P.n, sc[u]);
        }
        Store<float>::store(P.r, i, P.n, rn);
        Store<float>::store(P.p, i, P.n, pn);
      }
    }
  }
}

template <bool WITH_S>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM) pinned_stream_kernel(PinnedParams P) {
  extern __shared__ uint4 dyn_smem[];
  __shared__ double red[kWarps][kMaxAcc];
  __shared__ double tot[kMaxAcc];
  cg::grid_group grid = cg::this_grid();
  constexpr int W = 4;
  float* xs = reinterpret_cast<float*>(dyn_smem);
  const long long G = ceil_div(P.n, W);
  const Slice held = block_slice(0, P.g_held);
  // the streamed region is walked by the whole grid in one stride
  const Slice rest = Slice{P.g_held, G - P.g_held};
  const long long rest_first = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long rest_step = (long long)gridDim.x * kThreads;

  if (P.hold) {
    // a thread reads back only the slots it wrote: no barrier is needed
    for (long long j = threadIdx.x; j < held.len; j += kThreads) {
      float v[W];
      Store<float>::load(P.x, (held.begin + j) * W, P.n, v);
      Store<float>::store(xs, j * W, kNoBound, v);
    }
  }

  float acc = 1.f;
  int par = 0;
  for (int k = 0; k < P.iterations; ++k) {
    const float a = 1e-12f * acc;
    const float a2 = a * a;
    // the first iteration reads the inputs; then r, p, s stream in place
    const float* rs = k == 0 ? P.r_in : P.r;
    const float* ps = k == 0 ? P.p_in : P.p;
    const float* ss = k == 0 ? P.s_in : P.s;
    float part[2] = {0.f, 0.f};
    pinned_sweep<WITH_S>(P, held, threadIdx.x, kThreads, P.hold ? xs : nullptr,
                         rs, ps, ss, a, a2, part);
    pinned_sweep<WITH_S>(P, rest, rest_first, rest_step, nullptr, rs, ps, ss,
                         a, a2, part);
    float out[2];
    grid_sum<kThreads, 2>(grid, P.partial, par, red, tot, part, out);
    par ^= 1;
    acc = out[0] + out[1];
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *P.acc_out = acc;
}

// ------------------------------------------------------------ resident_body

// One block of kBodyThreads threads on every SM: the SM's whole shared
// memory for one block (two blocks an SM hold 0.6% less, each losing its
// own reserve), and up to 85 registers a thread, room for a trip's loads in
// flight beside the trip being computed.
constexpr int kBodyThreads = 768;
constexpr int kBodyBlocksPerSM = 1;
constexpr int kBodyWarps = kBodyThreads / 32;

struct BodyParams {
  const void* r_in;
  const void* p_in;
  const void* x;
  void* r;             // the result; the streamed regions' r in place
  void* p;             // scratch: the streamed regions' p in place
  float* acc_out;
  double* partial;     // [2][gridDim.x][kMaxAcc]
  long long n;
  long long g1;        // groups [0, g1): r, p and x held in shared memory
  long long g2;        // groups [g1, g2): r and p held; [g2, G): streamed
  int iterations;
  float b;
};

struct Coefs {
  float beta, crr, c0, c1, rq;
};

// The cross-iteration coupling of the probe (coefs_from).
__device__ __forceinline__ Coefs coefs_from(const float (&d)[kMaxAcc]) {
  Coefs c;
  c.beta = 1e-7f * d[0] / (1.f + fabsf(d[1]));
  c.crr = -1e-7f * d[0] / (1.f + d[2]);
  c.c0 = 1e-9f * d[3] / (1.f + fabsf(d[4]));
  c.c1 = 1e-9f * d[5] / (1.f + d[2]);
  c.rq = 500.f + 1e-6f * d[0];
  return c;
}

// A 16-byte group of storage type T as raw words, unpacked to f32 and packed
// back with the rounding of Store<T>::store.
template <typename T> struct Raw;
template <> struct Raw<float> {
  __device__ static void unpack(const uint4& u, float (&v)[4]) {
    v[0] = __uint_as_float(u.x); v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z); v[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 pack(const float (&v)[4]) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
};
template <> struct Raw<__nv_bfloat16> {
  __device__ static void unpack(const uint4& u, float (&v)[8]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[2 * q] = __uint_as_float(w[q] << 16);
      v[2 * q + 1] = __uint_as_float(w[q] & 0xffff0000u);
    }
  }
  __device__ static uint4 pack(const float (&v)[8]) {
    uint32_t w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
      w[q] = *reinterpret_cast<const uint32_t*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// The group at element i of a vector of n as raw words (zeros past n:
// Store<T>::load), and the store of one (stores past n dropped).
template <typename T>
__device__ __forceinline__ uint4 load_group(const T* p, long long i,
                                           long long n) {
  if (i + Store<T>::W <= n) return *reinterpret_cast<const uint4*>(p + i);
  float f[Store<T>::W];
  Store<T>::load(p, i, n, f);
  return Raw<T>::pack(f);
}
template <typename T>
__device__ __forceinline__ void store_group(T* p, long long i, long long n,
                                            const float (&v)[Store<T>::W]) {
  if (i + Store<T>::W <= n) *reinterpret_cast<uint4*>(p + i) = Raw<T>::pack(v);
  else Store<T>::store(p, i, n, v);
}

// The chunk body on one group at element i: r, p, x in, rn, pn out, the six
// dots accumulated.
template <int W>
__device__ __forceinline__ void body_group(long long i, float b,
                                           const float (&rc)[W],
                                           const float (&pc)[W],
                                           const float (&xc)[W], const Coefs& c,
                                           float (&rn)[W], float (&pn)[W],
                                           float (&part)[kMaxAcc]) {
#pragma unroll
  for (int e = 0; e < W; ++e) {
    const float a = affine_diag(b, i + e);
    const float a0 = 2.f * a - c.rq;
    const float u1 = (2.f * a) * xc[e];
    pn[e] = -rc[e] + c.beta * pc[e];
    const float q = a0 * pn[e] + c.c0 * xc[e] + c.c1 * u1;
    rn[e] = rc[e] + c.crr * q;
    const float a0r = a0 * rn[e];
    const float a0p = a0 * pn[e];
    part[0] += rn[e] * rn[e];
    part[1] += a0r * rn[e];
    part[2] += a0r * a0r;
    part[3] += a0r * a0p;
    part[4] += xc[e] * a0r;
    part[5] += u1 * a0r;
  }
}

// What one trip reads from device memory: the held item's x (and, in the
// streamed arm, its r and p) and the streamed item's r, p and x.
struct Trip {
  uint4 hr, hp, hx, sr, sp, sx;
};

// A block's items: held item j < LH is group j of its slice of region 0
// (j < L0) or group j - L0 of its slice of region 1; in the resident arm
// its r and p live in shared memory at slot j (x too in region 0).
// Streamed item j < LS is group j of its slice of region 2.  Thread t takes
// trips j = t, t + NT, ... (in reverse order in odd iterations): held item
// j, then streamed item j.  Both arms run this one order, so their sums,
// and results, are bitwise equal.  Each trip's loads are issued a trip
// ahead -- the next iteration's first trip's before the grid-wide sum -- so
// device memory is busy while a trip computes and while the grid waits.
template <typename T, bool RES>
__global__ void __launch_bounds__(kBodyThreads, kBodyBlocksPerSM)
    resident_body_kernel(BodyParams P) {
  extern __shared__ uint4 dyn_smem[];
  __shared__ double red[kBodyWarps][kMaxAcc];
  __shared__ double tot[kMaxAcc];
  cg::grid_group grid = cg::this_grid();
  constexpr int W = Store<T>::W;
  constexpr int NT = kBodyThreads;
  const T* r_in = static_cast<const T*>(P.r_in);
  const T* p_in = static_cast<const T*>(P.p_in);
  const T* x = static_cast<const T*>(P.x);
  T* r_out = static_cast<T*>(P.r);
  T* p_out = static_cast<T*>(P.p);
  const long long G = ceil_div(P.n, W);
  const Slice sl[3] = {block_slice(0, P.g1), block_slice(P.g1, P.g2),
                       block_slice(P.g2, G)};
  const long long L0 = sl[0].len, LH = sl[0].len + sl[1].len;
  const long long LS = sl[2].len;
  const long long LT = LH > LS ? LH : LS;
  // shared memory, in groups: r of the held items, p of them, x of region 0
  T* sm_r = reinterpret_cast<T*>(dyn_smem);
  T* sm_p = sm_r + LH * W;
  T* sm_x = sm_r + 2 * LH * W;

  auto held_at = [&](long long j) {
    return j < L0 ? (sl[0].begin + j) * W : (sl[1].begin + j - L0) * W;
  };

  // rv0 = sum r^2, and the copy-in of what is held (a thread reads back
  // only the slots it wrote: no barrier is needed)
  float acc0[1] = {0.f};
  for (int reg = 0; reg < 3; ++reg) {
    for (long long j = threadIdx.x; j < sl[reg].len; j += NT) {
      const long long i = (sl[reg].begin + j) * W;
      float v[W];
      Store<T>::load(r_in, i, P.n, v);
#pragma unroll
      for (int e = 0; e < W; ++e) acc0[0] += v[e] * v[e];
      if (RES && reg < 2) {
        const long long slot = (reg == 0 ? j : L0 + j) * W;
        Store<T>::store(sm_r, slot, kNoBound, v);
        Store<T>::load(p_in, i, P.n, v);
        Store<T>::store(sm_p, slot, kNoBound, v);
        if (reg == 0) {
          Store<T>::load(x, i, P.n, v);
          Store<T>::store(sm_x, slot, kNoBound, v);
        }
      }
    }
  }
  int par = 0;
  float rv0[1];
  grid_sum<NT, 1>(grid, P.partial, par, red, tot, acc0, rv0);
  par ^= 1;
  float dots[kMaxAcc] = {rv0[0], 0.f, 0.f, 0.f, 0.f, 0.f};

  auto load_trip = [&](long long j, const T* rs, const T* ps, Trip& t) {
    if (j < LH) {
      const long long i = held_at(j);
      if (!RES) {
        t.hr = load_group(rs, i, P.n);
        t.hp = load_group(ps, i, P.n);
      }
      if (!(RES && j < L0)) t.hx = load_group(x, i, P.n);
    }
    if (j < LS) {
      const long long i = (sl[2].begin + j) * W;
      t.sr = load_group(rs, i, P.n);
      t.sp = load_group(ps, i, P.n);
      t.sx = load_group(x, i, P.n);
    }
  };
  auto run_trip = [&](long long j, const Trip& t, const Coefs& c,
                      float (&part)[kMaxAcc]) {
    float rc[W], pc[W], xc[W], rn[W], pn[W];
    if (j < LH) {
      const long long i = held_at(j);
      if (RES) {
        Store<T>::load(sm_r, j * W, kNoBound, rc);
        Store<T>::load(sm_p, j * W, kNoBound, pc);
      } else {
        Raw<T>::unpack(t.hr, rc);
        Raw<T>::unpack(t.hp, pc);
      }
      if (RES && j < L0) Store<T>::load(sm_x, j * W, kNoBound, xc);
      else Raw<T>::unpack(t.hx, xc);
      body_group<W>(i, P.b, rc, pc, xc, c, rn, pn, part);
      // r and p round to storage here, in shared memory as in device memory
      if (RES) {
        Store<T>::store(sm_r, j * W, kNoBound, rn);
        Store<T>::store(sm_p, j * W, kNoBound, pn);
      } else {
        store_group(r_out, i, P.n, rn);
        store_group(p_out, i, P.n, pn);
      }
    }
    if (j < LS) {
      const long long i = (sl[2].begin + j) * W;
      Raw<T>::unpack(t.sr, rc);
      Raw<T>::unpack(t.sp, pc);
      Raw<T>::unpack(t.sx, xc);
      body_group<W>(i, P.b, rc, pc, xc, c, rn, pn, part);
      store_group(r_out, i, P.n, rn);
      store_group(p_out, i, P.n, pn);
    }
  };

  // this thread's trips; odd iterations walk them backwards, so that an
  // iteration starts on the lines the last one touched last
  const long long trips =
      threadIdx.x < LT ? (LT - 1 - threadIdx.x) / NT + 1 : 0;
  Trip cur;
  load_trip(threadIdx.x, r_in, p_in, cur);
  for (int k = 0; k < P.iterations; ++k) {
    const Coefs c = coefs_from(dots);
    const T* rs = k == 0 ? r_in : r_out;
    const T* ps = k == 0 ? p_in : p_out;
    const bool back = k & 1;
    float part[kMaxAcc] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (long long u = 0; u < trips; ++u) {
      const long long j = threadIdx.x + (back ? trips - 1 - u : u) * NT;
      Trip nxt;
      const bool last = u + 1 == trips;
      if (!last) load_trip(j + (back ? -NT : NT), rs, ps, nxt);
      run_trip(j, cur, c, part);
      // the next iteration's first trip is this one: its loads go after
      // this trip's stores, which they read back
      if (last && k + 1 < P.iterations) load_trip(j, r_out, p_out, nxt);
      cur = nxt;
    }
    grid_sum<NT, kMaxAcc>(grid, P.partial, par, red, tot, part, dots);
    par ^= 1;
  }

  if (RES) {
    // the held r goes back to device memory once
    for (long long j = threadIdx.x; j < LH; j += NT) {
      float v[W];
      Store<T>::load(sm_r, j * W, kNoBound, v);
      Store<T>::store(r_out, held_at(j), P.n, v);
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *P.acc_out = dots[0] + dots[3];
}

// ------------------------------------------------------------------- host

// per_sm blocks of `threads` on every SM, fewer when the vector is short;
// the shared-memory slots a block may take (the SM's shared memory split
// among its blocks, less what the system and the kernel's static arrays
// take).
cudaError_t card_geometry(const void* fn, int threads, int blocks_per_sm,
                          long long groups, int* grid, long long* slots) {
  int dev = 0, sms = 0, optin = 0, per_sm = 0, reserved = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return e;
  const long long want = ceil_div(groups, threads);
  const long long cap = (long long)sms * blocks_per_sm;
  *grid = (int)(want < 1 ? 1 : (want < cap ? want : cap));
  long long bytes = per_sm / blocks_per_sm - reserved;
  if (bytes > optin) bytes = optin;
  *slots = (bytes - (long long)attr.sharedSizeBytes) / kSlot;
  if (*slots < 0) *slots = 0;
  return cudaSuccess;
}

cudaError_t launch(const void* fn, int threads, void** args, int grid,
                   int smem_bytes, const cudaAccessPolicyWindow* window,
                   cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return e;
  int per_sm = 0, dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, smem_bytes);
  if (e != cudaSuccess) return e;
  if ((long long)per_sm * sms < grid) return cudaErrorCooperativeLaunchTooLarge;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeCooperative;
  attrs[0].val.cooperative = 1;
  int nattrs = 1;
  if (window != nullptr) {
    attrs[1].id = cudaLaunchAttributeAccessPolicyWindow;
    attrs[1].val.accessPolicyWindow = *window;
    nattrs = 2;
  }
  cfg.attrs = attrs;
  cfg.numAttrs = nattrs;
  e = cudaLaunchKernelExC(&cfg, fn, args);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// ------------------------------------------------------------- chunk_reader

constexpr int kReadThreads = 256;
constexpr int kReadBlocksPerSM = 8;      // 64 warps, the SM's full complement
constexpr int kReadWarps = kReadThreads / 32;
constexpr int kReadUnroll = 4;           // pieces a warp has in flight

// The offset of fetch t: t mod nch, or the JAX probe's int32 LCG
// h = t * 1103515245 + 12345 wrapping at 32 bits, then |h| mod nch the way
// jnp computes them: |INT32_MIN| stays INT32_MIN, and % is a floor-mod
// (C's truncating % would give a negative offset there).  nch < 2^31.
__device__ __forceinline__ long long chunk_offset(long long t, long long nch,
                                                  int random) {
  if (!random) return t % nch;
  const int32_t h = (int32_t)((uint32_t)t * 1103515245u + 12345u);
  const int32_t a = (h == INT32_MIN) ? h : (h < 0 ? -h : h);
  const int32_t m = a % (int32_t)nch;
  return m < 0 ? (long long)m + nch : (long long)m;
}

// The fetch stream is cut into 512-byte pieces, one row of 128 words each:
// piece i is row i mod gr of the chunk of fetch start + i / gr.  Warp w
// reads pieces w, w + W, w + 2W, ... (W warps in the grid), kReadUnroll of
// them in flight, one 16-byte load a lane each: consecutive warps read
// consecutive rows of a chunk, whatever its size, so every granularity runs
// at the same parallelism, and the window read at one time (a few MB) is far
// below the vector, so a chunk read again (n_fetch > nch) comes from device
// memory as on the TPU, not from another warp's lines in L2.
__global__ void __launch_bounds__(kReadThreads)
    chunk_reader_kernel(const float4* __restrict__ v, long long gr,
                        long long nch, long long start, long long n_fetch,
                        int random, float* __restrict__ part) {
  const int lane = threadIdx.x & 31;
  const long long w = (long long)blockIdx.x * kReadWarps + (threadIdx.x >> 5);
  const long long W = (long long)gridDim.x * kReadWarps;
  const long long step_t = W / gr, step_r = W % gr;
  long long t = w / gr, r = w % gr;          // this warp's next piece
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  while (t < n_fetch) {
    float4 x[kReadUnroll];
    int m = 0;
#pragma unroll
    for (int u = 0; u < kReadUnroll; ++u) {
      if (t < n_fetch) {
        const long long row = chunk_offset(start + t, nch, random) * gr + r;
        x[u] = __ldg(v + row * 32 + lane);
        m = u + 1;
        t += step_t;
        r += step_r;
        if (r >= gr) {
          r -= gr;
          ++t;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kReadUnroll; ++u) {
      if (u < m) {
        acc.x += x[u].x;
        acc.y += x[u].y;
        acc.z += x[u].z;
        acc.w += x[u].w;
      }
    }
  }
  float s = (acc.x + acc.y) + (acc.z + acc.w);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  if (lane == 0) part[w] = s;
}

// One block adds the warps' partials in double, in a fixed order.
__global__ void __launch_bounds__(kReadThreads)
    chunk_finish_kernel(const float* __restrict__ part, int n, float* out) {
  __shared__ double red[kReadWarps];
  double v = 0.0;
  for (int i = threadIdx.x; i < n; i += kReadThreads) v += (double)part[i];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    double t = 0.0;
    for (int w = 0; w < kReadWarps; ++w) t += red[w];
    out[0] = (float)t;
  }
}

const void* body_kernel(int bf16, int resident) {
  if (bf16)
    return resident ? (const void*)resident_body_kernel<__nv_bfloat16, true>
                    : (const void*)resident_body_kernel<__nv_bfloat16, false>;
  return resident ? (const void*)resident_body_kernel<float, true>
                  : (const void*)resident_body_kernel<float, false>;
}

}  // namespace

extern "C" {

const char* probes_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Geometry of a pinned_stream launch over n f32 elements: the grid, the
// dynamic shared memory a block takes, and how many of x's 16-byte groups
// shared memory holds (the held region [0, g_held)).  The caller sizes the
// partial buffer as 2 * grid * probes_nacc() doubles.
int probes_pinned_geometry(long long n, int* grid, int* smem_bytes,
                           long long* g_held) {
  const long long G = ceil_div(n, 4);
  long long slots = 0;
  cudaError_t e = card_geometry((const void*)pinned_stream_kernel<true>,
                                kThreads, kBlocksPerSM, G, grid, &slots);
  if (e != cudaSuccess) return (int)e;
  const long long total = slots * *grid;
  *g_held = G < total ? G : total;
  *smem_bytes = (int)(ceil_div(*g_held, *grid) * kSlot);
  return 0;
}

int probes_nacc() { return kMaxAcc; }

// What the current card has on chip, whatever these kernels make of it: its
// SM count, the most shared memory one block may opt in to, and its L2 size.
int probes_card_capacity(int* sms, int* shared_optin_bytes, int* l2_bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(shared_optin_bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaDeviceGetAttribute(l2_bytes, cudaDevAttrL2CacheSize, dev);
}

// K iterations of the pinned-stream loop on `stream`.  hold: read the held
// region's x from shared memory (else everything streams; the geometry is
// the same).  window: put an L2 access-policy window over the part of x
// that shared memory does not hold; the share of x's bytes it can keep
// (set-aside L2 over x's size) is returned in *l2_share.  With a window the
// call waits for the kernel, then gives the set-aside L2 back, so that no
// later kernel runs with a smaller cache.  Returns a cudaError_t code.
int probes_pinned_stream(const float* r_in, const float* p_in, const float* x,
                         const float* s_in, float* r, float* p, float* s,
                         float* acc_out, double* partial, long long n,
                         int iterations, int hold, int window, int grid,
                         int smem_bytes, long long g_held, double* l2_share,
                         void* stream) {
  PinnedParams P;
  P.r_in = r_in;
  P.p_in = p_in;
  P.x = x;
  P.s_in = s_in;
  P.r = r;
  P.p = p;
  P.s = s;
  P.acc_out = acc_out;
  P.partial = partial;
  P.n = n;
  P.g_held = g_held;
  P.hold = hold;
  P.iterations = iterations;
  P.b = (float)(999.0 / (double)(n - 1));
  void* args[] = {&P};
  const void* fn = s_in != nullptr ? (const void*)pinned_stream_kernel<true>
                                   : (const void*)pinned_stream_kernel<false>;
  *l2_share = 0.0;
  cudaAccessPolicyWindow win;
  size_t old_limit = 0;
  bool windowed = false;
  if (window) {
    int dev = 0, max_persist = 0, max_window = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&max_persist, cudaDevAttrMaxPersistingL2CacheSize, dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&max_window, cudaDevAttrMaxAccessPolicyWindowSize, dev);
    if (e != cudaSuccess) return (int)e;
    const long long first = hold ? g_held * 4 : 0;   // elements held in smem
    const long long want = (n - first) * 4;          // bytes of x that stream
    const long long bytes = want < max_window ? want : max_window;
    const long long persist = bytes < max_persist ? bytes : max_persist;
    if (persist > 0) {
      e = cudaDeviceGetLimit(&old_limit, cudaLimitPersistingL2CacheSize);
      if (e != cudaSuccess) return (int)e;
      e = cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize, (size_t)persist);
      if (e != cudaSuccess) return (int)e;
      win.base_ptr = (void*)(x + first);
      win.num_bytes = (size_t)bytes;
      // a little under the set-aside size, so persisting lines do not
      // evict each other
      win.hitRatio = 0.95f * (float)((double)persist / (double)bytes);
      win.hitProp = cudaAccessPropertyPersisting;
      win.missProp = cudaAccessPropertyStreaming;
      windowed = true;
      *l2_share = (double)win.hitRatio * (double)bytes / ((double)n * 4.0);
    }
  }
  cudaError_t e = launch(fn, kThreads, args, grid, hold ? smem_bytes : 0,
                         windowed ? &win : nullptr, (cudaStream_t)stream);
  if (windowed) {
    cudaError_t e2 = cudaStreamSynchronize((cudaStream_t)stream);
    cudaError_t e3 = cudaCtxResetPersistingL2Cache();
    cudaError_t e4 = cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize, old_limit);
    if (e == cudaSuccess) e = e2 != cudaSuccess ? e2 : (e3 != cudaSuccess ? e3 : e4);
  }
  return (int)e;
}

// Geometry of a resident_body launch over n elements of f32 or bf16
// storage: groups [0, g1) have r, p and x in shared memory, [g1, g2) r and
// p, the rest streams.  r and p come first (each is read and written every
// iteration, x only read).
int probes_body_geometry(int bf16, long long n, int* grid, int* smem_bytes,
                         long long* g1, long long* g2) {
  const int W = bf16 ? 8 : 4;
  const long long G = ceil_div(n, W);
  long long cap = 0;
  cudaError_t e = card_geometry(body_kernel(bf16, 1), kBodyThreads,
                                kBodyBlocksPerSM, G, grid, &cap);
  if (e != cudaSuccess) return (int)e;
  const long long per_g = ceil_div(G, *grid);
  if (2 * per_g <= cap) {
    long long per_x = cap - 2 * per_g - 2;
    if (per_x > per_g) per_x = per_g;
    if (per_x < 0) per_x = 0;
    *g1 = per_x * *grid < G ? per_x * *grid : G;
    *g2 = G;
  } else {
    *g1 = 0;
    *g2 = (cap / 2) * *grid;
  }
  *smem_bytes = (int)((3 * ceil_div(*g1, *grid)
                       + 2 * ceil_div(*g2 - *g1, *grid)) * kSlot);
  return 0;
}

// K iterations of the CG chunk body on `stream`.  resident: keep the held
// regions in shared memory (else stream everything, in the same geometry).
int probes_resident_body(int bf16, const void* r_in, const void* p_in,
                         const void* x, void* r, void* p, float* acc_out,
                         double* partial, long long n, int iterations,
                         int resident, int grid, int smem_bytes, long long g1,
                         long long g2, void* stream) {
  BodyParams P;
  P.r_in = r_in;
  P.p_in = p_in;
  P.x = x;
  P.r = r;
  P.p = p;
  P.acc_out = acc_out;
  P.partial = partial;
  P.n = n;
  P.g1 = g1;
  P.g2 = g2;
  P.iterations = iterations;
  P.b = (float)(999.0 / (double)(n - 1));
  void* args[] = {&P};
  return (int)launch(body_kernel(bf16, resident), kBodyThreads, args, grid,
                     resident ? smem_bytes : 0, nullptr, (cudaStream_t)stream);
}

// The sum of fetches [start, start + n_fetch) of gr-row chunks of v (rows of
// 128 f32 words, 16-byte aligned; nch = rows / gr chunks) into out[0], on
// `stream`: the reader on kReadBlocksPerSM blocks on each of `sms` SMs (fewer
// when there are fewer pieces, n_fetch * gr rows, than warps), then the
// finishing kernel.  `part` holds `part_len` floats, one a warp of the grid
// (sms * 64 always suffices).  Returns a cudaError_t.
int probes_chunk_reader(const float* v, long long gr, long long nch,
                        long long start, long long n_fetch, int random,
                        int sms, float* part, long long part_len, float* out,
                        void* stream) {
  const long long want = ceil_div(n_fetch * gr, kReadWarps);
  const long long cap = (long long)sms * kReadBlocksPerSM;
  const int grid = (int)(want < cap ? want : cap);
  if (sms < 1 || (long long)grid * kReadWarps > part_len)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  chunk_reader_kernel<<<grid, kReadThreads, 0, st>>>(
      (const float4*)v, gr, nch, start, n_fetch, random, part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  chunk_finish_kernel<<<1, kReadThreads, 0, st>>>(part, grid * kReadWarps, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
