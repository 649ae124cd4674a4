// Whole-loop streamed trust-region CG for the H100 (sm_90a): any rank K.
//
// Replaces optimization_tpu/kernels/streamed_cg.py:_mk_kernel (the Pallas
// TPU kernel behind stpcg_flat_streamed) for K >= 5; csrc/streamed_cg.cu
// keeps its register instantiations for K = 1-4 and the sphere layout.  One
// launch solves one Steihaug-Toint trust-region subproblem for
//
//   H = A0 + U B U',   A0 = diag(a0),   U = (w_1 .* x, ..., w_K .* x),
//
// K a runtime value, with the terms, the preconditioner P = M^(-1/2), the
// Chronopoulos-Gear pair/single bodies and the arithmetic of each element
// exactly as in csrc/streamed_cg.cu (the Pallas kernel's recurrences;
// rank k :120-138, :206-256, :342-345, :411-415 there).
//
// What bounds it: device-memory bytes up to K of a few dozen, then
// operations.  A CG iteration moves 6n words on average (pair body) plus n
// for each stored term, as the register kernel does; a generated term
// needs ~7 f32 operations an element a pass (its value, u = w x, a
// multiply-add into q = Hp and one into U'(A0 r); this kernel regenerates
// the value and u for the second, ~11), so with generated terms only the
// operations overtake the bytes near K = 55 (chip_smoke.subproblem_bound).
// The init pass adds the Gram of (g, A0 g, U): (K+2)(K+3)/2 products an
// element, once a subproblem.
//
// What the design does about K.  Nothing K-sized lives in registers:
//   - the element pass loops over the terms inside each 16-byte group of W
//     elements; u_j = w_j .* x is regenerated or loaded, used and dropped,
//     once for q2 = a0 p2 + sum_j (B mp)_j u_j and once more for the dot
//     u_j . (a0 r2) (a stored term's second read hits L1/L2);
//   - each thread's partials of the K dots U'(a0 r2) sit in shared memory,
//     [K][256] f32 (K KB), each thread its own column;
//   - the K-vector recurrences (m, mA, mB, mp) and the K x K products with
//     B and U'U advance once per block: each K x K product by the block's
//     threads, a row each, the eight K-dots one per warp, in a fixed order;
//     the K coefficients B mp_k of the pass are read from shared memory;
//   - B' (the wrapper passes B transposed) and U'U are copied to shared
//     memory while their 8K^2 bytes fit beside the terms, the K-vectors and
//     the dot partials (72K + 1,024K bytes): up to K = 115 on an H100
//     (232,448 bytes a block less the kernel's 288 static; `plan`).  Above
//     that line they are read from device memory (and stay in L2), as are,
//     further up, the init tile (K >= 210) and the dot partials (K >= 212).
//     Every array is reached through a generic pointer, so the code is the
//     same on both sides of each line.
//   - the init pass stages a tile of 256 elements of V = (g, a0 g, u_1..K)
//     in shared memory, a row of K + 2 values each, and its threads own the
//     (K+2)(K+3)/2 pairs of V'V (row-major upper triangle): an f32 dot over
//     the tile, then added in double into the block's slot.
//
// The grid-wide reduction keeps the register kernel's property that two
// runs on one card are bitwise equal (double, a fixed order, no atomics),
// but no block reads all blocks' partials: each block writes its sums
// entry-major, crosses grid.sync(), sums the entries a = block + grid * q
// over all blocks (32 lanes, then a shuffle tree), writes the totals, and
// crosses a second grid.sync() before every block reads the totals.  A
// reduction costs two grid barriers and ceil(N / grid) coalesced reads of
// `grid` doubles a block, N = 4 + K a half, (K+2)(K+3)/2 the init.
//
// Plain C interface for ctypes; see optimization_tpu_torch/kernels/
// streamed_cg.py for the wrapper and the plain PyTorch version.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "storage.cuh"
#include "streamed_cg.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = kThreads;   // elements of an init tile, one a thread
constexpr int kVecs = 12;         // the K-vectors of a block (Vecs below)

// Where each array of a block lives: in dynamic shared memory (offsets from
// its start) or, past the budget, in global scratch (offsets into the
// block's own slice, `block_bytes` long; B' and U'U have one global copy
// for all blocks).  The init tile overlaps the dot partials and B', U'U:
// those are first written after the init pass.
struct Layout {
  int terms_smem, vecs_smem, acc_smem, mats_smem, tile_smem;
  long long terms_off, vecs_off, acc_off, mats_off, tile_off;
  long long block_bytes;   // a block's slice of the global scratch
  long long smem_bytes;    // dynamic shared memory a block
  int stride;              // an init tile row, floats (K + 2 or K + 3: odd)
};

__host__ __device__ inline long long round16(long long b) {
  return (b + 15) / 16 * 16;
}

// Place the arrays in order of use per element (terms, K-vectors, dot
// partials, B' and U'U) into `budget` bytes of shared memory.
Layout plan(int K, int with_init, long long budget) {
  Layout L = {};
  long long used = 0;
  auto put = [&](long long bytes, int& in_smem, long long& off) {
    in_smem = used + bytes <= budget;
    if (in_smem) {
      off = used;
      used += bytes;
    } else {
      off = L.block_bytes;
      L.block_bytes += bytes;
    }
  };
  put(round16((long long)sizeof(Term) * (K + 1)), L.terms_smem, L.terms_off);
  // a global Term array is the caller's own (read only): no slice for it
  if (!L.terms_smem) L.block_bytes = 0;
  put(round16(4LL * kVecs * K), L.vecs_smem, L.vecs_off);
  const long long region = used;
  put(4LL * K * kThreads, L.acc_smem, L.acc_off);
  const long long mats = 8LL * K * K;
  L.mats_smem = used + mats <= budget;
  if (L.mats_smem) {
    L.mats_off = used;
    used += mats;
  }
  L.stride = (K + 2) | 1;
  const long long tile = with_init ? 0 : 4LL * kTile * L.stride;
  L.tile_smem = region + tile <= budget;
  if (L.tile_smem) {
    L.tile_off = region;
    if (region + tile > used) used = region + tile;
  } else {
    L.tile_off = L.block_bytes;
    L.block_bytes += tile;
  }
  L.block_bytes = round16(L.block_bytes);
  L.smem_bytes = used;
  return L;
}

// The pairs of V'V (V = (g, a0 g, u_1..K), R = K + 2 rows) and a half's
// group (rv, ar, nr, pa, mA[K]); the scratch holds the wider.
__host__ __device__ inline long long init_pairs(int K) {
  return (long long)(K + 2) * (K + 3) / 2;
}
__host__ __device__ inline long long nmax(int K, int with_init) {
  return with_init ? 4 + K : init_pairs(K);
}

struct AnyParams {
  const void* g;
  const void* x;
  const Term* terms;     // device: a0, then the K weights
  int k;
  const float* prec;     // stored p (kPrecStored)
  float prec_c;          // c of the generated p
  int prec_quarter;      // e = 1/4 (else e = 1/2)
  void* s;
  void* r;
  void* p;
  const float* scal;     // Delta, aux[n_aux], threaded init group
  int n_aux;
  const float* Bt;       // B', K x K row-major (B column-major)
  float* res;            // k, boundary, |s|^2, model value
  unsigned char* scratch;  // part, tot, U'U, the blocks' slices
  long long n;
  int max_iterations;
  float kappa_fgr;
  float theta;
  float epsilon;
  int pair;
  int with_init;
  Layout L;
};

// Byte offsets in the global scratch: part [nmax][grid] doubles (entry-
// major), tot [nmax] doubles, U'U [K][K] f32 (the init pass's), then the
// blocks' slices.
struct Scratch {
  long long tot, uu, blocks, bytes;
};

__host__ __device__ inline Scratch scratch_of(int K, int with_init, int grid,
                                              const Layout& L) {
  Scratch S;
  const long long nm = nmax(K, with_init);
  S.tot = round16(8 * nm * grid);
  S.uu = S.tot + round16(8 * nm);
  S.blocks = S.uu + (with_init ? 0 : round16(4LL * K * K));
  S.bytes = S.blocks + L.block_bytes * grid;
  return S;
}

// A term's t(i) at one index (the init pass: one element a thread).
__device__ __forceinline__ float term_at(const Term& t, float aux0,
                                         long long i) {
  const float v = t.mode == kTermStored
                      ? t.ptr[i]
                      : __fadd_rn(t.c, __fmul_rn(t.b, __ll2float_rn(i)));
  if (t.form == kFormTwice) return 2.f * v;
  if (t.form == kFormShift) return __fsub_rn(2.f * v, aux0);
  return v;
}

__device__ __forceinline__ float prec_of(int PK, const AnyParams& P, float a0,
                                         long long i) {
  if (PK == kPrecStored) return P.prec[i];
  const float d = __fadd_rn(fabsf(a0), P.prec_c);
  return P.prec_quarter ? __frsqrt_rn(__fsqrt_rn(d)) : __frsqrt_rn(d);
}

// p for W consecutive indices (0 past n, so a masked element never meets
// rsqrt(0)); the register kernel's prec_group.
template <int PK, int W>
__device__ __forceinline__ void prec_w(const AnyParams& P, long long i,
                                       const float (&a0)[W], float (&p)[W]) {
  if (PK == kPrecStored) {
    load_f32<W>(P.prec, i, P.n, p);
  } else {
#pragma unroll
    for (int e = 0; e < W; ++e) {
      p[e] = prec_of(PK, P, a0[e], 0);
      if (i + e >= P.n) p[e] = 0.f;
    }
  }
}

// u = w x of one weight for a group (u = p w x with P; the register
// kernel's Group::fold, in its multiplication order).
template <int PK, int W>
__device__ __forceinline__ void weight_u(const Term& t, float aux0,
                                         long long i, long long n,
                                         const float (&x)[W],
                                         const float (&p)[W], float (&u)[W]) {
  if (t.mode == kTermOne) {
#pragma unroll
    for (int e = 0; e < W; ++e) u[e] = PK == kPrecNone ? x[e] : p[e] * x[e];
  } else {
    float w[W];
    term_group<W>(t, aux0, i, n, w);
#pragma unroll
    for (int e = 0; e < W; ++e)
      u[e] = PK == kPrecNone ? w[e] * x[e] : (p[e] * w[e]) * x[e];
  }
}

// The block's K-vectors: kVecs of K floats from one base (addresses
// computed where used, so they take no registers of their own).
struct Vecs {
  float* base;
  int K;
  __device__ float* at(int q) const { return base + (long long)q * K; }
  __device__ float* m() const { return at(0); }
  __device__ float* mA() const { return at(1); }
  __device__ float* mB() const { return at(2); }
  __device__ float* mp() const { return at(3); }
  __device__ float* Bm() const { return at(4); }
  __device__ float* Bmp() const { return at(5); }
  __device__ float* UUBm() const { return at(6); }
  __device__ float* UUBmp() const { return at(7); }
  __device__ float* mpk() const { return at(8); }
  __device__ float* mB2() const { return at(9); }
  __device__ float* Bmpk() const { return at(10); }
  __device__ float* UUBmpk() const { return at(11); }
};

// out = M v for K x K M given as M' row-major (column i of M' is row i of
// M: the block's threads read consecutive words); one row a thread, summed
// in the order j = 0..K-1 (the register kernel's kdot).
__device__ __forceinline__ void matvec(const float* Mt, const float* v,
                                       float* out, int K) {
  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    float t = Mt[i] * v[0];
    for (int j = 1; j < K; ++j) t = t + Mt[(long long)j * K + i] * v[j];
    out[i] = t;
  }
}

// a . b of two K-vectors by one warp: lanes stride, then an xor tree (every
// lane holds the same sum).
__device__ __forceinline__ float warp_dot(const float* a, const float* b,
                                          int K) {
  float t = 0.f;
  for (int j = threadIdx.x & 31; j < K; j += 32) t = t + a[j] * b[j];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) t += __shfl_xor_sync(0xffffffffu, t, off);
  return t;
}

// The grid-wide sums of `N` entries whose block sums each block has written
// to part[a * grid + block]: block b sums the entries a = b + grid * q (one
// warp an entry), in double and a fixed order, into tot[a].  With `uu`
// (the init pass), the U'U entries are also written as f32 K x K.
__device__ void grid_sum(cg::grid_group& grid, const double* part,
                         double* tot, long long N, float* uu, int K) {
  grid.sync();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long G = gridDim.x;
  const int R = K + 2;
  for (long long a = blockIdx.x + G * warp; a < N; a += G * kWarps) {
    double v = 0.0;
    for (long long b = lane; b < G; b += 32) v += part[a * G + b];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) {
      tot[a] = v;
      if (uu != nullptr) {
        // (row, col) of the upper-triangle index a
        long long row = 0, start = 0;
        while (a >= start + (R - row)) {
          start += R - row;
          ++row;
        }
        const long long col = row + (a - start);
        if (row >= 2) {
          uu[(row - 2) * K + (col - 2)] = (float)v;
          uu[(col - 2) * K + (row - 2)] = (float)v;
        }
      }
    }
  }
  grid.sync();
}

// The carried scalars of the CG loop (the register kernel's Carry without
// its K-vectors), identical in every thread.
struct Carry {
  int k;
  float rv, ar, nr, pa, nAp, rv_prev, alpha_prev, pr_c, kappa_prev;
  float s_p, sk2, pp_prev, mval, done, bnd, s_valid, p_valid;
};

struct Block {
  const Term* terms;
  Vecs v;
  float* acc;        // [K][kThreads] dot partials
  const float* Bt;   // B'
  const float* UU;   // U'U (symmetric)
  float* dots;       // [kWarps], shared
  double* red;       // [kWarps][4], shared
  double* part;
  double* tot;
  float Delta2, aux0, eps2, target;
  int K;
};

// One CG iteration (the Pallas kernel's half(), :354-501; the register
// kernel's half() with the K-sized algebra spread over the block).
template <typename T, int PK, bool APPLY>
__device__ float half(cg::grid_group& grid, const AnyParams& P,
                      const Block& S, Carry& c, float pend) {
  constexpr int W = Store<T>::W;
  const T* g = static_cast<const T*>(P.g);
  const T* x = static_cast<const T*>(P.x);
  T* s = static_cast<T*>(P.s);
  T* r = static_cast<T*>(P.r);
  T* p = static_cast<T*>(P.p);
  const int K = S.K;
  const Vecs& V = S.v;
  const long long ngroups = (P.n + W - 1) / W;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;

  const bool frozen = (c.done != 0.f) || (c.k >= P.max_iterations) ||
                      (sqrtf(c.rv) <= S.target);
  if (frozen) {
    // only reachable as the second half of a pair: s <- s + pend * p
    if (APPLY) {
      for (long long gi = t0; gi < ngroups; gi += stride) {
        const long long i = gi * W;
        float sc[W], pc[W];
        if (c.s_valid != 0.f) Store<T>::load(s, i, P.n, sc);
        else for (int e = 0; e < W; ++e) sc[e] = 0.f;
        if (c.p_valid != 0.f) Store<T>::load(p, i, P.n, pc);
        else for (int e = 0; e < W; ++e) pc[e] = 0.f;
#pragma unroll
        for (int e = 0; e < W; ++e)
          sc[e] = sc[e] + ((c.p_valid != 0.f) ? pend * pc[e] : 0.f);
        Store<T>::store(s, i, P.n, sc);
      }
      c.s_valid = 1.f;
    }
    return 0.f;
  }

  const bool first = c.rv_prev == 0.f;
  const float beta = first ? 0.f : c.rv / c.rv_prev;

  // ---- the K-sized algebra, once per block ----
  for (int j = tid; j < K; j += blockDim.x) {
    V.mpk()[j] = -V.m()[j] + beta * V.mp()[j];
    V.mB2()[j] = -V.mA()[j] + beta * V.mB()[j];
  }
  matvec(S.Bt, V.m(), V.Bm(), K);
  matvec(S.Bt, V.mp(), V.Bmp(), K);
  __syncthreads();
  matvec(S.UU, V.Bm(), V.UUBm(), K);
  matvec(S.UU, V.Bmp(), V.UUBmp(), K);
  matvec(S.Bt, V.mpk(), V.Bmpk(), K);
  __syncthreads();
  matvec(S.UU, V.Bmpk(), V.UUBmpk(), K);
  {
    // the eight K-dots, one a warp (kWarps = 8): m.Bm, mA.Bm, Bm.UUBm,
    // mA.Bmp, Bm.mB, Bm.UUBmp, mB.Bmp, Bmp.UUBmp
    constexpr int kA[kWarps] = {0, 1, 4, 1, 4, 4, 2, 5};
    constexpr int kB[kWarps] = {4, 4, 6, 5, 2, 7, 5, 7};
    int qa = 0, qb = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      if (w == warp) {
        qa = kA[w];
        qb = kB[w];
      }
    const float d = warp_dot(V.at(qa), V.at(qb), K);
    if ((tid & 31) == 0) S.dots[warp] = d;
  }
  __syncthreads();

  const float wr = c.ar + S.dots[0];
  const float kappa = wr - (beta / c.alpha_prev) * c.rv;
  const float pp_k = c.rv + beta * beta * c.pp_prev;
  const float pr_k = -c.rv + beta * (c.pr_c + c.alpha_prev * c.kappa_prev);
  const float sp_k = beta * (c.s_p + c.alpha_prev * c.pp_prev);

  // kernel-of-H safeguard via the |q|^2 recurrence
  const float ww = c.nr + 2.f * S.dots[1] + S.dots[2];
  const float wq = c.pa + S.dots[3] + S.dots[4] + S.dots[5];
  const float qq_prev = c.nAp + 2.f * S.dots[6] + S.dots[7];
  const float qq_k = ww - 2.f * beta * wq + beta * beta * qq_prev;
  const bool in_kernel = qq_k < S.eps2 * pp_k;
  const float sign = (in_kernel && pr_k > 0.f) ? -1.f : 1.f;

  const float sp_eff = sign * sp_k;
  const float disc = sp_eff * sp_eff + pp_k * (S.Delta2 - c.sk2);
  const float sigma = (-sp_eff + sqrtf(fmaxf(disc, 0.f))) / fmaxf(pp_k, FLT_MIN);

  const float alpha = c.rv / kappa;
  const float sk2_next = c.sk2 + 2.f * alpha * sp_k + alpha * alpha * pp_k;
  const bool boundary = in_kernel || (kappa <= 0.f) || (sk2_next > S.Delta2);

  const float cs = boundary ? sigma * sign : alpha;
  const float crr = boundary ? 0.f : alpha;
  const float m_new = boundary
      ? c.mval + sigma * sign * pr_k + 0.5f * sigma * sigma * kappa
      : c.mval - 0.5f * alpha * c.rv;
  // The carry advances here, before the pass, so that the old scalars
  // are not held in registers across it: after a boundary step the loop
  // exits and nothing reads these (only k, bnd, sk2, mval and the valid
  // flags, kept as the register kernel keeps them).
  c.nAp = c.nr - 2.f * beta * c.pa + beta * beta * c.nAp;
  c.rv_prev = c.rv;
  c.alpha_prev = alpha;
  c.pr_c = pr_k;
  c.kappa_prev = kappa;
  c.s_p = sp_k;
  c.pp_prev = pp_k;
  c.mval = m_new;
  c.rv = c.ar = c.nr = c.pa = 0.f;   // the pass's sums, unless a boundary

  // ---- the streamed pass: r/p (+ s when applying) in and out, x in, the
  // stored terms in (a weight twice), the generated ones regenerated; on
  // the first iteration r is g ----
  const T* rsrc = first ? g : r;
  const bool s_ok = c.s_valid != 0.f;
  const bool p_ok = c.p_valid != 0.f;
  float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;
  float* mine = S.acc + tid;   // this thread's column of the dot partials
  for (int j = 0; j < K; ++j) mine[(long long)j * kThreads] = 0.f;
  const Term* wts = S.terms + 1;
  for (long long gi = t0; gi < ngroups; gi += stride) {
    const long long i = gi * W;
    float rc[W], pc[W], xc[W], a0[W], pv[W];
    Store<T>::load(rsrc, i, P.n, rc);
    if (p_ok) Store<T>::load(p, i, P.n, pc);
    else for (int e = 0; e < W; ++e) pc[e] = 0.f;
    Store<T>::load(x, i, P.n, xc);
    term_group<W>(S.terms[0], S.aux0, i, P.n, a0);
    if (PK == kPrecNone) {
      for (int e = 0; e < W; ++e) pv[e] = 1.f;   // unread without P
    } else {
      prec_w<PK, W>(P, i, a0, pv);
      // r0 is ghat = p g, stored: the Pallas init pass writes it to r
      if (first)
        for (int e = 0; e < W; ++e) rc[e] = Store<T>::rounded(pv[e] * rc[e]);
#pragma unroll
      for (int e = 0; e < W; ++e) a0[e] = (pv[e] * pv[e]) * a0[e];
    }
    // p2 = -r + beta p; s and p are written now (nothing below reads them),
    // so only r, x, a0, p, a0 p2 and q2 stay live through the terms
    float a0p2[W], q2[W];
    {
      float p2[W];
#pragma unroll
      for (int e = 0; e < W; ++e) {
        p2[e] = first ? -rc[e] : -rc[e] + beta * pc[e];
        a0p2[e] = a0[e] * p2[e];
        q2[e] = a0p2[e];
      }
      if (APPLY) {
        // the s and p buffers hold garbage (possibly NaN) before their
        // first write, and 0 * NaN = NaN: select, don't scale
        float sc[W];
        if (s_ok) Store<T>::load(s, i, P.n, sc);
        else for (int e = 0; e < W; ++e) sc[e] = 0.f;
#pragma unroll
        for (int e = 0; e < W; ++e)
          sc[e] = sc[e] + (p_ok ? pend * pc[e] : 0.f) + cs * p2[e];
        Store<T>::store(s, i, P.n, sc);
      }
      Store<T>::store(p, i, P.n, p2);
    }
    for (int j = 0; j < K; ++j) {
      float u[W];
      weight_u<PK, W>(wts[j], S.aux0, i, P.n, xc, pv, u);
      const float cj = V.Bmpk()[j];
#pragma unroll
      for (int e = 0; e < W; ++e) q2[e] = q2[e] + cj * u[e];
    }
    float a0r2[W];
#pragma unroll
    for (int e = 0; e < W; ++e) {
      const float r2 = rc[e] + crr * q2[e];
      a0r2[e] = a0[e] * r2;
      acc0 += r2 * r2;
      acc1 += a0r2[e] * r2;
      acc2 += a0r2[e] * a0r2[e];
      acc3 += a0r2[e] * a0p2[e];
      rc[e] = r2;
    }
    Store<T>::store(r, i, P.n, rc);
    // u_j . (a0 r2): only x, p and a0 r2 stay live through the terms
    for (int j = 0; j < K; ++j) {
      float u[W];
      weight_u<PK, W>(wts[j], S.aux0, i, P.n, xc, pv, u);
      float t = mine[(long long)j * kThreads];
#pragma unroll
      for (int e = 0; e < W; ++e) t += u[e] * a0r2[e];
      mine[(long long)j * kThreads] = t;
    }
  }

  // the recurrences m, mB, mp (the pass reads none of them)
  for (int j = tid; j < K; j += blockDim.x) {
    V.m()[j] = V.m()[j] + crr * (V.mB2()[j] + V.UUBmpk()[j]);
    V.mB()[j] = V.mB2()[j];
    V.mp()[j] = V.mpk()[j];
  }

  if (!boundary) {
    // after a boundary step the loop exits: the dot group would be unused.
    // Block sums: the four scalars by warp shuffle, then the K dots from
    // the shared partials, a warp an entry; written entry-major.
    const int lane = tid & 31;
    const long long G = gridDim.x;
    const float a4[4] = {acc0, acc1, acc2, acc3};
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      double v = a4[a];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) S.red[warp * 4 + a] = v;
    }
    __syncthreads();
    if (tid < 4) {
      double v = 0.0;
      for (int w = 0; w < kWarps; ++w) v += S.red[w * 4 + tid];
      S.part[tid * G + blockIdx.x] = v;
    }
    for (int j = warp; j < K; j += kWarps) {
      const float* col = S.acc + (long long)j * kThreads;
      double v = 0.0;
      for (int t = lane; t < kThreads; t += 32) v += col[t];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) S.part[(4 + j) * G + blockIdx.x] = v;
    }
    grid_sum(grid, S.part, S.tot, 4 + K, nullptr, K);
    c.rv = (float)S.tot[0];
    c.ar = (float)S.tot[1];
    c.nr = (float)S.tot[2];
    c.pa = (float)S.tot[3];
    for (int j = tid; j < K; j += blockDim.x) V.mA()[j] = (float)S.tot[4 + j];
    c.sk2 = sk2_next;
    c.k += 1;
  } else {
    c.done = 1.f;
    c.bnd = 1.f;
  }
  if (APPLY) c.s_valid = 1.f;
  c.p_valid = 1.f;
  __syncthreads();
  return APPLY ? 0.f : cs;
}

// Two blocks an SM at f32 (128 registers, no spill on an H100); bf16's
// group of W = 8 elements needs more and keeps one block, as the register
// kernel's bf16 K = 3, 4 do.
template <typename T, int PK>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 2 : 1)
    streamed_cg_any_kernel(AnyParams P) {
  constexpr int W = Store<T>::W;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ double red[kWarps * 4];
  __shared__ float dots[kWarps];
  cg::grid_group grid = cg::this_grid();
  const Layout& L = P.L;
  const int K = P.k;
  const int tid = threadIdx.x;
  const Scratch X = scratch_of(K, P.with_init, gridDim.x, L);
  unsigned char* slice = P.scratch + X.blocks + blockIdx.x * L.block_bytes;

  Block S;
  S.K = K;
  S.red = red;
  S.dots = dots;
  S.part = reinterpret_cast<double*>(P.scratch);
  S.tot = reinterpret_cast<double*>(P.scratch + X.tot);
  if (L.terms_smem) {
    Term* t = reinterpret_cast<Term*>(smem + L.terms_off);
    for (int j = tid; j <= K; j += blockDim.x) t[j] = P.terms[j];
    S.terms = t;
  } else {
    S.terms = P.terms;
  }
  S.v.base = reinterpret_cast<float*>(
      (L.vecs_smem ? smem : slice) + L.vecs_off);
  S.v.K = K;
  S.acc = reinterpret_cast<float*>((L.acc_smem ? smem : slice) + L.acc_off);
  float* tile = reinterpret_cast<float*>(
      (L.tile_smem ? smem : slice) + L.tile_off);
  __syncthreads();

  const float Delta = P.scal[0];
  S.Delta2 = Delta * Delta;
  S.aux0 = P.n_aux > 0 ? P.scal[1] : 0.f;
  S.eps2 = P.epsilon * P.epsilon;

  const T* g = static_cast<const T*>(P.g);
  const T* x = static_cast<const T*>(P.x);
  const long long ngroups = (P.n + W - 1) / W;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t0 = (long long)blockIdx.x * blockDim.x + tid;

  // rv0, ar0, nr0; m0, mA0 into the K-vectors; U'U's source
  float rv0, ar0, nr0;
  const float* uu_src;
  if (P.with_init) {
    const float* iv = P.scal + 1 + P.n_aux;
    rv0 = iv[0];
    ar0 = iv[1];
    nr0 = iv[2];
    for (int j = tid; j < K; j += blockDim.x) {
      S.v.m()[j] = iv[3 + j];
      S.v.mA()[j] = iv[3 + K + j];
    }
    uu_src = iv + 3 + 2 * K;   // K x K row-major, symmetric
  } else {
    // the init pass: V = (g, a0 g, u_1..K) a tile at a time, one read of g
    // and x (and the stored terms); r is not written (the first iteration
    // reads g in its place); with a preconditioner g is ghat = p g
    const int R = K + 2;
    const long long N = init_pairs(K);
    const long long G = gridDim.x;
    double* part = S.part;
    for (long long q = tid; q < N; q += kThreads) part[q * G + blockIdx.x] = 0.0;
    // this thread's first pair (a, b) of the row-major upper triangle
    int a_first = 0;
    long long b_first = tid;
    while (a_first < R && b_first >= R) {
      ++a_first;
      b_first = b_first - R + a_first;
    }
    for (long long base = (long long)blockIdx.x * kTile; base < P.n;
         base += G * kTile) {
      float* row = tile + (long long)tid * L.stride;
      const long long i = base + tid;
      if (i < P.n) {
        const float a0 = term_at(S.terms[0], S.aux0, i);
        const float pe = PK != kPrecNone ? prec_of(PK, P, a0, i) : 1.f;
        const float gi = Store<T>::get(g, i);
        const float gc = PK != kPrecNone ? pe * gi : gi;
        const float a0f = PK != kPrecNone ? (pe * pe) * a0 : a0;
        const float xi = Store<T>::get(x, i);
        row[0] = gc;
        row[1] = a0f * gc;
        for (int j = 0; j < K; ++j) {
          const Term& t = S.terms[1 + j];
          float u;
          if (t.mode == kTermOne) {
            u = PK == kPrecNone ? xi : pe * xi;
          } else {
            const float w = term_at(t, S.aux0, i);
            u = PK == kPrecNone ? w * xi : (pe * w) * xi;
          }
          row[2 + j] = u;
        }
      } else {
        for (int j = 0; j < R; ++j) row[j] = 0.f;
      }
      __syncthreads();
      int a = a_first;
      long long b = b_first;
      for (long long q = tid; q < N; q += kThreads) {
        float t = 0.f;
        for (int e = 0; e < kTile; ++e)
          t = t + tile[(long long)e * L.stride + a] *
                      tile[(long long)e * L.stride + b];
        part[q * G + blockIdx.x] += (double)t;
        b += kThreads;
        while (a < R && b >= R) {   // past the last row: q >= N, loop ends
          ++a;
          b = b - R + a;
        }
      }
      __syncthreads();
    }
    float* uu = reinterpret_cast<float*>(P.scratch + X.uu);
    grid_sum(grid, part, S.tot, N, uu, K);
    rv0 = (float)S.tot[0];
    ar0 = (float)S.tot[1];
    nr0 = (float)S.tot[R];
    for (int j = tid; j < K; j += blockDim.x) {
      S.v.m()[j] = (float)S.tot[2 + j];
      S.v.mA()[j] = (float)S.tot[R + 1 + j];
    }
    uu_src = uu;
  }
  // B' and U'U: copied into shared memory below the line, read in place
  // above it
  if (L.mats_smem) {
    float* bt = reinterpret_cast<float*>(smem + L.mats_off);
    float* uu = bt + (long long)K * K;
    for (long long q = tid; q < (long long)K * K; q += blockDim.x) {
      bt[q] = P.Bt[q];
      uu[q] = uu_src[q];
    }
    S.Bt = bt;
    S.UU = uu;
  } else {
    S.Bt = P.Bt;
    S.UU = uu_src;
  }
  for (int j = tid; j < K; j += blockDim.x) {
    S.v.mB()[j] = 0.f;
    S.v.mp()[j] = 0.f;
  }
  __syncthreads();

  const float r0n = sqrtf(rv0);
  S.target = r0n * fminf(P.kappa_fgr, pow_static(r0n, P.theta));

  Carry c;
  c.k = 0;
  c.rv = rv0;
  c.ar = ar0;
  c.nr = nr0;
  c.pa = c.nAp = c.rv_prev = 0.f;
  c.alpha_prev = 1.f;
  c.pr_c = 0.f;
  c.kappa_prev = 1.f;
  c.s_p = c.sk2 = c.pp_prev = c.mval = 0.f;
  c.done = c.bnd = c.s_valid = c.p_valid = 0.f;

  // The loop condition reads only carried scalars, bitwise equal in every
  // thread: every block takes the same number of trips through grid.sync().
  while (c.k < P.max_iterations && c.done == 0.f && sqrtf(c.rv) > S.target) {
    if (P.pair) {
      const float pend = half<T, PK, false>(grid, P, S, c, 0.f);
      half<T, PK, true>(grid, P, S, c, pend);
    } else {
      half<T, PK, true>(grid, P, S, c, 0.f);
    }
  }

  T* s = static_cast<T*>(P.s);
  if (c.s_valid == 0.f) {
    // no CG step was taken (g = 0, or max_iterations = 0): s = 0
    const float z[W] = {};
    for (long long gi = t0; gi < ngroups; gi += stride)
      Store<T>::store(s, gi * W, P.n, z);
  } else if (PK != kPrecNone) {
    // un-transform s = p shat; each thread rewrites the elements it wrote
    // in the loop (the same grid-stride walk), so no grid.sync is needed
    for (long long gi = t0; gi < ngroups; gi += stride) {
      const long long i = gi * W;
      float sc[W], a0[W], pr[W];
      Store<T>::load(s, i, P.n, sc);
      if (PK == kPrecJacobi) term_group<W>(S.terms[0], S.aux0, i, P.n, a0);
      prec_w<PK, W>(P, i, a0, pr);
      for (int e = 0; e < W; ++e) sc[e] = sc[e] * pr[e];
      Store<T>::store(s, i, P.n, sc);
    }
  }
  if (blockIdx.x == 0 && tid == 0) {
    P.res[0] = (float)c.k;
    P.res[1] = c.bnd;
    P.res[2] = c.sk2;
    P.res[3] = c.mval;
  }
}

template <typename T>
const void* kernel_for(int prec_kind) {
  switch (prec_kind) {
    case kPrecJacobi: return (const void*)streamed_cg_any_kernel<T, kPrecJacobi>;
    case kPrecStored: return (const void*)streamed_cg_any_kernel<T, kPrecStored>;
    default: return (const void*)streamed_cg_any_kernel<T, kPrecNone>;
  }
}

const void* kernel_of(int bf16, int prec_kind) {
  return bf16 ? kernel_for<__nv_bfloat16>(prec_kind)
              : kernel_for<float>(prec_kind);
}

// The instance's layout on this card (its shared memory budget: the opt-in
// maximum a block less the kernel's static shared memory), with the
// dynamic shared memory allowed to the function.
cudaError_t layout_of(const void* fn, int k, int with_init, Layout* L) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return e;
  *L = plan(k, with_init, (long long)optin - (long long)attr.sharedSizeBytes);
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)L->smem_bytes);
}

}  // namespace

extern "C" {

// Number of blocks the launch for n elements uses (co-resident at most, for
// this instance's registers and shared memory) and the bytes of global
// scratch it needs.  prec_kind: 0 none, 1 the generated shifted-Jacobi
// power, 2 stored p.
int streamed_cg_any_grid(int bf16, int prec_kind, int k, int with_init,
                         long long n, int* grid, long long* scratch_bytes) {
  if (k < 1) return (int)cudaErrorInvalidValue;
  const void* fn = kernel_of(bf16, prec_kind);
  Layout L;
  cudaError_t e = layout_of(fn, k, with_init, &L);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                    (size_t)L.smem_bytes);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int cap = per_sm * sms;
  const int w = bf16 ? Store<__nv_bfloat16>::W : Store<float>::W;
  const long long groups = (n + w - 1) / w;
  long long want = (groups + kThreads - 1) / kThreads;
  if (want < 1) want = 1;
  *grid = (int)(want < cap ? want : cap);
  *scratch_bytes = scratch_of(k, with_init, *grid, L).bytes;
  return (int)cudaSuccess;
}

// The layout's placements for rank k (a report: 1 = shared memory): terms,
// K-vectors, dot partials, B' and U'U, init tile, and the dynamic shared
// memory in bytes.
int streamed_cg_any_layout(int bf16, int prec_kind, int k, int with_init,
                           long long* out) {
  if (k < 1) return (int)cudaErrorInvalidValue;
  Layout L;
  cudaError_t e = layout_of(kernel_of(bf16, prec_kind), k, with_init, &L);
  if (e != cudaSuccess) return (int)e;
  out[0] = L.terms_smem;
  out[1] = L.vecs_smem;
  out[2] = L.acc_smem;
  out[3] = L.mats_smem;
  out[4] = L.tile_smem;
  out[5] = L.smem_bytes;
  return (int)cudaSuccess;
}

const char* streamed_cg_any_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launch one subproblem on `stream`.  `terms` is a device array of k + 1
// Terms (a0, then the k weights); `Bt` is B' (k x k row-major); `scratch`
// holds streamed_cg_any_grid's bytes.  Returns a cudaError_t code: the
// cooperative launch's own refusal, or cudaGetLastError() after it.
int streamed_cg_any_launch(int bf16, int prec_kind, int k, const void* g,
                           const void* x, const void* terms, void* s, void* r,
                           void* p, const float* scal, int n_aux,
                           const float* Bt, float* res, void* scratch,
                           int grid, long long n, int max_iterations,
                           float kappa_fgr, float theta, float epsilon,
                           int pair, int with_init, const float* prec,
                           float prec_c, int prec_quarter, void* stream) {
  if (k < 1) return (int)cudaErrorInvalidValue;
  const void* fn = kernel_of(bf16, prec_kind);
  AnyParams P;
  cudaError_t e = layout_of(fn, k, with_init, &P.L);
  if (e != cudaSuccess) return (int)e;
  P.g = g;
  P.x = x;
  // (a pointer to the namespace-local Term in this extern "C" signature
  // would take the symbol out of the library's exports)
  P.terms = static_cast<const Term*>(terms);
  P.k = k;
  P.prec = prec;
  P.prec_c = prec_c;
  P.prec_quarter = prec_quarter;
  P.s = s;
  P.r = r;
  P.p = p;
  P.scal = scal;
  P.n_aux = n_aux;
  P.Bt = Bt;
  P.res = res;
  P.scratch = static_cast<unsigned char*>(scratch);
  P.n = n;
  P.max_iterations = max_iterations;
  P.kappa_fgr = kappa_fgr;
  P.theta = theta;
  P.epsilon = epsilon;
  P.pair = pair;
  P.with_init = with_init;
  void* args[] = {&P};
  e = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kThreads), args,
                                  (size_t)P.L.smem_bytes,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
