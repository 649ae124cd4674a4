// Whole-loop streamed trust-region CG for the H100 (sm_90a): the register
// instantiations, K = 1-4.
//
// Replaces optimization_tpu/kernels/streamed_cg.py:_mk_kernel (the Pallas
// TPU kernel behind stpcg_flat_streamed).  One launch solves one
// Steihaug-Toint trust-region subproblem  min <g,s> + 1/2 <s,Hs>, |s| <= Delta
// for H = A0 + U B U' of rank K = 1-4 (a template parameter), with
//
//   A0    = diag(a0),   U = (w_1 .* x, ..., w_K .* x),   B any K x K,
//
// a0 and each w_j one per-element term t(i) (csrc/streamed_cg.cuh):
//   - the weight 1 (u_j = x; weights only);
//   - c + b * i, regenerated in registers (f32, no fused multiply-add);
//   - a stored f32 vector, read once a pass (16-byte loads);
// each taken as t, 2t (the JAX package's ScaledDiagonal) or 2t - aux0 (its
// ShiftedDiagonal).  The sphere Rayleigh family is K = 2 with a0 = 2a - aux0,
// U = (x, 2a .* x): the same arithmetic, in the same order, as the kernel
// that took that family alone.  K >= 5 runs csrc/streamed_cg_any.cu, which
// keeps the K-sized state in shared memory; this file holds it in registers
// (K weight values for each of the W elements of a 16-byte load, the
// K-vector carry and two K x K matrices), which stops paying at K = 3-4.
//
// The loop follows the Chronopoulos-Gear recurrences of the Pallas kernel:
// one fused pass over r, p, x (+ s on applying halves) and ONE grid-wide
// reduction per CG iteration, the pair-deferred s update, the boundary
// sigma-step, the kernel-of-H escape with descent alignment, and the
// truncation target |r_k| <= |r_0| min(kappa, |r_0|^theta).  The K-vector
// recurrences (m, mA, mB, mp) and the K x K products are loops over K
// (:342-345, :411-415); the half's reduction group is 4 + K wide (rv, ar,
// nr, pa, mA[K]) and the init pass's 3 + 2K + K(K+1)/2 (rv, ar, nr, m[K],
// mA[K], the upper triangle of U'U; :206-256), 21 at K = 4.
//
// Optional elementwise preconditioner P = M^(-1/2) (the Pallas kernel's
// prec_chunk folding, :110-138 and :206-209): the symmetric change of
// variables s = P shat runs in registers -- ghat = p g in the init pass,
// A0hat = p^2 a0, uhat_j = (p w_j) x in every pass -- so the trust region
// and the reported step norm are |s|_M and the truncation runs in
// |r|_(M^-1).  p is either the shifted-Jacobi power (|a0| + c)^(-1/2) or
// ^(-1/4) on A0's own diagonal, regenerated in registers (no bytes;
// round-to-nearest __frsqrt_rn / __fsqrt_rn, the quarter power as
// rsqrt(sqrt(d)) as the JAX package computes it), or a stored f32 vector
// (one more read per pass).  The kernel un-transforms its own output,
// s = p shat, in a tail pass over s (2n words, no extra launch).
//
// What bounds it: device-memory bytes.  Per CG iteration the pair body
// moves 5n words on deferring halves (read r, p, x; write r, p) and 7n on
// applying halves (+ read and write s), 6n on average: about 0.4 GB per
// iteration at f32 and n = 2^24, against a few hundred flops per element.
// Each stored term (a0, a weight, P) adds n f32 words a pass; a regenerated
// one adds none.  The design answers that by touching each vector once per
// iteration (q = Hp and the U columns are recomputed in registers, the
// generated terms regenerated, never read), 16-byte vector loads, and
// keeping the whole CG loop inside one persistent cooperative launch, so no
// host round trip or kernel boundary sits between iterations.  A generated
// preconditioner adds no bytes (plus 2n for the un-transform tail, once per
// subproblem); a stored one adds n words per pass.
//
// Structure: a persistent cooperative grid (co-resident blocks only) walks
// the vectors with grid-stride loops.  Each half reduces its per-thread f32
// partials by warp shuffle and per block, writes the block partials to a
// scratch buffer (double-buffered by parity), and crosses one grid.sync().
// Every block then sums all block partials in the same fixed order, in
// double, so every thread of every block holds bitwise identical scalars,
// advances the scalar recurrence redundantly, and takes the same loop exit.
// No atomics: two runs on the same card are bitwise equal.
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
constexpr int kUnrolledK = 4;   // the ranks instantiated here

// Reduction widths: the init pass (rv, ar, nr, m[K], mA[K], UU upper) and a
// half (rv, ar, nr, pa, mA[K]); the scratch holds the wider per block.
__host__ __device__ constexpr int init_width(int K) {
  return 3 + 2 * K + K * (K + 1) / 2;
}
__host__ __device__ constexpr int nacc(int K) {
  return init_width(K) > 4 + K ? init_width(K) : 4 + K;
}

struct Params {
  const void* g;
  const void* x;
  Term a0;
  Term w[kUnrolledK];
  const float* prec;     // stored p (kPrecStored)
  float prec_c;          // c of the generated p
  int prec_quarter;      // e = 1/4 (else e = 1/2)
  void* s;
  void* r;
  void* p;
  const float* scal;     // Delta, aux[n_aux], threaded init group
  int n_aux;
  const float* B;        // K x K, row-major
  float* res;            // k, boundary, |s|^2, model value
  double* partial;       // [2][gridDim.x][nacc(K)]
  long long n;
  int max_iterations;
  float kappa_fgr;
  float theta;
  float epsilon;
  int pair;
  int with_init;
};

// The preconditioner's diagonal p(i) for W consecutive indices, from the
// group's (unfolded) a0 (kPrecJacobi) or read from the stored vector; 0 past
// n, so a masked element never meets rsqrt(0).
template <int PK, int W>
__device__ __forceinline__ void prec_group(const Params& P, long long i,
                                           const float (&a0)[W],
                                           float (&p)[W]) {
  if (PK == kPrecStored) {
    load_f32<W>(P.prec, i, P.n, p);
  } else {
#pragma unroll
    for (int e = 0; e < W; ++e) {
      const float d = __fadd_rn(fabsf(a0[e]), P.prec_c);
      p[e] = P.prec_quarter ? __frsqrt_rn(__fsqrt_rn(d)) : __frsqrt_rn(d);
      if (i + e >= P.n) p[e] = 0.f;
    }
  }
}

// The operator's terms for one group of W elements: a0 and the K weight
// values (unfolded; a weight of mode kTermOne is not evaluated), and p.
// SPHERE (K = 2) fixes the layout at compile time -- a0 = 2t - aux0 and the
// weights 1 and 2t on a0's own term t, evaluated once -- so that the sphere
// family runs the instructions of the kernel that took that family alone;
// otherwise each slot's mode and form are read from Params.
template <int PK, int K, int W, bool SPHERE>
struct Group {
  static_assert(!SPHERE || K == 2, "the sphere layout is rank 2");
  float a0[W], w[K][W], p[W];

  __device__ __forceinline__ static bool one(const Params& P, int j) {
    return SPHERE ? j == 0 : P.w[j].mode == kTermOne;
  }

  __device__ __forceinline__ void eval(const Params& P, float aux0,
                                       long long i) {
    float base[W];
    term_base<W>(P.a0, i, P.n, base);
    term_form<W>(SPHERE ? kFormShift : P.a0.form, aux0, base, a0);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (SPHERE && j == 1) term_form<W>(kFormTwice, aux0, base, w[j]);
      else if (!one(P, j)) term_group<W>(P.w[j], aux0, i, P.n, w[j]);
    }
    if (PK != kPrecNone) prec_group<PK, W>(P, i, a0, p);
  }

  // The folded operator at element e: a0hat = p^2 a0 and u_j = (p w_j) x (or
  // p x for the weight 1), or a0 and u_j = w_j x without a preconditioner
  // (the Pallas kernel's multiplication order).
  __device__ __forceinline__ float fold(const Params& P, int e, float x,
                                        float (&u)[K]) const {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (PK == kPrecNone) u[j] = one(P, j) ? x : w[j][e] * x;
      else u[j] = one(P, j) ? p[e] * x : (p[e] * w[j][e]) * x;
    }
    return PK == kPrecNone ? a0[e] : (p[e] * p[e]) * a0[e];
  }
};

template <int K>
__device__ __forceinline__ float kdot(const float (&a)[K], const float (&b)[K]) {
  float t = a[0] * b[0];
#pragma unroll
  for (int j = 1; j < K; ++j) t = t + a[j] * b[j];
  return t;
}

template <int K>
__device__ __forceinline__ void matk(const float (&M)[K][K], const float (&v)[K],
                                     float (&out)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) out[i] = kdot<K>(M[i], v);
}

// Block + grid reduction of NACC per-thread partials (NACC <= STRIDE, the
// per-block stride of the scratch).  Writes this block's sums into
// partial[par], crosses one grid.sync(), and returns in `out` the grid
// totals, summed by every block in one fixed order.
template <int STRIDE>
struct Reducer {
  double (*red)[STRIDE];  // shared [kWarps][STRIDE]
  double* tot;            // shared [STRIDE]

  template <int NACC>
  __device__ void run(cg::grid_group& grid, const Params& P, int par,
                      const float (&acc)[NACC], float (&out)[NACC]) const {
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
    double* part = P.partial + (size_t)par * gridDim.x * STRIDE;
    if (threadIdx.x < NACC) {
      double v = 0.0;
      for (int w = 0; w < kWarps; ++w) v += red[w][threadIdx.x];
      part[(size_t)blockIdx.x * STRIDE + threadIdx.x] = v;
    }
    grid.sync();
    for (int a = warp; a < NACC; a += kWarps) {
      double v = 0.0;
      for (unsigned b = lane; b < gridDim.x; b += 32) v += part[(size_t)b * STRIDE + a];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) tot[a] = v;
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < NACC; ++a) out[a] = (float)tot[a];
  }
};

// The carried scalar state of the CG loop (the Pallas kernel's carry,
// optimization_tpu/kernels/streamed_cg.py:329-331), identical in every
// thread.
template <int K>
struct Carry {
  int k;
  float rv, ar, nr, pa, nAp, rv_prev, alpha_prev, pr_c, kappa_prev;
  float s_p, sk2, pp_prev, mval, done, bnd, s_valid, p_valid;
  float m[K], mA[K], mB[K], mp[K];
};

template <int K>
struct Consts {
  float Delta2, aux0, eps2, target;
  float B[K][K], UU[K][K];
};

// One CG iteration (the Pallas kernel's half(), :354-501).  APPLY folds
// the pending coefficient `pend` into this half's s update; otherwise the
// half returns its own s coefficient for the next half.
template <typename T, int PK, int K, bool SPHERE, bool APPLY>
__device__ float half(cg::grid_group& grid, const Params& P,
                      const Consts<K>& C, const Reducer<nacc(K)>& R,
                      Carry<K>& c, int& par, float pend) {
  constexpr int W = Store<T>::W;
  const T* g = static_cast<const T*>(P.g);
  const T* x = static_cast<const T*>(P.x);
  T* s = static_cast<T*>(P.s);
  T* r = static_cast<T*>(P.r);
  T* p = static_cast<T*>(P.p);
  const long long ngroups = (P.n + W - 1) / W;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;

  const bool frozen = (c.done != 0.f) || (c.k >= P.max_iterations) ||
                      (sqrtf(c.rv) <= C.target);
  if (frozen) {
    // Only reachable as the second half of a pair: the loop exits after it,
    // so only s changes (cs = 0 there): s <- s + pend * p.
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

  float Bm[K];
  matk<K>(C.B, c.m, Bm);
  const float wr = c.ar + kdot<K>(c.m, Bm);
  const float kappa = wr - (beta / c.alpha_prev) * c.rv;
  const float pp_k = c.rv + beta * beta * c.pp_prev;
  const float pr_k = -c.rv + beta * (c.pr_c + c.alpha_prev * c.kappa_prev);
  const float sp_k = beta * (c.s_p + c.alpha_prev * c.pp_prev);

  // kernel-of-H safeguard via the |q|^2 recurrence
  float Bmp[K], UUBm[K], UUBmp[K];
  matk<K>(C.B, c.mp, Bmp);
  matk<K>(C.UU, Bm, UUBm);
  matk<K>(C.UU, Bmp, UUBmp);
  const float ww = c.nr + 2.f * kdot<K>(c.mA, Bm) + kdot<K>(Bm, UUBm);
  const float wq = c.pa + kdot<K>(c.mA, Bmp) + kdot<K>(Bm, c.mB) +
                   kdot<K>(Bm, UUBmp);
  const float qq_prev = c.nAp + 2.f * kdot<K>(c.mB, Bmp) + kdot<K>(Bmp, UUBmp);
  const float qq_k = ww - 2.f * beta * wq + beta * beta * qq_prev;
  const bool in_kernel = qq_k < C.eps2 * pp_k;
  const float sign = (in_kernel && pr_k > 0.f) ? -1.f : 1.f;

  const float sp_eff = sign * sp_k;
  const float disc = sp_eff * sp_eff + pp_k * (C.Delta2 - c.sk2);
  const float sigma = (-sp_eff + sqrtf(fmaxf(disc, 0.f))) / fmaxf(pp_k, FLT_MIN);

  const float alpha = c.rv / kappa;
  const float sk2_next = c.sk2 + 2.f * alpha * sp_k + alpha * alpha * pp_k;
  const bool boundary = in_kernel || (kappa <= 0.f) || (sk2_next > C.Delta2);

  const float cs = boundary ? sigma * sign : alpha;
  const float crr = boundary ? 0.f : alpha;
  const float m_new = boundary
      ? c.mval + sigma * sign * pr_k + 0.5f * sigma * sigma * kappa
      : c.mval - 0.5f * alpha * c.rv;

  float mp_k[K], mB2[K], Bmpk[K], UUBmpk[K], m2[K];
#pragma unroll
  for (int j = 0; j < K; ++j) mp_k[j] = -c.m[j] + beta * c.mp[j];
#pragma unroll
  for (int j = 0; j < K; ++j) mB2[j] = -c.mA[j] + beta * c.mB[j];
  matk<K>(C.B, mp_k, Bmpk);
  matk<K>(C.UU, Bmpk, UUBmpk);
#pragma unroll
  for (int j = 0; j < K; ++j) m2[j] = c.m[j] + crr * (mB2[j] + UUBmpk[j]);
  const float nAp2 = c.nr - 2.f * beta * c.pa + beta * beta * c.nAp;

  // ---- the streamed pass: r/p (+ s when applying) in and out, x in, the
  // stored terms in, the generated ones regenerated; on the first
  // iteration r is g ----
  const T* rsrc = first ? g : r;
  const bool s_ok = c.s_valid != 0.f;
  const bool p_ok = c.p_valid != 0.f;
  float acc[4 + K];
#pragma unroll
  for (int j = 0; j < 4 + K; ++j) acc[j] = 0.f;
  for (long long gi = t0; gi < ngroups; gi += stride) {
    const long long i = gi * W;
    float rc[W], pc[W], xc[W];
    Store<T>::load(rsrc, i, P.n, rc);
    if (p_ok) Store<T>::load(p, i, P.n, pc);
    else for (int e = 0; e < W; ++e) pc[e] = 0.f;
    Store<T>::load(x, i, P.n, xc);
    Group<PK, K, W, SPHERE> G;
    G.eval(P, C.aux0, i);
    // r0 is ghat = p g, stored: the Pallas init pass writes it to r
    if (PK != kPrecNone && first)
      for (int e = 0; e < W; ++e) rc[e] = Store<T>::rounded(G.p[e] * rc[e]);
    float r2v[W], p2v[W];
#pragma unroll
    for (int e = 0; e < W; ++e) {
      float u[K];
      const float a0 = G.fold(P, e, xc[e], u);
      const float p2 = first ? -rc[e] : -rc[e] + beta * pc[e];
      float q2 = a0 * p2;
#pragma unroll
      for (int j = 0; j < K; ++j) q2 = q2 + Bmpk[j] * u[j];
      const float r2 = rc[e] + crr * q2;
      const float a0r2 = a0 * r2;
      const float a0p2 = a0 * p2;
      acc[0] += r2 * r2;
      acc[1] += a0r2 * r2;
      acc[2] += a0r2 * a0r2;
      acc[3] += a0r2 * a0p2;
#pragma unroll
      for (int j = 0; j < K; ++j) acc[4 + j] += u[j] * a0r2;
      r2v[e] = r2;
      p2v[e] = p2;
    }
    if (APPLY) {
      // the s and p buffers hold garbage (possibly NaN) before their first
      // write, and 0 * NaN = NaN: select, don't scale
      float sc[W];
      if (s_ok) Store<T>::load(s, i, P.n, sc);
      else for (int e = 0; e < W; ++e) sc[e] = 0.f;
#pragma unroll
      for (int e = 0; e < W; ++e)
        sc[e] = sc[e] + (p_ok ? pend * pc[e] : 0.f) + cs * p2v[e];
      Store<T>::store(s, i, P.n, sc);
    }
    Store<T>::store(r, i, P.n, r2v);
    Store<T>::store(p, i, P.n, p2v);
  }

  if (!boundary) {
    // after a boundary step the loop exits: the dot group would be unused
    float tot[4 + K];
    R.run(grid, P, par, acc, tot);
    par ^= 1;
    const float rv_old = c.rv;
    c.rv = tot[0];
    c.ar = tot[1];
    c.nr = tot[2];
    c.pa = tot[3];
#pragma unroll
    for (int j = 0; j < K; ++j) c.mA[j] = tot[4 + j];
    c.nAp = nAp2;
    c.rv_prev = rv_old;
    c.alpha_prev = alpha;
    c.pr_c = pr_k;
    c.kappa_prev = kappa;
    c.s_p = sp_k;
    c.sk2 = sk2_next;
    c.pp_prev = pp_k;
    c.k += 1;
  } else {
    c.done = 1.f;
    c.bnd = 1.f;
  }
  c.mval = m_new;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    c.m[j] = m2[j];
    c.mB[j] = mB2[j];
    c.mp[j] = mp_k[j];
  }
  if (APPLY) c.s_valid = 1.f;
  c.p_valid = 1.f;
  return APPLY ? 0.f : cs;
}

// Two blocks an SM (at most 128 registers a thread, as the sphere kernel
// always had): at f32, K = 3 and 4 spill 56-444 bytes a thread for it and
// still run 19-22% faster on an H100 than at one block an SM (190-230
// registers, 8 warps an SM).  bf16 at K = 3, 4 would spill 1.2-2.6 KB and keeps one block.
template <typename T, int PK, int K, bool SPHERE>
__global__ void __launch_bounds__(kThreads,
                                  (sizeof(T) == 4 || K <= 2) ? 2 : 1)
    streamed_cg_kernel(Params P) {
  constexpr int W = Store<T>::W;
  constexpr int NI = init_width(K);
  cg::grid_group grid = cg::this_grid();
  __shared__ double red[kWarps][nacc(K)];
  __shared__ double tot[nacc(K)];
  const Reducer<nacc(K)> R{red, tot};

  Consts<K> C;
  const float Delta = P.scal[0];
  C.Delta2 = Delta * Delta;
  C.aux0 = P.n_aux > 0 ? P.scal[1] : 0.f;
#pragma unroll
  for (int a = 0; a < K; ++a)
#pragma unroll
    for (int b = 0; b < K; ++b) C.B[a][b] = P.B[a * K + b];
  C.eps2 = P.epsilon * P.epsilon;

  const T* g = static_cast<const T*>(P.g);
  const T* x = static_cast<const T*>(P.x);
  const long long ngroups = (P.n + W - 1) / W;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;

  int par = 0;
  // rv0, ar0, nr0, m0[K], mA0[K], then UU: the upper triangle row by row
  // (init pass) or the threaded K x K row-major (scal after Delta and aux)
  float init[3 + 2 * K];
  if (P.with_init) {
    const float* iv = P.scal + 1 + P.n_aux;
#pragma unroll
    for (int j = 0; j < 3 + 2 * K; ++j) init[j] = iv[j];
#pragma unroll
    for (int a = 0; a < K; ++a)
#pragma unroll
      for (int b = 0; b < K; ++b) C.UU[a][b] = iv[3 + 2 * K + a * K + b];
  } else {
    // the init pass: one read of g and x (and the stored terms); r is not
    // written (the first iteration reads g in its place); with a
    // preconditioner g is ghat = p g
    float acc[NI], out[NI];
#pragma unroll
    for (int j = 0; j < NI; ++j) acc[j] = 0.f;
    for (long long gi = t0; gi < ngroups; gi += stride) {
      const long long i = gi * W;
      float gc[W], xc[W];
      Store<T>::load(g, i, P.n, gc);
      Store<T>::load(x, i, P.n, xc);
      Group<PK, K, W, SPHERE> G;
      G.eval(P, C.aux0, i);
      if (PK != kPrecNone)
        for (int e = 0; e < W; ++e) gc[e] = G.p[e] * gc[e];
#pragma unroll
      for (int e = 0; e < W; ++e) {
        float u[K];
        const float a0 = G.fold(P, e, xc[e], u);
        const float a0g = a0 * gc[e];
        acc[0] += gc[e] * gc[e];
        acc[1] += a0g * gc[e];
        acc[2] += a0g * a0g;
#pragma unroll
        for (int j = 0; j < K; ++j) acc[3 + j] += u[j] * gc[e];
#pragma unroll
        for (int j = 0; j < K; ++j) acc[3 + K + j] += u[j] * a0g;
        int t = 3 + 2 * K;
#pragma unroll
        for (int a = 0; a < K; ++a)
#pragma unroll
          for (int b = a; b < K; ++b) acc[t++] += u[a] * u[b];
      }
    }
    R.run(grid, P, par, acc, out);
    par ^= 1;
#pragma unroll
    for (int j = 0; j < 3 + 2 * K; ++j) init[j] = out[j];
    int t = 3 + 2 * K;
#pragma unroll
    for (int a = 0; a < K; ++a)
#pragma unroll
      for (int b = a; b < K; ++b) {
        C.UU[a][b] = out[t];
        C.UU[b][a] = out[t];
        ++t;
      }
  }

  const float r0n = sqrtf(init[0]);
  C.target = r0n * fminf(P.kappa_fgr, pow_static(r0n, P.theta));

  Carry<K> c;
  c.k = 0;
  c.rv = init[0];
  c.ar = init[1];
  c.nr = init[2];
  c.pa = c.nAp = c.rv_prev = 0.f;
  c.alpha_prev = 1.f;
  c.pr_c = 0.f;
  c.kappa_prev = 1.f;
  c.s_p = c.sk2 = c.pp_prev = c.mval = 0.f;
  c.done = c.bnd = c.s_valid = c.p_valid = 0.f;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    c.m[j] = init[3 + j];
    c.mA[j] = init[3 + K + j];
    c.mB[j] = 0.f;
    c.mp[j] = 0.f;
  }

  // The loop condition (the Pallas kernel's cond, :348-352) reads only
  // carried scalars, which are bitwise equal in every thread: every block
  // takes the same number of trips through grid.sync().
  while (c.k < P.max_iterations && c.done == 0.f && sqrtf(c.rv) > C.target) {
    if (P.pair) {
      const float pend =
          half<T, PK, K, SPHERE, false>(grid, P, C, R, c, par, 0.f);
      half<T, PK, K, SPHERE, true>(grid, P, C, R, c, par, pend);
    } else {
      half<T, PK, K, SPHERE, true>(grid, P, C, R, c, par, 0.f);
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
      if (PK == kPrecJacobi) term_group<W>(P.a0, C.aux0, i, P.n, a0);
      prec_group<PK, W>(P, i, a0, pr);
      for (int e = 0; e < W; ++e) sc[e] = sc[e] * pr[e];
      Store<T>::store(s, i, P.n, sc);
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    P.res[0] = (float)c.k;
    P.res[1] = c.bnd;
    P.res[2] = c.sk2;
    P.res[3] = c.mval;
  }
}

// The kernel instance for a storage dtype, preconditioner form, rank and
// layout (sphere: K = 2 only).
template <typename T, int K, bool SPHERE>
const void* kernel_for_k(int prec_kind) {
  switch (prec_kind) {
    case kPrecJacobi:
      return (const void*)streamed_cg_kernel<T, kPrecJacobi, K, SPHERE>;
    case kPrecStored:
      return (const void*)streamed_cg_kernel<T, kPrecStored, K, SPHERE>;
    default: return (const void*)streamed_cg_kernel<T, kPrecNone, K, SPHERE>;
  }
}

template <typename T>
const void* kernel_for(int prec_kind, int k, int sphere) {
  if (sphere) return k == 2 ? kernel_for_k<T, 2, true>(prec_kind) : nullptr;
  switch (k) {
    case 1: return kernel_for_k<T, 1, false>(prec_kind);
    case 2: return kernel_for_k<T, 2, false>(prec_kind);
    case 3: return kernel_for_k<T, 3, false>(prec_kind);
    case 4: return kernel_for_k<T, 4, false>(prec_kind);
    default: return nullptr;
  }
}

const void* kernel_of(int bf16, int prec_kind, int k, int sphere) {
  return bf16 ? kernel_for<__nv_bfloat16>(prec_kind, k, sphere)
              : kernel_for<float>(prec_kind, k, sphere);
}

}  // namespace

extern "C" {

// Number of blocks the launch for n elements uses (co-resident at most, for
// this instantiation's registers); the caller sizes the partial buffer as
// 2 * grid * streamed_cg_nacc(k).  prec_kind: 0 none, 1 the generated
// shifted-Jacobi power, 2 stored p; sphere: the K = 2 sphere layout (a0 =
// 2t - aux0, weights 1 and 2t on a0's term).
int streamed_cg_grid(int bf16, int prec_kind, int k, int sphere, long long n,
                     int* grid) {
  const void* fn = kernel_of(bf16, prec_kind, k, sphere);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  const int cap = per_sm * sms;
  const int w = bf16 ? Store<__nv_bfloat16>::W : Store<float>::W;
  const long long groups = (n + w - 1) / w;
  long long want = (groups + kThreads - 1) / kThreads;
  if (want < 1) want = 1;
  *grid = (int)(want < cap ? want : cap);
  return (int)cudaSuccess;
}

int streamed_cg_nacc(int k) {
  return (k >= 1 && k <= kUnrolledK) ? nacc(k) : 0;
}

const char* streamed_cg_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launch one subproblem on `stream`.  `terms_in` holds k + 1 Terms: a0,
// then the k weights.  Returns a cudaError_t code: the cooperative launch's
// own refusal (e.g. more blocks than co-resident), or cudaGetLastError()
// after it.
int streamed_cg_launch(int bf16, int prec_kind, int k, int sphere,
                       const void* g,
                       const void* x, const void* terms_in, void* s, void* r,
                       void* p, const float* scal, int n_aux, const float* B,
                       float* res, double* partial, int grid, long long n,
                       int max_iterations, float kappa_fgr, float theta,
                       float epsilon, int pair, int with_init,
                       const float* prec, float prec_c, int prec_quarter,
                       void* stream) {
  const void* fn = kernel_of(bf16, prec_kind, k, sphere);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  // (a pointer to the namespace-local Term in this extern "C" signature
  // would take the symbol out of the library's exports)
  const Term* terms = static_cast<const Term*>(terms_in);
  Params P;
  P.g = g;
  P.x = x;
  P.a0 = terms[0];
  for (int j = 0; j < kUnrolledK; ++j)
    P.w[j] = j < k ? terms[1 + j] : Term{nullptr, 0.f, 0.f, kTermOne, kFormSelf};
  P.prec = prec;
  P.prec_c = prec_c;
  P.prec_quarter = prec_quarter;
  P.s = s;
  P.r = r;
  P.p = p;
  P.scal = scal;
  P.n_aux = n_aux;
  P.B = B;
  P.res = res;
  P.partial = partial;
  P.n = n;
  P.max_iterations = max_iterations;
  P.kappa_fgr = kappa_fgr;
  P.theta = theta;
  P.epsilon = epsilon;
  P.pair = pair;
  P.with_init = with_init;
  void* args[] = {&P};
  cudaError_t e = cudaLaunchCooperativeKernel(
      fn, dim3(grid), dim3(kThreads), args, 0, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
