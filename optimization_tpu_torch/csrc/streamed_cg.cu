// Whole-loop streamed trust-region CG for the H100 (sm_90a).
//
// Replaces optimization_tpu/kernels/streamed_cg.py:_mk_kernel (the Pallas
// TPU kernel behind stpcg_flat_streamed).  One launch solves one
// Steihaug-Toint trust-region subproblem  min <g,s> + 1/2 <s,Hs>, |s| <= Delta
// for H = A0 + U B U' with
//
//   a(i)  = a_c + a_b * i (regenerated in registers, f32) or a stored f32
//           diagonal,
//   A0    = diag(2 a - aux0),   U = (x, 2 a .* x),   B any 2x2,
//
// using the Chronopoulos-Gear recurrences of the Pallas kernel: one fused
// pass over r, p, x (+ s on applying halves) and ONE grid-wide reduction per
// CG iteration, the pair-deferred s update, the boundary sigma-step, the
// kernel-of-H escape with descent alignment, and the truncation target
// |r_k| <= |r_0| min(kappa, |r_0|^theta).
//
// Optional elementwise preconditioner P = M^(-1/2) (the Pallas kernel's
// prec_chunk folding, :110-138 and :206-209): the symmetric change of
// variables s = P shat runs in registers -- ghat = p g in the init pass,
// A0hat = p^2 a0, Uhat = (p x, p 2a x) in every pass -- so the trust region
// and the reported step norm are |s|_M and the truncation runs in
// |r|_(M^-1).  p is either the shifted-Jacobi power
// (|2a - aux0| + c)^(-1/2) or ^(-1/4), regenerated in registers (no bytes;
// round-to-nearest __frsqrt_rn / __fsqrt_rn, the quarter power as
// rsqrt(sqrt(d)) as the JAX package computes it), or a stored f32 vector
// (one more read per pass).  The kernel un-transforms its own output,
// s = p shat, in a tail pass over s (2n words, no extra launch).
//
// What bounds it: device-memory bytes.  Per CG iteration the pair body
// moves 5n words on deferring halves (read r, p, x; write r, p) and 7n on
// applying halves (+ read and write s), 6n on average: about 0.4 GB per
// iteration at f32 and n = 2^24, against a few hundred flops per element.
// The design answers that by touching each vector once per iteration
// (q = Hp and the U columns are recomputed in registers, the diagonal is
// regenerated, never read), 16-byte vector loads, and keeping the whole CG
// loop inside one persistent cooperative launch, so no host round trip or
// kernel boundary sits between iterations.  A generated preconditioner adds
// no bytes (plus 2n for the un-transform tail, once per subproblem); a
// stored one adds n words per pass.
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

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Widest reduction group: the init pass (rv, ar, nr, m[2], mA[2], UU upper).
constexpr int kNacc = 10;

// The preconditioner's form (template parameter PK of the kernel).
constexpr int kPrecNone = 0;
constexpr int kPrecJacobi = 1;   // p = (|2a - aux0| + c)^(-e), generated
constexpr int kPrecStored = 2;   // p read from a stored f32 vector

struct Params {
  const void* g;
  const void* x;
  const float* diag;     // stored diagonal a, or nullptr for a_c + a_b * i
  const float* prec;     // stored p (kPrecStored)
  float prec_c;          // c of the generated p
  int prec_quarter;      // e = 1/4 (else e = 1/2)
  void* s;
  void* r;
  void* p;
  const float* scal;     // Delta, aux0, B00, B01, B10, B11, init group (10)
  float* res;            // k, boundary, |s|^2, model value
  double* partial;       // [2][gridDim.x][kNacc]
  long long n;
  float a_c;
  float a_b;
  int max_iterations;
  float kappa_fgr;
  float theta;
  float epsilon;
  int pair;
  int with_init;
};

// The diagonal a(i) for W consecutive indices, exactly as f32 evaluates
// a_c + a_b * f32(i) (no fused multiply-add, so it matches the plain
// version's separate multiply and add).
template <int W>
__device__ __forceinline__ void diag_group(const Params& P, long long i,
                                           float (&a)[W]) {
  if (P.diag != nullptr) {
#pragma unroll
    for (int e = 0; e < W; ++e) a[e] = (i + e < P.n) ? P.diag[i + e] : 0.f;
  } else {
#pragma unroll
    for (int e = 0; e < W; ++e)
      a[e] = __fadd_rn(P.a_c, __fmul_rn(P.a_b, __ll2float_rn(i + e)));
  }
}

// The preconditioner's diagonal p(i) for W consecutive indices, given the
// group's diagonal a (kPrecJacobi) or read from the stored vector.
template <int PK, int W>
__device__ __forceinline__ void prec_group(const Params& P, float aux0,
                                           long long i, const float (&a)[W],
                                           float (&p)[W]) {
  if (PK == kPrecStored) {
#pragma unroll
    for (int e = 0; e < W; ++e) p[e] = (i + e < P.n) ? P.prec[i + e] : 0.f;
  } else {
#pragma unroll
    for (int e = 0; e < W; ++e) {
      const float d = __fadd_rn(fabsf(__fsub_rn(2.f * a[e], aux0)), P.prec_c);
      p[e] = P.prec_quarter ? __frsqrt_rn(__fsqrt_rn(d)) : __frsqrt_rn(d);
    }
  }
}

// The folded operator for one element: a0 = p^2 (2a - aux0) and
// u = (p x, (p 2a) x), or the plain a0 = 2a - aux0, u = (x, 2a x) when PK is
// kPrecNone (in the Pallas kernel's multiplication order).
template <int PK>
__device__ __forceinline__ void fold(float a, float x, float p, float aux0,
                                     float& a0, float& u0, float& u1) {
  if (PK == kPrecNone) {
    a0 = 2.f * a - aux0;
    u0 = x;
    u1 = (2.f * a) * x;
  } else {
    a0 = (p * p) * (2.f * a - aux0);
    u0 = p * x;
    u1 = (p * (2.f * a)) * x;
  }
}

__device__ __forceinline__ float kdot2(const float (&a)[2], const float (&b)[2]) {
  return a[0] * b[0] + a[1] * b[1];
}

__device__ __forceinline__ void matk2(const float (&M)[2][2], const float (&v)[2],
                                      float (&out)[2]) {
  out[0] = M[0][0] * v[0] + M[0][1] * v[1];
  out[1] = M[1][0] * v[0] + M[1][1] * v[1];
}

__device__ __forceinline__ float pow_static(float x, float e) {
  if (e == 0.f) return 1.f;
  if (e == 0.5f) return sqrtf(x);
  if (e == 1.f) return x;
  return expf(e * logf(x));
}

// Block + grid reduction of NACC per-thread partials.  Writes this block's
// sums into partial[par], crosses one grid.sync(), and returns in `out`
// the grid totals, summed by every block in one fixed order.
struct Reducer {
  double (*red)[kNacc];  // shared [kWarps][kNacc]
  double* tot;           // shared [kNacc]

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
    double* part = P.partial + (size_t)par * gridDim.x * kNacc;
    if (threadIdx.x < NACC) {
      double v = 0.0;
      for (int w = 0; w < kWarps; ++w) v += red[w][threadIdx.x];
      part[(size_t)blockIdx.x * kNacc + threadIdx.x] = v;
    }
    grid.sync();
    for (int a = warp; a < NACC; a += kWarps) {
      double v = 0.0;
      for (unsigned b = lane; b < gridDim.x; b += 32) v += part[(size_t)b * kNacc + a];
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
struct Carry {
  int k;
  float rv, ar, nr, pa, nAp, rv_prev, alpha_prev, pr_c, kappa_prev;
  float s_p, sk2, pp_prev, mval, done, bnd, s_valid, p_valid;
  float m[2], mA[2], mB[2], mp[2];
};

struct Consts {
  float Delta2, aux0, eps2, target;
  float B[2][2], UU[2][2];
};

// One CG iteration (the Pallas kernel's half(), :354-501).  APPLY folds
// the pending coefficient `pend` into this half's s update; otherwise the
// half returns its own s coefficient for the next half.
template <typename T, int PK, bool APPLY>
__device__ float half(cg::grid_group& grid, const Params& P, const Consts& K,
                      const Reducer& R, Carry& c, int& par, float pend) {
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
                      (sqrtf(c.rv) <= K.target);
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

  float Bm[2];
  matk2(K.B, c.m, Bm);
  const float wr = c.ar + kdot2(c.m, Bm);
  const float kappa = wr - (beta / c.alpha_prev) * c.rv;
  const float pp_k = c.rv + beta * beta * c.pp_prev;
  const float pr_k = -c.rv + beta * (c.pr_c + c.alpha_prev * c.kappa_prev);
  const float sp_k = beta * (c.s_p + c.alpha_prev * c.pp_prev);

  // kernel-of-H safeguard via the |q|^2 recurrence
  float Bmp[2], UUBm[2], UUBmp[2];
  matk2(K.B, c.mp, Bmp);
  matk2(K.UU, Bm, UUBm);
  matk2(K.UU, Bmp, UUBmp);
  const float ww = c.nr + 2.f * kdot2(c.mA, Bm) + kdot2(Bm, UUBm);
  const float wq = c.pa + kdot2(c.mA, Bmp) + kdot2(Bm, c.mB) + kdot2(Bm, UUBmp);
  const float qq_prev = c.nAp + 2.f * kdot2(c.mB, Bmp) + kdot2(Bmp, UUBmp);
  const float qq_k = ww - 2.f * beta * wq + beta * beta * qq_prev;
  const bool in_kernel = qq_k < K.eps2 * pp_k;
  const float sign = (in_kernel && pr_k > 0.f) ? -1.f : 1.f;

  const float sp_eff = sign * sp_k;
  const float disc = sp_eff * sp_eff + pp_k * (K.Delta2 - c.sk2);
  const float sigma = (-sp_eff + sqrtf(fmaxf(disc, 0.f))) / fmaxf(pp_k, FLT_MIN);

  const float alpha = c.rv / kappa;
  const float sk2_next = c.sk2 + 2.f * alpha * sp_k + alpha * alpha * pp_k;
  const bool boundary = in_kernel || (kappa <= 0.f) || (sk2_next > K.Delta2);

  const float cs = boundary ? sigma * sign : alpha;
  const float crr = boundary ? 0.f : alpha;
  const float m_new = boundary
      ? c.mval + sigma * sign * pr_k + 0.5f * sigma * sigma * kappa
      : c.mval - 0.5f * alpha * c.rv;

  float mp_k[2], mB2[2], Bmpk[2], UUBmpk[2], m2[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) mp_k[j] = -c.m[j] + beta * c.mp[j];
#pragma unroll
  for (int j = 0; j < 2; ++j) mB2[j] = -c.mA[j] + beta * c.mB[j];
  matk2(K.B, mp_k, Bmpk);
  matk2(K.UU, Bmpk, UUBmpk);
#pragma unroll
  for (int j = 0; j < 2; ++j) m2[j] = c.m[j] + crr * (mB2[j] + UUBmpk[j]);
  const float nAp2 = c.nr - 2.f * beta * c.pa + beta * beta * c.nAp;

  // ---- the streamed pass: r/p (+ s when applying) in and out, x in,
  // the diagonal regenerated; on the first iteration r is g ----
  const T* rsrc = first ? g : r;
  const bool s_ok = c.s_valid != 0.f;
  const bool p_ok = c.p_valid != 0.f;
  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (long long gi = t0; gi < ngroups; gi += stride) {
    const long long i = gi * W;
    float rc[W], pc[W], xc[W], a[W], pr[W];
    Store<T>::load(rsrc, i, P.n, rc);
    if (p_ok) Store<T>::load(p, i, P.n, pc);
    else for (int e = 0; e < W; ++e) pc[e] = 0.f;
    Store<T>::load(x, i, P.n, xc);
    diag_group<W>(P, i, a);
    if (PK != kPrecNone) {
      prec_group<PK, W>(P, K.aux0, i, a, pr);
      // r0 is ghat = p g, stored: the Pallas init pass writes it to r
      if (first)
        for (int e = 0; e < W; ++e) rc[e] = Store<T>::rounded(pr[e] * rc[e]);
    }
    float r2v[W], p2v[W];
#pragma unroll
    for (int e = 0; e < W; ++e) {
      float a0, u0, u1;
      fold<PK>(a[e], xc[e], PK != kPrecNone ? pr[e] : 1.f, K.aux0, a0, u0, u1);
      const float p2 = first ? -rc[e] : -rc[e] + beta * pc[e];
      float q2 = a0 * p2;
      q2 = q2 + Bmpk[0] * u0;
      q2 = q2 + Bmpk[1] * u1;
      const float r2 = rc[e] + crr * q2;
      const float a0r2 = a0 * r2;
      const float a0p2 = a0 * p2;
      acc[0] += r2 * r2;
      acc[1] += a0r2 * r2;
      acc[2] += a0r2 * a0r2;
      acc[3] += a0r2 * a0p2;
      acc[4] += u0 * a0r2;
      acc[5] += u1 * a0r2;
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
    float tot[6];
    R.run(grid, P, par, acc, tot);
    par ^= 1;
    const float rv_old = c.rv;
    c.rv = tot[0];
    c.ar = tot[1];
    c.nr = tot[2];
    c.pa = tot[3];
    c.mA[0] = tot[4];
    c.mA[1] = tot[5];
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
  for (int j = 0; j < 2; ++j) {
    c.m[j] = m2[j];
    c.mB[j] = mB2[j];
    c.mp[j] = mp_k[j];
  }
  if (APPLY) c.s_valid = 1.f;
  c.p_valid = 1.f;
  return APPLY ? 0.f : cs;
}

template <typename T, int PK>
__global__ void __launch_bounds__(kThreads) streamed_cg_kernel(Params P) {
  constexpr int W = Store<T>::W;
  cg::grid_group grid = cg::this_grid();
  __shared__ double red[kWarps][kNacc];
  __shared__ double tot[kNacc];
  const Reducer R{red, tot};

  Consts K;
  const float Delta = P.scal[0];
  K.Delta2 = Delta * Delta;
  K.aux0 = P.scal[1];
  K.B[0][0] = P.scal[2];
  K.B[0][1] = P.scal[3];
  K.B[1][0] = P.scal[4];
  K.B[1][1] = P.scal[5];
  K.eps2 = P.epsilon * P.epsilon;

  const T* g = static_cast<const T*>(P.g);
  const T* x = static_cast<const T*>(P.x);
  const long long ngroups = (P.n + W - 1) / W;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;

  int par = 0;
  float init[kNacc];  // rv0, ar0, nr0, m0[2], mA0[2], UU00, UU01, UU11
  if (P.with_init) {
    // threaded group: rv, ar, nr, m[2], mA[2], UU[2][2] row-major
    for (int j = 0; j < 7; ++j) init[j] = P.scal[6 + j];
    init[7] = P.scal[13];
    init[8] = P.scal[14];
    init[9] = P.scal[16];
  } else {
    // the init pass: one read of g and x; r is not written (the first
    // iteration reads g in its place); with a preconditioner g is ghat = p g
    float acc[kNacc];
    for (int j = 0; j < kNacc; ++j) acc[j] = 0.f;
    for (long long gi = t0; gi < ngroups; gi += stride) {
      const long long i = gi * W;
      float gc[W], xc[W], a[W], pr[W];
      Store<T>::load(g, i, P.n, gc);
      Store<T>::load(x, i, P.n, xc);
      diag_group<W>(P, i, a);
      if (PK != kPrecNone) {
        prec_group<PK, W>(P, K.aux0, i, a, pr);
        for (int e = 0; e < W; ++e) gc[e] = pr[e] * gc[e];
      }
#pragma unroll
      for (int e = 0; e < W; ++e) {
        float a0, u0, u1;
        fold<PK>(a[e], xc[e], PK != kPrecNone ? pr[e] : 1.f, K.aux0, a0, u0,
                 u1);
        const float a0g = a0 * gc[e];
        acc[0] += gc[e] * gc[e];
        acc[1] += a0g * gc[e];
        acc[2] += a0g * a0g;
        acc[3] += u0 * gc[e];
        acc[4] += u1 * gc[e];
        acc[5] += u0 * a0g;
        acc[6] += u1 * a0g;
        acc[7] += u0 * u0;
        acc[8] += u0 * u1;
        acc[9] += u1 * u1;
      }
    }
    R.run(grid, P, par, acc, init);
    par ^= 1;
  }
  K.UU[0][0] = init[7];
  K.UU[0][1] = init[8];
  K.UU[1][0] = P.with_init ? P.scal[15] : init[8];
  K.UU[1][1] = init[9];

  const float r0n = sqrtf(init[0]);
  K.target = r0n * fminf(P.kappa_fgr, pow_static(r0n, P.theta));

  Carry c;
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
  for (int j = 0; j < 2; ++j) {
    c.m[j] = init[3 + j];
    c.mA[j] = init[5 + j];
    c.mB[j] = 0.f;
    c.mp[j] = 0.f;
  }

  // The loop condition (the Pallas kernel's cond, :348-352) reads only
  // carried scalars, which are bitwise equal in every thread: every block
  // takes the same number of trips through grid.sync().
  while (c.k < P.max_iterations && c.done == 0.f && sqrtf(c.rv) > K.target) {
    if (P.pair) {
      const float pend = half<T, PK, false>(grid, P, K, R, c, par, 0.f);
      half<T, PK, true>(grid, P, K, R, c, par, pend);
    } else {
      half<T, PK, true>(grid, P, K, R, c, par, 0.f);
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
      float sc[W], a[W], pr[W];
      Store<T>::load(s, i, P.n, sc);
      diag_group<W>(P, i, a);
      prec_group<PK, W>(P, K.aux0, i, a, pr);
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

// The kernel instance for a storage dtype and preconditioner form.
template <typename T>
const void* kernel_for(int prec_kind) {
  switch (prec_kind) {
    case kPrecJacobi: return (const void*)streamed_cg_kernel<T, kPrecJacobi>;
    case kPrecStored: return (const void*)streamed_cg_kernel<T, kPrecStored>;
    default: return (const void*)streamed_cg_kernel<T, kPrecNone>;
  }
}

template <typename T>
cudaError_t max_blocks(int prec_kind, int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel_for<T>(prec_kind), kThreads, 0);
  if (e != cudaSuccess) return e;
  *out = per_sm * sms;
  return cudaSuccess;
}

template <typename T>
cudaError_t grid_for(int prec_kind, long long n, int* grid) {
  int cap = 0;
  cudaError_t e = max_blocks<T>(prec_kind, &cap);
  if (e != cudaSuccess) return e;
  const long long groups = (n + Store<T>::W - 1) / Store<T>::W;
  long long want = (groups + kThreads - 1) / kThreads;
  if (want < 1) want = 1;
  *grid = (int)(want < cap ? want : cap);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Number of blocks the launch for n elements uses (co-resident at most);
// the caller sizes the partial buffer as 2 * grid * streamed_cg_nacc().
// prec_kind: 0 none, 1 the generated shifted-Jacobi power, 2 stored p.
int streamed_cg_grid(int bf16, int prec_kind, long long n, int* grid) {
  return bf16 ? (int)grid_for<__nv_bfloat16>(prec_kind, n, grid)
              : (int)grid_for<float>(prec_kind, n, grid);
}

int streamed_cg_nacc() { return kNacc; }

const char* streamed_cg_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launch one subproblem on `stream`.  Returns a cudaError_t code: the
// cooperative launch's own refusal (e.g. more blocks than co-resident),
// or cudaGetLastError() after it.
int streamed_cg_launch(int bf16, const void* g, const void* x,
                       const float* diag, void* s, void* r, void* p,
                       const float* scal, float* res, double* partial,
                       int grid, long long n, float a_c, float a_b,
                       int max_iterations, float kappa_fgr, float theta,
                       float epsilon, int pair, int with_init, int prec_kind,
                       const float* prec, float prec_c, int prec_quarter,
                       void* stream) {
  Params P;
  P.g = g;
  P.x = x;
  P.diag = diag;
  P.prec = prec;
  P.prec_c = prec_c;
  P.prec_quarter = prec_quarter;
  P.s = s;
  P.r = r;
  P.p = p;
  P.scal = scal;
  P.res = res;
  P.partial = partial;
  P.n = n;
  P.a_c = a_c;
  P.a_b = a_b;
  P.max_iterations = max_iterations;
  P.kappa_fgr = kappa_fgr;
  P.theta = theta;
  P.epsilon = epsilon;
  P.pair = pair;
  P.with_init = with_init;
  void* args[] = {&P};
  const void* fn = bf16 ? kernel_for<__nv_bfloat16>(prec_kind)
                        : kernel_for<float>(prec_kind);
  cudaError_t e = cudaLaunchCooperativeKernel(
      fn, dim3(grid), dim3(kThreads), args, 0, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
