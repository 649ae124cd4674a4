// Whole-loop streamed trust-region CG for the H100 (sm_90a): any rank K.
//
// Replaces optimization_tpu/kernels/streamed_cg.py:_mk_kernel (the Pallas
// TPU kernel behind stpcg_flat_streamed, call :643) for K >= 5;
// csrc/streamed_cg.cu keeps its register instantiations for K = 1-4 and the
// sphere layout.  One launch solves one Steihaug-Toint trust-region
// subproblem for
//
//   H = A0 + U B U',   A0 = diag(a0),   U = (w_1 .* x, ..., w_K .* x),
//
// K a runtime value, with the terms, the preconditioner P = M^(-1/2) and
// the Chronopoulos-Gear pair/single bodies of csrc/streamed_cg.cu (the
// Pallas kernel's recurrences; rank k :120-138, :206-256, :342-345,
// :411-415 there).
//
// What bounds it on the H100: device-memory bytes.  A CG iteration moves
// 6n words of the storage type on average (pair body) plus n f32 words for
// each stored term (a stored or wrapped weight, a0 or P); the weight 1 and
// the generated weights (c + b i) move nothing.  The init pass adds one
// read of g, x and the stored terms and the Gram of (g, A0 g, U),
// (K+2)(K+3)/2 products an element once a subproblem (the fold below takes
// it to (4 + Ks)(5 + Ks)/2, Ks the stored weights).
//
// What this file's earlier design lost, from its device-clock trace
// (profile_streamed_cg.py trace; block 0, 50 CG at n = 2^24 on
// chip_smoke.gen_weights' mix, an H100 at 700 W): 371 us a CG iteration
// at K = 8 f32 against a bound of ~200, 1,259 us at K = 32, 98% of it in
// the pass, where each group of 4 elements walked the K terms twice (q2,
// then the dots U'(A0 r)), each step reading a Term, branching on its mode
// and form, loading a stored term's 16 bytes and using them at once (one
// load in flight a thread) and, for the dots, a shared-memory
// read-modify-write of the thread's partial: the two term loops took
// 77-93% of the pass.  Its init pass built V a thread an element, K
// dependent loads each (~2.5 ms at K = 8, ~10 ms at K = 32).
//
// The design (kernels/streamed_cg.py:any_k_plan is its host plan):
//   - terms sorted once a launch into three classes (a table the wrapper
//     builds, copied to shared memory): the weight 1, generated weights
//     (c, b with the form's factor taken in) and stored weights (pointer,
//     scale).  No element branches on a term.
//   - the weight 1 and the generated weights are folded: the block forms
//     C = sum_j (B mp_k)_j c_j and D = sum_j (B mp_k)_j b_j once an
//     iteration (in double), the pass adds (C + D f32(i)) p x into q2, and
//     each thread carries two double sums, sum y and sum f32(i) y
//     (y = p x a0 r2): each folded weight's dot is c_j S0 + b_j S1 after the
//     grid reduction.  A folded weight costs no work an element.
//   - stored streams come by TMA: a producer warp keeps tiles of 1,024
//     elements of r (g on the first iteration), p, x, s (when applying), a
//     stored a0 or P and the stored weights in flight, one-dimensional bulk
//     copies into a ring of 2-4 shared-memory stages, each guarded by a full
//     and an empty mbarrier (csrc/ring.cuh, the helpers of
//     csrc/gram_pair.cu); the array's last partial 16 bytes by plain
//     copies.  The producer issues a pass's first stages before the K-sized
//     algebra, so they land while it runs.  Eight consumer warps take a
//     quad of 4 elements a thread (f32 and bf16 alike, so both run the same
//     registers): q2 from the stage, r2, the four scalar dots, the stores of
//     r, p and s.
//   - the stored weights' dots in registers: each thread adds w_q . y over
//     its own quad into one register a stored weight (up to kRegSlots; past
//     that a tile's part of each warp goes into the warp's shared slot),
//     folded into the block sums once a pass, in double and a fixed order
//     (two launches are bitwise equal).  The trace settled this against the
//     plan of a warp a weight over the staged tile: that step, behind a
//     named barrier and y staged in shared memory, cost as much as the rest
//     of the tile (bf16 K = 8: the pass 240 us, 154 without it).  A stored
//     weight is read from device memory once a pass while all fit in a
//     stage beside the other streams (two stages of them: ~21 f32 weights);
//     past that line a tile comes in several stages of `group` weights and
//     the dots read them a second time, through L2.
//   - one block an SM of 288 threads (168 registers, no spill); the ring
//     and the arrays fill its 232,448 bytes.
//   - the init pass rides the ring too and folds the same way: every
//     folded weight's u_j is a combination of p x and (f32(i) - n/2) p x, so
//     the Gram is of V' = (ghat, a0 ghat, p x, (f32(i) - n/2) p x, the
//     stored t_q p x), 4 + Ks rows instead of K + 2, assembled into V'V
//     afterwards (init_expand); each thread owns a 4 x 4 block of V'V' and a
//     slice of the staged tile's quads (16 products for 8 shared-memory
//     reads an element), the slices met by shuffle, the block sums in
//     double.
//
// The K-vector recurrences and the K x K products with B and U'U stay once
// per block in shared memory (B' and U'U up to kMatsCap, in device memory
// above; the K-vectors, the slots, the table and the init's basis rows each
// move to device memory past their own line: make_plan), the same code on
// both sides of each line.  The grid-wide reduction keeps the earlier
// design's property that two runs on one card are bitwise equal (double, a
// fixed order, no atomics): each block writes its sums entry-major, crosses
// grid.sync(), sums the entries a = block + grid * q over all blocks (32
// lanes, then a shuffle tree), writes the totals and crosses a second
// grid.sync().  A reduction moves 6 + (stored weights) entries a half,
// (4 + Ks)(5 + Ks)/2 the init.
//
// Plain C interface for ctypes; see optimization_tpu_torch/kernels/
// streamed_cg.py for the wrapper, the plan and the plain PyTorch version.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "ring.cuh"
#include "storage.cuh"
#include "streamed_cg.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kConsumers = 256;               // eight consumer warps
constexpr int kCWarps = kConsumers / 32;
constexpr int kThreads = kConsumers + 32;     // and the producer warp
constexpr int kWarps = kThreads / 32;
constexpr int kTileElems = 4 * kConsumers;    // a staged tile: a quad a consumer
constexpr int kRingStages = 4;                // the ring's deepest
constexpr int kRegSlots = 16;                 // stored weights' dots in registers
constexpr int kVecs = 13;                     // the K-vectors of a block (Vecs)
constexpr long long kMatsCap = 65536;         // B' and U'U in shared memory up to
constexpr int kFixedBytes = 1024;             // barriers and block reductions
// Block 0's first consumer thread records, for each of the first
// kTraceIters CG iterations, the device clock (ns) at each step and the SM
// cycles it spent in each part of the pass (profile_streamed_cg.py trace;
// read by streamed_cg_any_trace).
constexpr bool kTrace = false;
constexpr int kTraceIters = 64, kTraceEvents = 14;
// The producer issues a pass's first stages before the K-sized algebra
// (false: at the pass; profile_streamed_cg.py's no_prefill variant).
constexpr bool kPrefill = true;

// kTraceIters rows of kTraceEvents, then the init pass's row (its start,
// the consumers' end, the grid sum's end, the expansion's end)
__device__ long long g_trace[(kTraceIters + 1) * kTraceEvents];

__device__ __forceinline__ bool tracing(int it) {
  return kTrace && blockIdx.x == 0 && threadIdx.x == 0 && it < kTraceIters;
}
__device__ __forceinline__ void trace(int it, int ev) {
  if (tracing(it)) {
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_trace[it * kTraceEvents + ev] = t;
  }
}
__device__ __forceinline__ void trace_init(int ev) {
  if (kTrace && blockIdx.x == 0 && threadIdx.x == 0) {
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_trace[kTraceIters * kTraceEvents + ev] = t;
  }
}
// the init row's cycle counts (events 4-8: waiting for the stage, the
// rows, the pairs, the two barriers, the whole of thread 0's init)
__device__ __forceinline__ void trace_init_add(int ev, long long v) {
  if (kTrace && blockIdx.x == 0 && threadIdx.x == 0)
    g_trace[kTraceIters * kTraceEvents + ev] += v;
}
// the same by another thread (the producer's lane 0: threadIdx.x = who)
__device__ __forceinline__ void trace_by(int it, int ev, int who) {
  if (kTrace && blockIdx.x == 0 && threadIdx.x == who && it < kTraceIters) {
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_trace[it * kTraceEvents + ev] = t;
  }
}
__device__ __forceinline__ void trace_add(int it, int ev, long long v) {
  if (tracing(it)) g_trace[it * kTraceEvents + ev] += v;
}

__host__ __device__ inline long long round16(long long b) {
  return (b + 15) / 16 * 16;
}

// A stored weight (a tensor, or a wrapped callable evaluated by the
// wrapper) and a folded one (the weight 1 or a generated weight, w(i) =
// c + b f32(i) with its form's factor taken in).  The wrapper's table:
// the stored entries, then the folded (kernels/streamed_cg.py:
// any_k_plan).
struct StoredTerm {
  const float* ptr;
  int idx;       // the weight's j
  float scale;   // 1, or 2 (ScaledDiagonal)
};
struct FoldedTerm {
  int idx;
  float c;
  float b;
  int pad;
};
static_assert(sizeof(StoredTerm) == 16 && sizeof(FoldedTerm) == 16, "");

// The launch plan (kernels/streamed_cg.py:any_k_plan is the same): the
// ring's stages and what a stage holds, and where each array lives, in
// dynamic shared memory (offsets from its start) or, past the budget, in
// the block's slice of the global scratch (`block_bytes` long; the tables
// stay in the caller's device buffer, B' in the caller's and U'U in one
// global copy).
struct Plan {
  int k, ks;            // weights, stored weights
  int group;            // stored weights a stage holds
  int chunks;           // stages a tile takes (ceil(ks / group), 1 at ks = 0)
  int stages;           // the ring's depth
  int stage_bytes;
  int off_p, off_x, off_s, off_a0, off_pv, off_w;   // r at 0
  int tables_smem, vecs_smem, slots_smem, mats_smem, rows_smem;
  long long tables_off, vecs_off, slots_off, mats_off, rows_off, ring_off;
  long long vrows_off;  // the init's stored rows past the chunk line (slice)
  long long uu_off;     // the init's U'U past the B', U'U line (slice)
  long long block_bytes;
  long long smem_bytes;
};

// Place the arrays into `budget` bytes of shared memory, keeping room for
// the ring's least (two stages of one stored weight): the fixed area, the
// tables, the K-vectors, the dot slots, B' and U'U (up to kMatsCap), then
// the ring in what is left.  All stored weights ride in one stage while
// two such stages fit (up to kRingStages of them); past that line a tile
// comes in `chunks` stages of `group` weights.  The init pass's four
// basis rows of a tile overlap the dot slots, B' and U'U (first used after
// it) and come before the ring; its stored rows are the stage's own below
// the chunk line, the block's slice above it.
inline Plan make_plan(int K, int Ks, int a0s, int ps, int size,
                      int with_init, long long budget) {
  Plan L = {};
  L.k = K;
  L.ks = Ks;
  const long long T = kTileElems;
  const long long base = T * (4LL * size + 4LL * a0s + 4LL * ps);
  const long long term = 4 * T;
  const long long reserve = 2 * (base + term);
  long long used = kFixedBytes;
  auto put = [&](long long bytes, int& in_smem, long long& off) {
    bytes = round16(bytes);
    in_smem = used + bytes + reserve <= budget;
    if (in_smem) {
      off = used;
      used += bytes;
    } else {
      off = L.block_bytes;
      L.block_bytes += bytes;
    }
  };
  put(16LL * K, L.tables_smem, L.tables_off);
  if (!L.tables_smem) L.block_bytes = L.tables_off = 0;
  put(4LL * kVecs * K, L.vecs_smem, L.vecs_off);
  const long long region = used;
  put(8LL * kCWarps * (Ks > 1 ? Ks : 1), L.slots_smem, L.slots_off);
  const long long mats = round16(8LL * K * K);
  L.mats_smem = mats <= kMatsCap && used + mats + reserve <= budget;
  if (L.mats_smem) {
    L.mats_off = used;
    used += mats;
  }
  const long long rows = with_init ? 0 : 16 * T;
  L.rows_smem = region + rows + reserve <= budget;
  if (L.rows_smem) {
    L.rows_off = region;
    if (region + rows > used) used = region + rows;
  } else {
    L.rows_off = L.block_bytes;
    L.block_bytes += rows;
  }
  L.ring_off = used;
  const long long avail = budget - used;
  const long long all = base + term * Ks;
  if (2 * all <= avail) {
    L.group = Ks;
    L.chunks = 1;
    L.stages = (int)(avail / all < kRingStages ? avail / all : kRingStages);
  } else {
    L.stages = 3;
    long long g = (avail / 3 - base) / term;
    if (g < 1) {
      L.stages = 2;
      g = (avail / 2 - base) / term;
    }
    L.group = (int)g;
    L.chunks = (Ks + L.group - 1) / L.group;
  }
  L.stage_bytes = (int)(base + term * L.group);
  L.off_p = (int)(T * size);
  L.off_x = (int)(2 * T * size);
  L.off_s = (int)(3 * T * size);
  L.off_a0 = (int)(4 * T * size);
  L.off_pv = L.off_a0 + (int)(4 * T * a0s);
  L.off_w = L.off_pv + (int)(4 * T * ps);
  used += (long long)L.stages * L.stage_bytes;
  L.vrows_off = L.block_bytes;
  if (!with_init && L.chunks > 1) L.block_bytes += term * Ks;
  L.uu_off = L.block_bytes;
  if (!with_init && !L.mats_smem) L.block_bytes += round16(4LL * K * K);
  L.block_bytes = round16(L.block_bytes);
  L.smem_bytes = used;
  return L;
}

// The init's pairs of V'V' (V' = (g, a0 g, p x, (f32(i) - h) p x, the
// stored weights' t p x), 4 + Ks rows) and a half's entries (rv, ar, nr,
// pa, the folded weights' two sums, the stored weights' dots); the
// scratch holds the wider.
__host__ __device__ inline long long init_pairs(int Ks) {
  return (long long)(Ks + 4) * (Ks + 5) / 2;
}
__host__ __device__ inline long long half_entries(int Ks) { return 6 + Ks; }
__host__ __device__ inline long long nmax(int Ks, int with_init) {
  const long long h = half_entries(Ks);
  return with_init || h > init_pairs(Ks) ? h : init_pairs(Ks);
}
// the index of the pair (a, b), a <= b, of R rows' row-major upper triangle
__host__ __device__ inline long long pair_index(int a, int b, int R) {
  return (long long)a * R - (long long)a * (a - 1) / 2 + (b - a);
}

struct AnyParams {
  const void* g;
  const void* x;
  Term a0;
  const unsigned char* tables;   // device: Ks StoredTerm, then K - Ks FoldedTerm
  const float* prec;             // stored p (kPrecStored)
  float prec_c;                  // c of the generated p
  int prec_quarter;              // e = 1/4 (else e = 1/2)
  void* s;
  void* r;
  void* p;
  const float* scal;             // Delta, aux[n_aux], threaded init group
  int n_aux;
  const float* Bt;               // B', K x K row-major (B column-major)
  float* res;                    // k, boundary, |s|^2, model value
  unsigned char* scratch;        // part, tot, the blocks' slices
  long long n;
  int max_iterations;
  float kappa_fgr;
  float theta;
  float epsilon;
  int pair;
  int with_init;
  Plan L;
};

// Byte offsets in the global scratch: part [nmax][grid] doubles (entry-
// major), tot [nmax] doubles, then the blocks' slices.
struct Scratch {
  long long tot, blocks, bytes;
};

__host__ __device__ inline Scratch scratch_of(const Plan& L, int with_init,
                                              int grid) {
  Scratch S;
  const long long nm = nmax(L.ks, with_init);
  S.tot = round16(8 * nm * grid);
  S.blocks = S.tot + round16(8 * nm);
  S.bytes = S.blocks + L.block_bytes * grid;
  return S;
}

// ---- element access: a quad (4 consecutive elements) a thread ----

template <typename T> struct Quad;
// (lds: through a generic pointer; ldsh: from a shared-memory address,
// an explicit ld.shared, for the staged tiles, which are always there)
template <> struct Quad<float> {
  __device__ static void lds(const unsigned char* a, float (&v)[4]) {
    const float4 t = *reinterpret_cast<const float4*>(a);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  }
  __device__ static void ldsh(uint32_t a, float (&v)[4]) {
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                 : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
                 : "r"(a));
  }
  static constexpr int kBytes = 16;
};
template <> struct Quad<__nv_bfloat16> {
  __device__ static void unpack(uint2 t, float (&v)[4]) {
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&t);
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = __bfloat162float(h[e]);
  }
  __device__ static void lds(const unsigned char* a, float (&v)[4]) {
    unpack(*reinterpret_cast<const uint2*>(a), v);
  }
  __device__ static void ldsh(uint32_t a, float (&v)[4]) {
    uint2 t;
    asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
                 : "=r"(t.x), "=r"(t.y)
                 : "r"(a));
    unpack(t, v);
  }
  static constexpr int kBytes = 8;
};

__device__ __forceinline__ void sts_quad(uint32_t a, const float (&v)[4]) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(a),
               "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3])
               : "memory");
}

// this thread's warp, as a value the compiler knows to be the same across
// the warp (a branch on it does not split a warp: shuffles below it need
// no divergence handling)
__device__ __forceinline__ int warp_id() {
  return __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 5), 0);
}

// Four elements at i of a vector in device memory (0 past n; i a multiple
// of 4, the base 16-byte aligned).
template <typename T>
__device__ __forceinline__ void ldg_quad(const T* p, long long i, long long n,
                                         float (&v)[4]) {
  if (i + 4 <= n) {
    Quad<T>::lds(reinterpret_cast<const unsigned char*>(p + i), v);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = i + e < n ? Store<T>::get(p, i + e) : 0.f;
  }
}
template <typename T>
__device__ __forceinline__ void stg_quad(T* p, long long i, long long n,
                                         const float (&v)[4]);
template <>
__device__ __forceinline__ void stg_quad<float>(float* p, long long i,
                                                long long n,
                                                const float (&v)[4]) {
  if (i + 4 <= n) {
    *reinterpret_cast<float4*>(p + i) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (i + e < n) p[i + e] = v[e];
  }
}
template <>
__device__ __forceinline__ void stg_quad<__nv_bfloat16>(
    __nv_bfloat16* p, long long i, long long n, const float (&v)[4]) {
  if (i + 4 <= n) {
    uint2 t;
    __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&t);
#pragma unroll
    for (int e = 0; e < 4; ++e) h[e] = __float2bfloat16(v[e]);
    *reinterpret_cast<uint2*>(p + i) = t;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (i + e < n) p[i + e] = __float2bfloat16(v[e]);
  }
}

__device__ __forceinline__ float f32_of(long long i) {
  return __ll2float_rn(i);
}

// a0's t(i) in its form (the register kernel's term_form)
__device__ __forceinline__ float a0_form(const Term& t, float v, float aux0) {
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

// The block's K-vectors: kVecs of K floats from one base.
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
  // the pass's coefficient of each stored weight: (B mp_k)_j times its scale
  __device__ float* coef() const { return at(12); }
};

// out = M v for K x K M given as M' row-major; one row a thread, summed in
// the order j = 0..K-1 (the register kernel's kdot).
__device__ __forceinline__ void matvec(const float* Mt, const float* v,
                                       float* out, int K) {
  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    float t = Mt[i] * v[0];
    for (int j = 1; j < K; ++j) t = t + Mt[(long long)j * K + i] * v[j];
    out[i] = t;
  }
}

// a . b of two K-vectors by one warp: lanes stride, then an xor tree.
__device__ __forceinline__ float warp_dot(const float* a, const float* b,
                                          int K) {
  float t = 0.f;
  for (int j = threadIdx.x & 31; j < K; j += 32) t = t + a[j] * b[j];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) t += __shfl_xor_sync(0xffffffffu, t, off);
  return t;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// The grid-wide sums of `N` entries whose block sums each block has written
// to part[a * grid + block]: block b sums the entries a = b + grid * q (one
// warp an entry), in double and a fixed order, into tot[a].
__device__ void grid_sum(cg::grid_group& grid, const double* part,
                         double* tot, long long N, int tr = kTraceIters) {
  grid.sync();
  trace(tr, 4);
  const int lane = threadIdx.x & 31;
  const int warp = warp_id();
  const long long G = gridDim.x;
  for (long long a = blockIdx.x + G * warp; a < N; a += G * kWarps) {
    double v = 0.0;
    for (long long b = lane; b < G; b += 32) v += part[a * G + b];
    v = warp_sum(v);
    if (lane == 0) tot[a] = v;
  }
  trace(tr, 5);
  grid.sync();
  trace(tr, 6);
}

// The carried scalars of the CG loop, identical in every thread.
struct Carry {
  int k;
  int it;   // halves run (the trace's index)
  float rv, ar, nr, pa, nAp, rv_prev, alpha_prev, pr_c, kappa_prev;
  float s_p, sk2, pp_prev, mval, done, bnd, s_valid, p_valid;
};

struct Block {
  const StoredTerm* stored;
  const FoldedTerm* folded;
  Vecs v;
  double* slots;       // [kCWarps][Ks] the stored weights' dots a warp
  const float* Bt;     // B'
  const float* UU;     // U'U (symmetric)
  uint64_t* full;      // the ring's barriers
  uint64_t* empty;
  unsigned char* ring;
  float* dots;         // [kCWarps], shared
  float* fold;         // C, D of the pass, shared
  double* red;         // [kWarps][6], shared
  double* part;
  double* tot;
  float Delta2, aux0, eps2, target;
  int K, Ks, Kf;
  int ntiles;          // this block's tiles: blockIdx.x + gridDim.x * m
  unsigned ring_it;    // ring items consumed before this pass
};

// What a pass stages besides x, the stored terms, a0 and P: r (g on the
// first iteration), p once written, s when applying and once written.
struct Pass {
  bool first, p_ok, s_ok;
};

// The producer's wait for a stage to empty: a short sleep between tries,
// so that its lane takes no issue slots from the consumer warps while the
// ring is full (a stage that never empties traps after ~10 s, as
// mbar_wait does).
__device__ __forceinline__ void mbar_wait_idle(uint64_t* bar,
                                               uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  long long t0 = 0;
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    __nanosleep(64);
    if (t0 == 0) t0 = clock64();
    else if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// The producer warp: ring items [from, to) of this pass, item q being
// chunk q % chunks of the block's tile q / chunks.  Lane 0 waits for the
// stage to empty; the lanes copy one stream each (1-D bulk copies of its
// span, the array's last partial 16 bytes by plain copies), then lane 0
// arrives on the stage's full barrier.
template <typename T>
__device__ void produce(const AnyParams& P, const Block& S, const Pass& ps,
                        int from, int to) {
  const Plan& L = P.L;
  const int lane = threadIdx.x & 31;
  const long long n = P.n;
  constexpr int sz = sizeof(T);
  const T* rsrc = static_cast<const T*>(ps.first ? P.g : P.r);
  for (int q = from; q < to; ++q) {
    const unsigned it = S.ring_it + q;
    const int st = it % L.stages;
    const int m = q / L.chunks, ch = q - m * L.chunks;
    const long long i0 =
        ((long long)blockIdx.x + (long long)gridDim.x * m) * kTileElems;
    const long long cnt = n - i0 < kTileElems ? n - i0 : kTileElems;
    unsigned char* stage = S.ring + (long long)st * L.stage_bytes;
    if (lane == 0) mbar_wait_idle(&S.empty[st], ((it / L.stages) & 1u) ^ 1u);
    __syncwarp();
    // stream c: 0 r, 1 p, 2 x, 3 s, 4 a0, 5 P, 6 + t the chunk's t-th weight
    const int t0 = ch * L.group;
    int nt = L.ks - t0;
    if (nt > L.group) nt = L.group;
    for (int c = lane; c < 6 + nt; c += 32) {
      const void* src = nullptr;
      int off = 0, es = 4;
      if (ch == 0) {
        if (c == 0) { src = rsrc; off = 0; es = sz; }
        else if (c == 1 && ps.p_ok) { src = P.p; off = L.off_p; es = sz; }
        else if (c == 2) { src = P.x; off = L.off_x; es = sz; }
        else if (c == 3 && ps.s_ok) { src = P.s; off = L.off_s; es = sz; }
        else if (c == 4 && P.a0.mode == kTermStored) { src = P.a0.ptr; off = L.off_a0; }
        else if (c == 5 && P.prec != nullptr) { src = P.prec; off = L.off_pv; }
      }
      if (c >= 6) {
        src = S.stored[t0 + c - 6].ptr;
        off = L.off_w + (c - 6) * 4 * kTileElems;
      }
      if (src == nullptr) continue;
      const unsigned long long base = reinterpret_cast<unsigned long long>(src);
      if (es == 2)
        copy_span<__nv_bfloat16>(stage + off, base + i0 * 2, cnt * 2,
                                 base + n * 2, &S.full[st]);
      else
        copy_span<float>(stage + off, base + i0 * 4, cnt * 4, base + n * 4,
                         &S.full[st]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&S.full[st]);
  }
}

// The sums a consumer thread carries through a pass.
struct Sums {
  float acc0, acc1, acc2, acc3;   // r2.r2, a0r2.r2, |a0r2|^2, a0r2.a0p2
  double s0, s1;                  // sum y and sum f32(i) y, y = p x a0 r2
  float dot[kRegSlots];           // the stored weights' dots (own quads)
};

// The consumers' pass over the block's tiles (the Pallas kernel's half()
// body per element, :354-501; the register kernel's arithmetic).
template <typename T, int PK, bool APPLY>
__device__ void consume(const AnyParams& P, const Block& S, const Pass& ps,
                        float beta, float cs, float crr, float pend,
                        Sums& u, int tr) {
  const Plan& L = P.L;
  const int tid = threadIdx.x, warp = warp_id(), lane = tid & 31;
  const long long n = P.n;
  T* s = static_cast<T*>(P.s);
  T* r = static_cast<T*>(P.r);
  T* p = static_cast<T*>(P.p);
  const float C = S.fold[0], D = S.fold[1];
  const float aux0 = S.aux0;
  const Term a0t = P.a0;
  const int Ks = S.Ks;
  const bool chunked = L.chunks > 1;
  const float* coef = S.v.coef();
  long long ck_wait = 0, ck_q2 = 0, ck_r2 = 0, ck_dot = 0;
  const long long ck0 = kTrace ? clock64() : 0;
  for (int m = 0; m < S.ntiles; ++m) {
    const long long i0 =
        ((long long)blockIdx.x + (long long)gridDim.x * m) * kTileElems;
    const long long i = i0 + 4 * tid;
    const bool live = i < n;
    float rc[4], px[4], a0[4], a0p2[4], q2[4];
    unsigned char* stage = nullptr;
    uint32_t sb = 0;   // the stage's shared-memory address
    int st = 0;
    for (int ch = 0; ch < L.chunks; ++ch) {
      const unsigned it = S.ring_it + m * L.chunks + ch;
      st = it % L.stages;
      stage = S.ring + (long long)st * L.stage_bytes;
      sb = smem_addr(stage);
      long long ck = kTrace ? clock64() : 0;
      mbar_wait(&S.full[st], (it / L.stages) & 1u);
      if (kTrace) {
        const long long c2 = clock64();
        ck_wait += c2 - ck;
        ck = c2;
      }
      if (ch == 0) {
        if (live) {
          float pc[4], xc[4], pv[4];
          Quad<T>::ldsh(sb + Quad<T>::kBytes * tid, rc);
          if (ps.p_ok) Quad<T>::ldsh(sb + L.off_p + Quad<T>::kBytes * tid, pc);
          else for (int e = 0; e < 4; ++e) pc[e] = 0.f;
          Quad<T>::ldsh(sb + L.off_x + Quad<T>::kBytes * tid, xc);
          if (a0t.mode == kTermStored) {
            Quad<float>::ldsh(sb + L.off_a0 + 16 * tid, a0);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              a0[e] = __fadd_rn(a0t.c, __fmul_rn(a0t.b, f32_of(i + e)));
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) a0[e] = a0_form(a0t, a0[e], aux0);
          if (PK == kPrecStored) Quad<float>::ldsh(sb + L.off_pv + 16 * tid, pv);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (PK == kPrecJacobi) pv[e] = prec_of(PK, P, a0[e], 0);
            if (i + e >= n) {   // past n: zeros (no rsqrt(0), no NaN)
              rc[e] = pc[e] = xc[e] = a0[e] = pv[e] = 0.f;
            }
          }
          if (PK == kPrecNone) {
#pragma unroll
            for (int e = 0; e < 4; ++e) px[e] = xc[e];
          } else {
            // r0 is ghat = p g, stored: the Pallas init pass writes it to r
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if (ps.first) rc[e] = Store<T>::rounded(pv[e] * rc[e]);
              a0[e] = (pv[e] * pv[e]) * a0[e];
              px[e] = pv[e] * xc[e];
            }
          }
          float p2[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            p2[e] = ps.first ? -rc[e] : -rc[e] + beta * pc[e];
            a0p2[e] = a0[e] * p2[e];
            // the weight 1 and the generated weights, folded: sum_j
            // (B mp_k)_j w_j(i) = C + D f32(i)
            q2[e] = a0p2[e] + (C + D * f32_of(i + e)) * px[e];
          }
          if (APPLY) {
            // the s and p buffers hold garbage (possibly NaN) before their
            // first write, and 0 * NaN = NaN: select, don't scale
            float sc[4];
            if (ps.s_ok) Quad<T>::ldsh(sb + L.off_s + Quad<T>::kBytes * tid, sc);
            else for (int e = 0; e < 4; ++e) sc[e] = 0.f;
#pragma unroll
            for (int e = 0; e < 4; ++e)
              sc[e] = sc[e] + (ps.p_ok ? pend * pc[e] : 0.f) + cs * p2[e];
            stg_quad<T>(s, i, n, sc);
          }
          stg_quad<T>(p, i, n, p2);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) rc[e] = px[e] = a0[e] = a0p2[e] = q2[e] = 0.f;
        }
      }
      // the chunk's stored weights: q2 += (B mp_k)_j w_j p x
      {
        const int t0 = ch * L.group;
        int nt = Ks - t0;
        if (nt > L.group) nt = L.group;
        if (live) {
          const uint32_t w = sb + L.off_w + 16 * tid;
#pragma unroll 4
          for (int t = 0; t < nt; ++t) {
            float wv[4];
            Quad<float>::ldsh(w + t * 4 * kTileElems, wv);
            const float cj = coef[t0 + t];
#pragma unroll
            for (int e = 0; e < 4; ++e) q2[e] = q2[e] + cj * (wv[e] * px[e]);
          }
        }
      }
      if (ch + 1 < L.chunks) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&S.empty[st]);
      }
      if (kTrace) ck_q2 += clock64() - ck;
    }
    long long ck = kTrace ? clock64() : 0;
    // r2, the four dots, y = p x a0 r2 and the folded weights' two sums
    float y[4];
    {
      float t0 = 0.f, t1 = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float r2 = rc[e] + crr * q2[e];
        const float a0r2 = a0[e] * r2;
        u.acc0 += r2 * r2;
        u.acc1 += a0r2 * r2;
        u.acc2 += a0r2 * a0r2;
        u.acc3 += a0r2 * a0p2[e];
        rc[e] = r2;
        y[e] = px[e] * a0r2;
        t0 += y[e];
        t1 += f32_of(i + e) * y[e];
      }
      u.s0 += (double)t0;
      u.s1 += (double)t1;
      if (live) stg_quad<T>(r, i, n, rc);
    }
    if (kTrace) {
      const long long c2 = clock64();
      ck_r2 += c2 - ck;
      ck = c2;
    }
    // the stored weights' dots w_q . y over the thread's own quad (its
    // staged t again below the chunk line, through L2 above it; 0 past n)
    auto wquad = [&](int q, float (&wv)[4]) {
      if (!live) {
#pragma unroll
        for (int e = 0; e < 4; ++e) wv[e] = 0.f;
      } else if (chunked) {
        ldg_quad<float>(S.stored[q].ptr, i, n, wv);
      } else {
        Quad<float>::ldsh(sb + L.off_w + q * 4 * kTileElems + 16 * tid, wv);
        if (i + 4 > n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) wv[e] = i + e < n ? wv[e] : 0.f;
        }
      }
    };
    // one register a weight up to kRegSlots, kept through the pass
#pragma unroll
    for (int q = 0; q < kRegSlots; ++q) {
      if (q < Ks) {
        float wv[4];
        wquad(q, wv);
        float t = wv[0] * y[0];
        t = t + wv[1] * y[1];
        t = t + wv[2] * y[2];
        t = t + wv[3] * y[3];
        u.dot[q] += t;
      }
    }
    // past them, eight weights at a time (their loads in flight
    // together), a tile's part of each warp is summed over the lanes and
    // added into the warp's shared slot in double (one lane, a fixed order)
    for (int q0 = kRegSlots; q0 < Ks; q0 += 8) {
      float t[8];
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        t[b] = 0.f;
        if (q0 + b < Ks) {
          float wv[4];
          wquad(q0 + b, wv);
          t[b] = wv[0] * y[0];
          t[b] = t[b] + wv[1] * y[1];
          t[b] = t[b] + wv[2] * y[2];
          t[b] = t[b] + wv[3] * y[3];
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int b = 0; b < 8; ++b)
          t[b] += __shfl_down_sync(0xffffffffu, t[b], off);
      }
      if (lane == 0) {
#pragma unroll
        for (int b = 0; b < 8; ++b)
          if (q0 + b < Ks) S.slots[warp * Ks + q0 + b] += (double)t[b];
      }
    }
    if (kTrace) ck_dot += clock64() - ck;
    __syncwarp();
    if (lane == 0) mbar_arrive(&S.empty[st]);
  }
  // r, p and s were written by the generic proxy; the next pass reads them
  // by bulk copies (the async proxy)
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
  if (kTrace) {
    trace_add(tr, 7, ck_wait);
    trace_add(tr, 8, ck_q2);
    trace_add(tr, 9, ck_r2);
    trace_add(tr, 10, ck_dot);
    trace_add(tr, 11, clock64() - ck0);
  }
}

// The frozen second half of a pair: s <- s + pend p over the consumer's
// own quads (the pass's mapping: tile blockIdx.x + gridDim.x m, quad tid).
template <typename T>
__device__ void frozen_apply(const AnyParams& P, const Block& S,
                             const Carry& c, float pend) {
  const int tid = threadIdx.x;
  if (tid >= kConsumers) return;
  T* s = static_cast<T*>(P.s);
  const T* p = static_cast<const T*>(P.p);
  for (int m = 0; m < S.ntiles; ++m) {
    const long long i =
        ((long long)blockIdx.x + (long long)gridDim.x * m) * kTileElems +
        4 * tid;
    if (i >= P.n) continue;
    float sc[4], pc[4];
    if (c.s_valid != 0.f) ldg_quad<T>(s, i, P.n, sc);
    else for (int e = 0; e < 4; ++e) sc[e] = 0.f;
    if (c.p_valid != 0.f) ldg_quad<T>(p, i, P.n, pc);
    else for (int e = 0; e < 4; ++e) pc[e] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      sc[e] = sc[e] + ((c.p_valid != 0.f) ? pend * pc[e] : 0.f);
    stg_quad<T>(s, i, P.n, sc);
  }
}

// One CG iteration (the Pallas kernel's half(), :354-501; the register
// kernel's half() with the K-sized algebra spread over the block).
template <typename T, int PK, bool APPLY>
__device__ float half(cg::grid_group& grid, const AnyParams& P, Block& S,
                      Carry& c, float pend) {
  const Plan& L = P.L;
  const int K = S.K;
  const Vecs& V = S.v;
  const int tid = threadIdx.x;
  const int warp = warp_id();
  const int lane = tid & 31;

  const bool frozen = (c.done != 0.f) || (c.k >= P.max_iterations) ||
                      (sqrtf(c.rv) <= S.target);
  if (frozen) {
    // only reachable as the second half of a pair: s <- s + pend * p
    if (APPLY) {
      frozen_apply<T>(P, S, c, pend);
      c.s_valid = 1.f;
    }
    return 0.f;
  }

  const int tr = c.it++;
  trace(tr, 0);
  const bool first = c.rv_prev == 0.f;
  const float beta = first ? 0.f : c.rv / c.rv_prev;
  Pass ps;
  ps.first = first;
  ps.p_ok = c.p_valid != 0.f;
  ps.s_ok = APPLY && c.s_valid != 0.f;
  const int items = S.ntiles * L.chunks;
  // the producer fills the ring while the block does the K-sized algebra
  const int pre = !kPrefill ? 0 : items < L.stages ? items : L.stages;
  if (warp == kCWarps) produce<T>(P, S, ps, 0, pre);
  trace_by(tr, 12, kConsumers);

  // ---- the K-sized algebra, once per block ----
  for (int j = tid; j < K; j += blockDim.x) {
    V.mpk()[j] = -V.m()[j] + beta * V.mp()[j];
    V.mB2()[j] = -V.mA()[j] + beta * V.mB()[j];
  }
  for (int q = tid; q < kCWarps * S.Ks; q += blockDim.x) S.slots[q] = 0.0;
  matvec(S.Bt, V.m(), V.Bm(), K);
  matvec(S.Bt, V.mp(), V.Bmp(), K);
  __syncthreads();
  trace(tr, 13);
  matvec(S.UU, V.Bm(), V.UUBm(), K);
  matvec(S.UU, V.Bmp(), V.UUBmp(), K);
  matvec(S.Bt, V.mpk(), V.Bmpk(), K);
  __syncthreads();
  matvec(S.UU, V.Bmpk(), V.UUBmpk(), K);
  for (int q = tid; q < S.Ks; q += blockDim.x)
    V.coef()[q] = V.Bmpk()[S.stored[q].idx] * S.stored[q].scale;
  if (warp < kCWarps) {
    // the eight K-dots, one a warp: m.Bm, mA.Bm, Bm.UUBm, mA.Bmp, Bm.mB,
    // Bm.UUBmp, mB.Bmp, Bmp.UUBmp
    constexpr int kA[kCWarps] = {0, 1, 4, 1, 4, 4, 2, 5};
    constexpr int kB[kCWarps] = {4, 4, 6, 5, 2, 7, 5, 7};
    int qa = 0, qb = 0;
#pragma unroll
    for (int w = 0; w < kCWarps; ++w)
      if (w == warp) {
        qa = kA[w];
        qb = kB[w];
      }
    const float d = warp_dot(V.at(qa), V.at(qb), K);
    if (lane == 0) S.dots[warp] = d;
  } else {
    // the producer warp folds the weight 1 and the generated weights:
    // C = sum_j (B mp_k)_j c_j, D = sum_j (B mp_k)_j b_j, in double
    double cc = 0.0, dd = 0.0;
    for (int q = lane; q < S.Kf; q += 32) {
      const FoldedTerm f = S.folded[q];
      const double bj = V.Bmpk()[f.idx];
      cc += bj * f.c;
      dd += bj * f.b;
    }
    cc = warp_sum(cc);
    dd = warp_sum(dd);
    if (lane == 0) {
      S.fold[0] = (float)cc;
      S.fold[1] = (float)dd;
    }
  }
  __syncthreads();
  trace(tr, 1);

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
  // The carry advances here, before the pass (after a boundary step the
  // loop exits and only k, bnd, sk2, mval and the valid flags are read).
  c.nAp = c.nr - 2.f * beta * c.pa + beta * beta * c.nAp;
  c.rv_prev = c.rv;
  c.alpha_prev = alpha;
  c.pr_c = pr_k;
  c.kappa_prev = kappa;
  c.s_p = sp_k;
  c.pp_prev = pp_k;
  c.mval = m_new;
  c.rv = c.ar = c.nr = c.pa = 0.f;   // the pass's sums, unless a boundary

  // ---- the streamed pass ----
  Sums u;
  u.acc0 = u.acc1 = u.acc2 = u.acc3 = 0.f;
  u.s0 = u.s1 = 0.0;
#pragma unroll
  for (int q = 0; q < kRegSlots; ++q) u.dot[q] = 0.f;
  if (warp == kCWarps) produce<T>(P, S, ps, pre, items);
  else consume<T, PK, APPLY>(P, S, ps, beta, cs, crr, pend, u, tr);
  S.ring_it += items;

  // the recurrences m, mB, mp (the pass reads none of them)
  for (int j = tid; j < K; j += blockDim.x) {
    V.m()[j] = V.m()[j] + crr * (V.mB2()[j] + V.UUBmpk()[j]);
    V.mB()[j] = V.mB2()[j];
    V.mp()[j] = V.mpk()[j];
  }
  trace(tr, 2);

  if (!boundary) {
    // after a boundary step the loop exits: the dot group would be unused.
    // Block sums in double: the six scalars and the stored weights' dots
    // by warp shuffle, then a fixed order over the warps.
    const long long G = gridDim.x;
    const double a6[6] = {u.acc0, u.acc1, u.acc2, u.acc3, u.s0, u.s1};
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      const double v = warp_sum(a6[a]);
      if (lane == 0) S.red[warp * 6 + a] = v;
    }
#pragma unroll
    for (int q = 0; q < kRegSlots; ++q) {
      if (warp < kCWarps && q < S.Ks) {
        const double v = warp_sum((double)u.dot[q]);
        if (lane == 0) S.slots[warp * S.Ks + q] = v;
      }
    }
    __syncthreads();
    if (tid < 6) {
      double v = 0.0;
      for (int w = 0; w < kWarps; ++w) v += S.red[w * 6 + tid];
      S.part[tid * G + blockIdx.x] = v;
    }
    for (int q = tid; q < S.Ks; q += blockDim.x) {
      double v = 0.0;
      for (int w = 0; w < kCWarps; ++w) v += S.slots[w * S.Ks + q];
      S.part[(6 + q) * G + blockIdx.x] = v;
    }
    trace(tr, 3);
    grid_sum(grid, S.part, S.tot, half_entries(S.Ks), tr);
    c.rv = (float)S.tot[0];
    c.ar = (float)S.tot[1];
    c.nr = (float)S.tot[2];
    c.pa = (float)S.tot[3];
    for (int q = tid; q < S.Ks; q += blockDim.x)
      V.mA()[S.stored[q].idx] = (float)(S.stored[q].scale * S.tot[6 + q]);
    for (int q = tid; q < S.Kf; q += blockDim.x) {
      const FoldedTerm f = S.folded[q];
      V.mA()[f.idx] = (float)((double)f.c * S.tot[4] + (double)f.b * S.tot[5]);
    }
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

// (ba, bb) of block q of the row-major upper triangle of Rb x Rb 4-row
// blocks
__device__ __forceinline__ void block_of(int q, int Rb, int& ba, int& bb) {
  ba = 0;
  while (q >= Rb - ba) {
    q -= Rb - ba;
    ++ba;
  }
  bb = ba + q;
}

// The init pass (unless init= is threaded): the producer stages the
// block's tiles as a pass does (g in r's place, x, a stored a0 or P, the
// stored weights), and the consumers form the Gram of
//
//   V' = (ghat, a0 ghat, p x, (f32(i) - h) p x, t_q p x for each stored q)
//
// (ghat = p g; h = f32(n / 2)): every folded weight's u_j = (c_j + b_j
// f32(i)) p x is (c_j + b_j h) times row 2 plus b_j times row 3, so V'V'
// has (4 + Ks)(5 + Ks)/2 pairs instead of V'V's (K + 2)(K + 3)/2, and
// init_expand assembles V'V from it.  Rows 0-3 go to the basis buffer, a
// stored weight's row replaces its staged t (below the chunk line; above
// it, the block's slice).  Each consumer thread owns a 4 x 4 block of
// pairs and a slice of the tile's quads (16 products for 8 shared-memory
// reads an element), the slices meet by shuffle, and each pair's block sum
// is kept in double: in registers for the first round of blocks, added
// into its slot past it.
template <typename T, int PK>
__device__ void init_consume(const AnyParams& P, const Block& S, float* rows,
                             float* vrows, double* part, float h) {
  const Plan& L = P.L;
  const int tid = threadIdx.x, lane = tid & 31, warp = warp_id();
  const long long n = P.n;
  const long long G = gridDim.x;
  const int Ks = S.Ks;
  const int Rp = 4 + Ks;
  const int Rb = (Rp + 3) / 4;
  const int nb = Rb * (Rb + 1) / 2;
  int E = 1;
  while (E < 32 && nb * E * 2 <= kConsumers) E *= 2;
  const int sl = tid % E;
  const int per = kConsumers / E;
  const bool chunked = L.chunks > 1;
  const Term a0t = P.a0;
  for (long long q = tid; q < init_pairs(Ks); q += kConsumers)
    part[q * G + blockIdx.x] = 0.0;
  double dacc[16];
#pragma unroll
  for (int q = 0; q < 16; ++q) dacc[q] = 0.0;
  long long ck_wait = 0, ck_rows = 0, ck_pairs = 0, ck_bars = 0;
  const long long ck0 = kTrace ? clock64() : 0;
  for (int m = 0; m < S.ntiles; ++m) {
    const long long i0 =
        ((long long)blockIdx.x + (long long)gridDim.x * m) * kTileElems;
    const long long i = i0 + 4 * tid;
    float px[4];
    unsigned char* stage = nullptr;
    int st = 0;
    for (int ch = 0; ch < L.chunks; ++ch) {
      const unsigned it = S.ring_it + m * L.chunks + ch;
      st = it % L.stages;
      stage = S.ring + (long long)st * L.stage_bytes;
      const uint32_t sb = smem_addr(stage);
      long long ck = kTrace ? clock64() : 0;
      mbar_wait(&S.full[st], (it / L.stages) & 1u);
      if (kTrace) {
        const long long c2 = clock64();
        ck_wait += c2 - ck;
        ck = c2;
      }
      if (ch == 0) {
        float gc[4], xc[4], a0[4], pv[4], r1[4], r3[4];
        Quad<T>::ldsh(sb + Quad<T>::kBytes * tid, gc);
        Quad<T>::ldsh(sb + L.off_x + Quad<T>::kBytes * tid, xc);
        if (a0t.mode == kTermStored) {
          Quad<float>::ldsh(sb + L.off_a0 + 16 * tid, a0);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            a0[e] = __fadd_rn(a0t.c, __fmul_rn(a0t.b, f32_of(i + e)));
        }
        if (PK == kPrecStored) Quad<float>::ldsh(sb + L.off_pv + 16 * tid, pv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          a0[e] = a0_form(a0t, a0[e], S.aux0);
          if (PK == kPrecJacobi) pv[e] = prec_of(PK, P, a0[e], 0);
          if (i + e >= n) gc[e] = xc[e] = a0[e] = pv[e] = 0.f;
          if (PK != kPrecNone) {
            gc[e] = pv[e] * gc[e];
            a0[e] = (pv[e] * pv[e]) * a0[e];
            px[e] = pv[e] * xc[e];
          } else {
            px[e] = xc[e];
          }
          r1[e] = a0[e] * gc[e];
          r3[e] = (f32_of(i + e) - h) * px[e];
        }
        float4* rq = reinterpret_cast<float4*>(rows) + tid;
        rq[0] = make_float4(gc[0], gc[1], gc[2], gc[3]);
        rq[kConsumers] = make_float4(r1[0], r1[1], r1[2], r1[3]);
        rq[2 * kConsumers] = make_float4(px[0], px[1], px[2], px[3]);
        rq[3 * kConsumers] = make_float4(r3[0], r3[1], r3[2], r3[3]);
      }
      // the chunk's stored rows t p x (0 past n: the stage holds stale
      // bytes there)
      const int t0 = ch * L.group;
      int nt = Ks - t0;
      if (nt > L.group) nt = L.group;
      for (int t = 0; t < nt; ++t) {
        const uint32_t w = sb + L.off_w + t * 4 * kTileElems + 16 * tid;
        float wv[4];
        Quad<float>::ldsh(w, wv);
#pragma unroll
        for (int e = 0; e < 4; ++e) wv[e] = i + e < n ? wv[e] * px[e] : 0.f;
        if (chunked)
          *reinterpret_cast<float4*>(vrows + (long long)(t0 + t) * kTileElems +
                                     4 * tid) =
              make_float4(wv[0], wv[1], wv[2], wv[3]);
        else
          sts_quad(w, wv);
      }
      // generic writes into a stage before its bulk copies land again
      fence_proxy_async();
      if (ch + 1 < L.chunks) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&S.empty[st]);
      }
      if (kTrace) ck_rows += clock64() - ck;
    }
    long long ck = kTrace ? clock64() : 0;
    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
    if (kTrace) {
      const long long c2 = clock64();
      ck_bars += c2 - ck;
      ck = c2;
    }
    const float* wrow = chunked ? vrows
                                : reinterpret_cast<const float*>(
                                      stage + L.off_w);
    for (int b0 = 0, round = 0; b0 < nb; b0 += per, ++round) {
      // a warp whose blocks all lie past the last has nothing this round
      if (b0 + 32 / E * warp >= nb) continue;
      const int bq = b0 + tid / E;
      const bool act = bq < nb;
      int ba, bb;
      block_of(act ? bq : 0, Rb, ba, bb);
      const float* ra[4];
      const float* rb[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        int r = 4 * ba + q < Rp ? 4 * ba + q : Rp - 1;
        ra[q] = r < 4 ? rows + (long long)r * kTileElems
                      : wrow + (long long)(r - 4) * kTileElems;
        r = 4 * bb + q < Rp ? 4 * bb + q : Rp - 1;
        rb[q] = r < 4 ? rows + (long long)r * kTileElems
                      : wrow + (long long)(r - 4) * kTileElems;
      }
      float acc[16];
#pragma unroll
      for (int q = 0; q < 16; ++q) acc[q] = 0.f;
      for (int qd = sl; qd < kConsumers; qd += E) {
        float4 va[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          va[q] = reinterpret_cast<const float4*>(ra[q])[qd];
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const float4 vb = reinterpret_cast<const float4*>(rb[b])[qd];
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            float t = acc[a * 4 + b];
            t = t + va[a].x * vb.x;
            t = t + va[a].y * vb.y;
            t = t + va[a].z * vb.z;
            t = t + va[a].w * vb.w;
            acc[a * 4 + b] = t;
          }
        }
      }
      // the slices of a block: E consecutive lanes (the 16 sums side by
      // side at each step of the tree)
      for (int off = E / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int q = 0; q < 16; ++q)
          acc[q] += __shfl_down_sync(0xffffffffu, acc[q], off, E);
      }
      if (act && sl == 0) {
        if (round == 0) {
#pragma unroll
          for (int q = 0; q < 16; ++q) dacc[q] += (double)acc[q];
        } else {
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              const int ra_ = 4 * ba + a, rb_ = 4 * bb + b;
              if (ra_ <= rb_ && rb_ < Rp)
                part[pair_index(ra_, rb_, Rp) * G + blockIdx.x] +=
                    (double)acc[a * 4 + b];
            }
        }
      }
    }
    if (kTrace) {
      const long long c2 = clock64();
      ck_pairs += c2 - ck;
      ck = c2;
    }
    // every row read before the next tile's are written
    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
    if (kTrace) ck_bars += clock64() - ck;
    __syncwarp();
    if (lane == 0) mbar_arrive(&S.empty[st]);
  }
  if (kTrace) {
    trace_init_add(4, ck_wait);
    trace_init_add(5, ck_rows);
    trace_init_add(6, ck_pairs);
    trace_init_add(7, ck_bars);
    trace_init_add(8, clock64() - ck0);
  }
  if (tid / E < nb && sl == 0) {
    int ba, bb;
    block_of(tid / E, Rb, ba, bb);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int ra_ = 4 * ba + a, rb_ = 4 * bb + b;
        if (ra_ <= rb_ && rb_ < Rp)
          part[pair_index(ra_, rb_, Rp) * G + blockIdx.x] = dacc[a * 4 + b];
      }
  }
}

// The init group from V'V' (tot, after the grid sum): rv0, ar0, nr0, and
// m0 = U'ghat, mA0 = U'(a0 ghat) into the K-vectors and U'U into `uu`, in
// double from the pairs, the same in every block.  A table entry's u is
// scale_q times row 4 + q (stored), or (c + b h) row 2 + b row 3
// (folded); U'U is filled symmetric.
__device__ void init_expand(const Block& S, float h, float* uu, float& rv0,
                            float& ar0, float& nr0) {
  const int K = S.K, Ks = S.Ks, Rp = 4 + Ks;
  const double* t = S.tot;
  auto G = [&](int a, int b) {
    return a <= b ? t[pair_index(a, b, Rp)] : t[pair_index(b, a, Rp)];
  };
  // entry e's u . V'_r
  auto ur = [&](int e, int r) -> double {
    if (e < Ks) return (double)S.stored[e].scale * G(4 + e, r);
    const FoldedTerm f = S.folded[e - Ks];
    return ((double)f.c + (double)f.b * h) * G(2, r) + (double)f.b * G(3, r);
  };
  auto idx = [&](int e) {
    return e < Ks ? S.stored[e].idx : S.folded[e - Ks].idx;
  };
  rv0 = (float)G(0, 0);
  ar0 = (float)G(0, 1);
  nr0 = (float)G(1, 1);
  for (int e = threadIdx.x; e < K; e += blockDim.x) {
    S.v.m()[idx(e)] = (float)ur(e, 0);
    S.v.mA()[idx(e)] = (float)ur(e, 1);
  }
  for (long long q = threadIdx.x; q < (long long)K * K; q += blockDim.x) {
    int e1 = (int)(q / K), e2 = (int)(q % K);
    if (e1 > e2) {
      const int w = e1;
      e1 = e2;
      e2 = w;
    }
    double v;
    if (e2 < Ks) {
      v = (double)S.stored[e2].scale * ur(e1, 4 + e2);
    } else {
      const FoldedTerm f = S.folded[e2 - Ks];
      v = ((double)f.c + (double)f.b * h) * ur(e1, 2) +
          (double)f.b * ur(e1, 3);
    }
    uu[(long long)idx((int)(q / K)) * K + idx((int)(q % K))] = (float)v;
  }
}

// One block an SM (its ring fills the SM's shared memory; f32 and bf16 run
// the same quads, 4 elements a thread).
template <typename T, int PK>
__global__ void __launch_bounds__(kThreads, 1)
    streamed_cg_any_kernel(const __grid_constant__ AnyParams P) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const Plan& L = P.L;
  const int K = L.k;
  const int tid = threadIdx.x;
  const Scratch X = scratch_of(L, P.with_init, gridDim.x);
  unsigned char* slice = P.scratch + X.blocks + blockIdx.x * L.block_bytes;

  Block S;
  S.K = K;
  S.Ks = L.ks;
  S.Kf = K - L.ks;
  S.full = reinterpret_cast<uint64_t*>(smem);
  S.empty = S.full + kRingStages;
  S.red = reinterpret_cast<double*>(smem + 64);
  S.dots = reinterpret_cast<float*>(smem + 64 + 8 * 6 * kWarps);
  S.fold = S.dots + kCWarps;
  S.part = reinterpret_cast<double*>(P.scratch);
  S.tot = reinterpret_cast<double*>(P.scratch + X.tot);
  const unsigned char* tables = P.tables;
  if (L.tables_smem) {
    unsigned char* t = smem + L.tables_off;
    for (int q = tid; q < 4 * K; q += blockDim.x)
      reinterpret_cast<uint32_t*>(t)[q] =
          reinterpret_cast<const uint32_t*>(P.tables)[q];
    tables = t;
  }
  S.stored = reinterpret_cast<const StoredTerm*>(tables);
  S.folded = reinterpret_cast<const FoldedTerm*>(tables + 16LL * L.ks);
  S.v.base = reinterpret_cast<float*>((L.vecs_smem ? smem : slice) +
                                      L.vecs_off);
  S.v.K = K;
  S.slots = reinterpret_cast<double*>((L.slots_smem ? smem : slice) +
                                      L.slots_off);
  S.ring = smem + L.ring_off;
  const long long ntiles_all = (P.n + kTileElems - 1) / kTileElems;
  S.ntiles = (int)((ntiles_all - blockIdx.x + gridDim.x - 1) / gridDim.x);
  S.ring_it = 0;
  if (tid == 0) {
    for (int s = 0; s < kRingStages; ++s) {
      mbar_init(&S.full[s], 1);
      mbar_init(&S.empty[s], kCWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const float Delta = P.scal[0];
  S.Delta2 = Delta * Delta;
  S.aux0 = P.n_aux > 0 ? P.scal[1] : 0.f;
  S.eps2 = P.epsilon * P.epsilon;

  // rv0, ar0, nr0; m0, mA0 into the K-vectors; U'U into shared memory
  // below the line, read in place (init=) or from the slice above it
  float rv0, ar0, nr0;
  const float* uu_src;
  float* mats = reinterpret_cast<float*>(smem + L.mats_off);
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
    // the ring's first items are the init pass's
    const float h = f32_of(P.n / 2);
    float* rows = reinterpret_cast<float*>((L.rows_smem ? smem : slice) +
                                           L.rows_off);
    const int items = S.ntiles * L.chunks;
    trace_init(0);
    if (warp_id() == kCWarps) {
      Pass ps;
      ps.first = true;
      ps.p_ok = ps.s_ok = false;
      produce<T>(P, S, ps, 0, items);
    } else {
      init_consume<T, PK>(P, S, rows,
                          reinterpret_cast<float*>(slice + L.vrows_off),
                          S.part, h);
    }
    trace_init(1);
    S.ring_it += items;
    grid_sum(grid, S.part, S.tot, init_pairs(L.ks));
    trace_init(2);
    float* uu = L.mats_smem ? mats + (long long)K * K
                            : reinterpret_cast<float*>(slice + L.uu_off);
    init_expand(S, h, uu, rv0, ar0, nr0);
    uu_src = uu;
  }
  // B': copied into shared memory below the line, read in place above it
  if (L.mats_smem) {
    float* uu = mats + (long long)K * K;
    for (long long q = tid; q < (long long)K * K; q += blockDim.x) {
      mats[q] = P.Bt[q];
      if (P.with_init) uu[q] = uu_src[q];
    }
    S.Bt = mats;
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

  trace_init(3);
  const float r0n = sqrtf(rv0);
  S.target = r0n * fminf(P.kappa_fgr, pow_static(r0n, P.theta));

  Carry c;
  c.k = 0;
  c.it = 0;
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

  // the tail: each consumer thread rewrites its own quads (the pass's
  // mapping), so no grid.sync is needed
  T* s = static_cast<T*>(P.s);
  if (tid < kConsumers) {
    for (int m = 0; m < S.ntiles; ++m) {
      const long long i =
          ((long long)blockIdx.x + (long long)gridDim.x * m) * kTileElems +
          4 * tid;
      if (i >= P.n) continue;
      if (c.s_valid == 0.f) {
        // no CG step was taken (g = 0, or max_iterations = 0): s = 0
        const float z[4] = {};
        stg_quad<T>(s, i, P.n, z);
      } else if (PK != kPrecNone) {
        // un-transform s = p shat
        float sc[4], pr[4];
        ldg_quad<T>(s, i, P.n, sc);
        if (PK == kPrecStored) {
          ldg_quad<float>(P.prec, i, P.n, pr);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const Term& t = P.a0;
            const float v = i + e >= P.n ? 0.f
                            : t.mode == kTermStored
                                ? t.ptr[i + e]
                                : __fadd_rn(t.c, __fmul_rn(t.b, f32_of(i + e)));
            pr[e] = i + e < P.n ? prec_of(PK, P, a0_form(t, v, S.aux0), 0)
                                : 0.f;
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[e] = sc[e] * pr[e];
        stg_quad<T>(s, i, P.n, sc);
      }
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

// The instance's plan on this card (its shared memory budget: the opt-in
// maximum a block less the kernel's static shared memory, none), with the
// dynamic shared memory allowed to the function.
cudaError_t plan_of(int bf16, int prec_kind, int k, int ks, int a0_stored,
                    int with_init, Plan* L) {
  const void* fn = kernel_of(bf16, prec_kind);
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return e;
  *L = make_plan(k, ks, a0_stored, prec_kind == kPrecStored,
                 bf16 ? 2 : 4, with_init,
                 (long long)optin - (long long)attr.sharedSizeBytes);
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)L->smem_bytes);
}

bool valid_counts(int k, int ks) { return k >= 1 && ks >= 0 && ks <= k; }

}  // namespace

extern "C" {

// Number of blocks the launch for n elements uses (one an SM at most, for
// this instance's shared memory) and the bytes of global scratch it needs.
// prec_kind: 0 none, 1 the generated shifted-Jacobi power, 2 stored p;
// ks the stored weights, a0_stored whether a0 is read.
int streamed_cg_any_grid(int bf16, int prec_kind, int k, int ks,
                         int a0_stored, int with_init, long long n, int* grid,
                         long long* scratch_bytes) {
  if (!valid_counts(k, ks)) return (int)cudaErrorInvalidValue;
  Plan L;
  cudaError_t e = plan_of(bf16, prec_kind, k, ks, a0_stored, with_init, &L);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel_of(bf16, prec_kind), kThreads, (size_t)L.smem_bytes);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long cap = (long long)per_sm * sms;
  long long want = (n + kTileElems - 1) / kTileElems;
  if (want < 1) want = 1;
  *grid = (int)(want < cap ? want : cap);
  *scratch_bytes = scratch_of(L, with_init, *grid).bytes;
  return (int)cudaSuccess;
}

// The plan for rank k with ks stored weights (kernels/streamed_cg.py:
// AnyKPlan's fields in order): group, chunks, stages, stage bytes,
// the placements (1 = shared memory) of the tables, the K-vectors, the dot
// slots, B' and U'U and the init pass's basis rows, and the dynamic shared
// memory.
int streamed_cg_any_plan(int bf16, int prec_kind, int k, int ks,
                         int a0_stored, int with_init, long long* out) {
  if (!valid_counts(k, ks)) return (int)cudaErrorInvalidValue;
  Plan L;
  cudaError_t e = plan_of(bf16, prec_kind, k, ks, a0_stored, with_init, &L);
  if (e != cudaSuccess) return (int)e;
  const long long v[] = {L.group, L.chunks, L.stages, L.stage_bytes, L.tables_smem, L.vecs_smem,
                         L.slots_smem, L.mats_smem, L.rows_smem,
                         L.smem_bytes};
  for (int q = 0; q < (int)(sizeof(v) / sizeof(v[0])); ++q) out[q] = v[q];
  return (int)cudaSuccess;
}

// The trace (kTrace): copy n entries out, or (clear) zero them.
int streamed_cg_any_trace(long long* out, int n, int clear) {
  if (clear) {
    static const long long zeros[(kTraceIters + 1) * kTraceEvents] = {};
    return (int)cudaMemcpyToSymbol(g_trace, zeros, sizeof(zeros));
  }
  return (int)cudaMemcpyFromSymbol(out, g_trace, n * sizeof(long long));
}

const char* streamed_cg_any_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launch one subproblem on `stream`.  `a0_term` is a host Term (a0's
// descriptor); `tables` a device array of ks StoredTerm then k - ks
// FoldedTerm; `Bt` is B' (k x k row-major); `scratch` holds
// streamed_cg_any_grid's bytes.  Returns a cudaError_t code: the
// cooperative launch's own refusal, or cudaGetLastError() after it.
int streamed_cg_any_launch(int bf16, int prec_kind, int k, int ks,
                           const void* g, const void* x, const void* a0_term,
                           const void* tables, void* s, void* r, void* p,
                           const float* scal, int n_aux, const float* Bt,
                           float* res, void* scratch, int grid, long long n,
                           int max_iterations, float kappa_fgr, float theta,
                           float epsilon, int pair, int with_init,
                           const float* prec, float prec_c, int prec_quarter,
                           void* stream) {
  if (!valid_counts(k, ks)) return (int)cudaErrorInvalidValue;
  AnyParams P;
  // (a pointer to the namespace-local Term in this extern "C" signature
  // would take the symbol out of the library's exports)
  P.a0 = *static_cast<const Term*>(a0_term);
  cudaError_t e = plan_of(bf16, prec_kind, k, ks,
                          P.a0.mode == kTermStored, with_init, &P.L);
  if (e != cudaSuccess) return (int)e;
  P.g = g;
  P.x = x;
  P.tables = static_cast<const unsigned char*>(tables);
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
  e = cudaLaunchCooperativeKernel(kernel_of(bf16, prec_kind), dim3(grid),
                                  dim3(kThreads), args,
                                  (size_t)P.L.smem_bytes,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
