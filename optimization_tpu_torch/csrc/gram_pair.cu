// gram_pair for the H100 (sm_90a): a TMA-fed wgmma kernel.
//
// Replaces optimization_tpu/kernels/fused.py:185 gram_pair (kernel :164,
// call :209): (S'AS, S'BS) from (m, k) row-major blocks, or a fleet of
// them (F, m, k), the LOBPCG Gram stage.  Per instance it is a split-K
// skinny product, the reduction over m = 10^4..10^5 rows, any k.
//
// What bounds it on this card: bytes, in f32 up to k ~ 150 and in bf16 at
// every k the LOBPCG calls use.  It reads 3 m k words (2 m k when BS is S,
// the LOBPCG call without B): at m = 10^5, k = 48 in f32 that is 57.6 MB
// (17.2 us at 3.35 TB/s) or 38.4 MB (11.5 us), for 2 m k^2 = 0.46 G
// multiply-adds, three times that on the TF32 tensor cores with the
// 3xTF32 split below (2.8 GFLOP, ~6 us at 495 TFLOP/s).  The products grow
// as k^2 and the bytes as k, so f32 above k ~ 150 is bound by the TF32
// rate; bf16 products (989 TFLOP/s, exact in f32) stay below the bytes.
// Measured (profile_gram_pair.py's trace and variants): bf16 at k = 48 is
// bound by the copies, f32 at k = 48 by the TF32 products (m64n48k8 runs
// near a third of the TF32 rate, tile after tile, the consumers' work
// around it not hidden), rows not 16-byte aligned by the consumers' layout
// pass.
//
// The design: one block of two consumer warpgroups and a producer
// warpgroup (one warp of it works; the others give their registers to the
// consumers) for each output panel of each row stream.
// - The product is computed transposed, D = X'S with X = [AS | BS]: the
//   wgmma M side (64-row slabs) is X's columns, the N side (np <= 128
//   columns, a multiple of 16) S's.  Warpgroup 0 owns the 64-column slab j
//   of AS, warpgroup 1 the same slab of BS (of S when BS is S); the block
//   owns S's columns n0 .. n0 + np.  k <= 64 is one panel; above, the
//   ceil(k / 64) x ceil(k / 128) panels of a row stream are blocks of
//   their own that stage their own columns (no cluster yet: their common
//   row tiles meet in L2 when they run together, as the wave is laid out).
// - The producer warp keeps row tiles in flight in a ring of shared-memory
//   stages, each guarded by a "full" and an "empty" mbarrier.  A stage
//   holds 128-byte boxes of R rows: the slab of AS, the slab of BS (or S),
//   and S's chunk (unless it is the BS slab: BS is S and k <= 64).  Rows
//   whose k elements are a multiple of 16 bytes, at 16-byte aligned bases,
//   come by 2-D (3-D with the fleet) tensor-map copies with the 128-byte
//   swizzle, rows past m and columns past k filled with zeros by the copy
//   engine.  Other rows (k = 17, 30, 97 ...; a fleet whose instances start
//   unaligned) cannot have a tensor map (its strides are multiples of 16
//   bytes, and a box starts on a 16-byte boundary).  Their tile's R rows
//   of each array are one contiguous span: one 1-D bulk copy of the
//   16-byte aligned part of it (the array's last partial 16 bytes by plain
//   copies) lands it in the stage, and the consumers move each row into
//   the swizzled layout, zeros past m and k ("span").  Where R = 32 rows
//   of all k columns leave fewer than two stages (k past ~260 in f32), each
//   row's box comes by a copy of its own ("rows").  These are routes
//   chosen by shape, not fallbacks: all end in the same layout.
// - bf16: both operands straight from shared memory, A = X' and B = S
//   both MN-major (wgmma's transpose immediates), descriptors with the
//   128-byte swizzle.  Products bf16 x bf16, exact in f32.
// - f32: TF32 wgmma takes K-major operands only, and K here is the row
//   index of row-major blocks.  A = X' comes from registers: each thread
//   gathers its fragment from the staged tile and splits it into tf32 hi
//   and lo.  B = S is transposed by the consumers into K-major swizzled hi
//   and lo buffers, two of each: tile it + 1's transposition runs while
//   tile it's products do (one named barrier a tile).  Each
//   k-step is lo*hi + hi*lo + hi*hi (3xTF32); plain 1xTF32 would break the
//   accuracy contract below.  The K order inside a k-step is permuted
//   (slot t <- row 2t, slot t + 4 <- row 2t + 1) so a warp's fragment
//   gathers fall in distinct banks; A and B use the same order.
// - The tensor cores' f32 accumulation drifts one way along a long chain
//   (on the card: S'S's diagonal at m = 100,000 off by 1.6e-5 of
//   sum|S||S| where 3,000 rows ran into one accumulator), so no wgmma chain
//   runs past one row tile (R <= 128 rows): each tile starts its
//   accumulator afresh and adds it into f32 sums by rounded adds.  The
//   accumulators therefore count twice in registers: 64 x np f32 a
//   warpgroup is np of a thread's registers, hence np <= 128.
// - Split-K over one wave of the card: block (x, panel, f) takes row tiles
//   x, x + grid, ... of instance f and writes its partial Grams; a
//   finishing kernel (a programmatic dependent launch) adds the blocks'
//   partials of each entry in block order in double and rounds once to
//   f32.  No float atomics: runs repeat bitwise.
//
// Accuracy: the JAX contract is f32 products and f32 sums.  tf32 keeps 11
// significant bits, so |x - hi| <= 2^-11 |x| and lo carries x - hi to
// 2^-22 |x|; the three kept products miss lo*lo and the lo roundings,
// under 3 2^-22 |x y| together: the per-entry error stays far inside
// 1e-5 sum_r |S[r,i] X[r,j]|, the tolerance chip_smoke.py holds it to.
//
// Plain C interface for ctypes; kernels/fused.py has the wrapper, the
// plain version and the same launch plan in Python (gram_plan).

#include <cuda.h>   // CUtensorMap and its enums; the encoder is looked up
                    // through the runtime (no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ring.cuh"

namespace {

constexpr int kConsumers = 256;              // two warpgroups
constexpr int kThreads = kConsumers + 128;   // and the producer warpgroup
constexpr int kMaxStages = 8;
constexpr int kSmemCap = 232448;             // a block's opt-in maximum
constexpr int kBarBytes = 256;               // the ring's mbarriers
constexpr int kSlack = 1024;                 // the ring starts 1024-aligned
constexpr int kNpMax = 128;                  // S columns a block
constexpr int kFinishSlices = 16;
// the finishing kernel's threads a launch aims at: about a full wave
constexpr long long kFinishThreads = 1 << 18;
// route 2's landing slot a row: 128 bytes from any of 16 offsets
constexpr int kSpan = 144;
// Each row tile's wgmma chain starts afresh and folds into f32 sums (false:
// one chain over the whole row stream, the drift the fold prevents;
// profile_gram_pair.py's no_fold variant).
constexpr bool kFoldChains = true;
// Block (0, 0) records when its producer and its first consumer thread
// pass each step of a tile (the device's ns clock) for
// profile_gram_pair.py's "trace" variant; read by gram_pair_trace.
constexpr bool kTrace = false;
constexpr int kTraceTiles = 64, kTraceEvents = 8;

// ---- the launch plan (kernels/fused.py:gram_plan is the same) ----

struct GramPlan {
  int route;      // 0: tiles by 2-D tensor map; 1: a tile's span a bulk
                  // copy; 2: each row's box a bulk copy
  int box_cols;   // columns of a 128-byte box: 32 f32, 64 bf16
  int slabs;      // 64-column M slabs of AS and of BS
  int chunks;     // N chunks of S's columns
  int np;         // columns of a chunk (a multiple of 16, <= 128)
  int panels;     // slabs x chunks blocks a row stream
  int cluster;    // blocks a cluster
  int rows;       // R, rows of a staged tile
  int stages;     // the ring's depth
  int boxes;      // boxes a stage
  int reuse;      // S's chunk is the BS slab (BS is S, one panel)
  int smem;       // dynamic shared memory bytes
};

// Bytes a stage lands unswizzled before the consumers lay them out: route
// 1 each array's span of r rows (and 32 bytes for its ends), route 2 a
// kSpan-byte slot a row and box.
inline int landing_bytes(const GramPlan& p, int size, int k, int same,
                         int r) {
  const int b = p.route == 1 ? (same ? 2 : 3) * ((r * k * size + 47) / 16 * 16)
                : p.route == 2 ? p.boxes * r * kSpan
                               : 0;
  return (b + 1023) / 1024 * 1024;
}

// The longest tile (128, 64, 32 rows) that leaves three stages, with f32's
// four transposed buffers of S's chunk beside the ring.
inline void fit(GramPlan& p, int bf16, int k, int same) {
  const int size = bf16 ? 2 : 4;
  const int budget = kSmemCap - kSlack - kBarBytes;
  for (int r = 128; r >= 32; r /= 2) {
    const int stage = p.boxes * r * 128 + landing_bytes(p, size, k, same, r);
    const int trans = bf16 ? 0 : 4 * p.np * r * 4;
    int st = (budget - trans) / stage;
    if (st > kMaxStages) st = kMaxStages;
    p.rows = r;
    p.stages = st;
    p.smem = kSlack + kBarBytes + st * stage + trans;
    if (st >= 3) break;
  }
}

inline GramPlan make_plan(int bf16, int k, int same, int aligned) {
  GramPlan p;
  const int size = bf16 ? 2 : 4;
  p.route = aligned && (k * size) % 16 == 0 ? 0 : 1;
  p.box_cols = 128 / size;
  p.slabs = (k + 63) / 64;
  p.chunks = (k + kNpMax - 1) / kNpMax;
  const int per = (k + p.chunks - 1) / p.chunks;
  p.np = (per + 15) / 16 * 16;
  p.panels = p.slabs * p.chunks;
  p.cluster = 1;
  p.reuse = same && p.panels == 1;
  const int xboxes = 64 / p.box_cols;
  p.boxes = 2 * xboxes + (p.reuse ? 0 : (p.np + p.box_cols - 1) / p.box_cols);
  fit(p, bf16, k, same);
  if (p.route == 1 && p.stages < 2) {
    p.route = 2;
    fit(p, bf16, k, same);
  }
  return p;
}

// ---- device helpers ----

__device__ long long g_trace[kTraceTiles * kTraceEvents];

__device__ __forceinline__ void trace(int it, int ev) {
  if (kTrace && blockIdx.x == 0 && blockIdx.y == 0 && it < kTraceTiles) {
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_trace[it * kTraceEvents + ev] = t;
  }
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// the two consumer warpgroups (the producer warp never joins)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads and writes across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Keep a set of A fragments in its registers until the products that read
// them are known done: the compiler would otherwise reuse the registers
// for later work, and the assembler then waits for the products first.
__device__ __forceinline__ void hold_regs(const uint32_t (&a)[4][4]) {
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" ::"r"(a[s][e]));
}

// A shared-memory matrix descriptor with the 128-byte swizzle: start
// address, leading and stride byte offsets (16-byte units).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);    // exact
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

// Byte offset of element (r, c) in a box of 128-byte rows swizzled as the
// 128-byte TMA swizzle lays them out (16-byte chunk c' = chunk ^ (r & 7)).
template <typename T>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int E = 16 / sizeof(T);
  return r * 128 + ((((c / E) ^ (r & 7))) << 4) + (c % E) * (int)sizeof(T);
}

// wgmma m64nNk16 (bf16, both operands MN-major in shared memory) and
// m64nNk8 (tf32, A from registers, B K-major in shared memory), f32
// accumulators: d has N / 2 registers a thread.
template <int N> struct Wgmma;
template <> struct Wgmma<16> {
  // d += A B, A = desc a (64 x 16, MN-major), B = desc b (16 x 16,
  // MN-major), bf16 products into f32; scale_d = 0: d = A B
  __device__ __forceinline__ static void bf16(float (&d)[8],
                                              uint64_t a, uint64_t b,
                                              int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p, 1, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  // d += A B, A from registers (64 x 8 tf32 fragments), B = desc b (8 x
  // 16, K-major); scale_d = 0: d = A B
  __device__ __forceinline__ static void tf32(float (&d)[8],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <> struct Wgmma<32> {
  // d += A B, A = desc a (64 x 16, MN-major), B = desc b (16 x 32,
  // MN-major), bf16 products into f32; scale_d = 0: d = A B
  __device__ __forceinline__ static void bf16(float (&d)[16],
                                              uint64_t a, uint64_t b,
                                              int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  // d += A B, A from registers (64 x 8 tf32 fragments), B = desc b (8 x
  // 32, K-major); scale_d = 0: d = A B
  __device__ __forceinline__ static void tf32(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <> struct Wgmma<48> {
  // d += A B, A = desc a (64 x 16, MN-major), B = desc b (16 x 48,
  // MN-major), bf16 products into f32; scale_d = 0: d = A B
  __device__ __forceinline__ static void bf16(float (&d)[24],
                                              uint64_t a, uint64_t b,
                                              int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23}, "
        "%24, %25, p, 1, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  // d += A B, A from registers (64 x 8 tf32 fragments), B = desc b (8 x
  // 48, K-major); scale_d = 0: d = A B
  __device__ __forceinline__ static void tf32(float (&d)[24],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23}, "
        "{%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <> struct Wgmma<64> {
  // d += A B, A = desc a (64 x 16, MN-major), B = desc b (16 x 64,
  // MN-major), bf16 products into f32; scale_d = 0: d = A B
  __device__ __forceinline__ static void bf16(float (&d)[32],
                                              uint64_t a, uint64_t b,
                                              int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  // d += A B, A from registers (64 x 8 tf32 fragments), B = desc b (8 x
  // 64, K-major); scale_d = 0: d = A B
  __device__ __forceinline__ static void tf32(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <> struct Wgmma<80> {
  // d += A B, A = desc a (64 x 16, MN-major), B = desc b (16 x 80,
  // MN-major), bf16 products into f32; scale_d = 0: d = A B
  __device__ __forceinline__ static void bf16(float (&d)[40],
                                              uint64_t a, uint64_t b,
                                              int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39}, "
        "%40, %41, p, 1, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  // d += A B, A from registers (64 x 8 tf32 fragments), B = desc b (8 x
  // 80, K-major); scale_d = 0: d = A B
  __device__ __forceinline__ static void tf32(float (&d)[40],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39}, "
        "{%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <> struct Wgmma<96> {
  // d += A B, A = desc a (64 x 16, MN-major), B = desc b (16 x 96,
  // MN-major), bf16 products into f32; scale_d = 0: d = A B
  __device__ __forceinline__ static void bf16(float (&d)[48],
                                              uint64_t a, uint64_t b,
                                              int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47}, "
        "%48, %49, p, 1, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  // d += A B, A from registers (64 x 8 tf32 fragments), B = desc b (8 x
  // 96, K-major); scale_d = 0: d = A B
  __device__ __forceinline__ static void tf32(float (&d)[48],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47}, "
        "{%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <> struct Wgmma<112> {
  // d += A B, A = desc a (64 x 16, MN-major), B = desc b (16 x 112,
  // MN-major), bf16 products into f32; scale_d = 0: d = A B
  __device__ __forceinline__ static void bf16(float (&d)[56],
                                              uint64_t a, uint64_t b,
                                              int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %58, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55}, "
        "%56, %57, p, 1, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  // d += A B, A from registers (64 x 8 tf32 fragments), B = desc b (8 x
  // 112, K-major); scale_d = 0: d = A B
  __device__ __forceinline__ static void tf32(float (&d)[56],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n112k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55}, "
        "{%56, %57, %58, %59}, %60, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <> struct Wgmma<128> {
  // d += A B, A = desc a (64 x 16, MN-major), B = desc b (16 x 128,
  // MN-major), bf16 products into f32; scale_d = 0: d = A B
  __device__ __forceinline__ static void bf16(float (&d)[64],
                                              uint64_t a, uint64_t b,
                                              int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  // d += A B, A from registers (64 x 8 tf32 fragments), B = desc b (8 x
  // 128, K-major); scale_d = 0: d = A B
  __device__ __forceinline__ static void tf32(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

// ---- the kernel ----

struct GramArgs {
  long long m;
  unsigned long long ptr[3];   // routes 1, 2: S, AS, BS
  int k, same, route, chunks, panels, rows, stages, boxes, reuse, gx;
  int landing;   // bytes a stage lands before the consumers lay them out
};

// Array i's base (0 S, 1 AS, 2 BS), without indexing the array by a
// runtime value (which would put it in local memory).
__device__ __forceinline__ unsigned long long ptr_of(const GramArgs& a,
                                                     int i) {
  return i == 0 ? a.ptr[0] : i == 1 ? a.ptr[1] : a.ptr[2];
}

// Rows of all instances together.
__device__ __forceinline__ long long fleet_rows(const GramArgs& a) {
  return (long long)gridDim.y * a.m;
}

// Box b of a stage: [AS slab j][X1 slab j][S's chunk]; X1 is BS, or S
// when BS is S.  Its array (0 S, 1 AS, 2 BS) and first column.
template <int XB>
__device__ __forceinline__ int box_array(int b, int same) {
  return b < XB ? 1 : b < 2 * XB ? (same ? 0 : 2) : 0;
}
template <int XB, int W>
__device__ __forceinline__ int box_col(int b, int x0, int n0) {
  return b < 2 * XB ? x0 + (b % XB) * W : n0 + (b - 2 * XB) * W;
}

// A 16-byte chunk of elements from p (any element-aligned address), the
// first n of them (zeros past), built in registers.
template <typename T>
__device__ __forceinline__ uint4 load_chunk(const unsigned char* p, int n) {
  uint32_t w[4];
  if (sizeof(T) == 4) {
    const uint32_t* q = reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int e = 0; e < 4; ++e) w[e] = e < n ? q[e] : 0u;
  } else {
    const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[j] = (2 * j < n ? (uint32_t)q[2 * j] : 0u) |
             (2 * j + 1 < n ? (uint32_t)q[2 * j + 1] << 16 : 0u);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Routes 1 and 2: move the landed rows into the boxes' swizzled layout,
// zeros past `valid` rows and past column k; a thread a 16-byte chunk.
// Route 1 landed each array's span at slot (array) lspan, route 2 row r of
// box b at slot (b R + r) kSpan; either from byte (address & 15) on, which
// `shift` gives for row r0 of each array.
template <typename T, int XB, int W>
__device__ __forceinline__ void repack(unsigned char* stage,
                                       const unsigned char* landing,
                                       int lspan, const GramArgs& a, int x0,
                                       int n0, int valid,
                                       const int (&shift)[3]) {
  constexpr int E = 16 / sizeof(T);
  const int R = a.rows;
  const int rowbytes = a.k * (int)sizeof(T);
  for (int b = 0; b < a.boxes; ++b) {
    const int col = box_col<XB, W>(b, x0, n0);
    const int arr = box_array<XB>(b, a.same);
    const int sh = arr == 0 ? shift[0] : arr == 1 ? shift[1] : shift[2];
    unsigned char* box = stage + (size_t)b * R * 128;
    const unsigned char* from =
        a.route == 1 ? landing + (size_t)arr * lspan + sh + col * sizeof(T)
                     : landing + (size_t)b * R * kSpan;
    for (int q = threadIdx.x; q < R * 8; q += kConsumers) {
      const int r = q >> 3, c = q & 7;
      const int col0 = col + c * E;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < valid && col0 < a.k) {
        const unsigned char* p =
            a.route == 1
                ? from + (size_t)r * rowbytes + c * 16
                : from + (size_t)r * kSpan +
                      ((sh + r * rowbytes + col * (int)sizeof(T)) & 15) +
                      c * 16;
        v = load_chunk<T>(p, a.k - col0);
      }
      *reinterpret_cast<uint4*>(box + r * 128 + ((c ^ (r & 7)) << 4)) = v;
    }
  }
}

// f32: S's chunk (np columns of the stage's boxes from `sbox`) into the
// K-major swizzled tf32 hi and lo buffers of B: row n (S column), 128
// bytes of K a 32-row block.  Work item (n, k-step s, parity): rows
// 8s + 2i + parity, i = 0..3, to K slots 8 (s % 4) + 4 parity + i.
template <int NP>
__device__ __forceinline__ void transpose_split(const unsigned char* sbox,
                                                int box_bytes,
                                                unsigned char* hi,
                                                unsigned char* lo, int R) {
  const int items = NP * R / 4;
  for (int q = threadIdx.x; q < items; q += kConsumers) {
    const int n = q % NP, rest = q / NP;
    const int s = rest >> 1, par = rest & 1;
    const unsigned char* col = sbox + (n >> 5) * box_bytes;
    const int cb = n & 31;
    uint32_t h[4], l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 8 * s + 2 * i + par;
      split_tf32(*reinterpret_cast<const float*>(col + swz<float>(r, cb)),
                 h[i], l[i]);
    }
    const int c = 2 * (s & 3) + par;
    const int o = (s >> 2) * NP * 128 + n * 128 + ((c ^ (n & 7)) << 4);
    *reinterpret_cast<uint4*>(hi + o) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + o) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// f32: a thread's A fragment of one k-step (8 rows, 1024 bytes from q)
// split into tf32 hi and lo.
__device__ __forceinline__ void gather(const unsigned char* q,
                                       const int (&goff)[4],
                                       uint32_t (&ah)[4], uint32_t (&al)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e)
    split_tf32(*reinterpret_cast<const float*>(q + goff[e]), ah[e], al[e]);
}

// f32: four k-steps (32 rows, one block of the transposed chunk) of A
// fragments from q.
__device__ __forceinline__ void gather4(const unsigned char* q,
                                        const int (&goff)[4],
                                        uint32_t (&ah)[4][4],
                                        uint32_t (&al)[4][4]) {
#pragma unroll
  for (int s = 0; s < 4; ++s) gather(q + s * 1024, goff, ah[s], al[s]);
}

// f32: the 3xTF32 products of four k-steps, lo*hi + hi*lo + hi*hi each,
// the small terms first, in one wgmma group; B is the transposed chunk's
// block of 32 rows in hi (at hia) and lo (at loa), K-major, 128 bytes a
// row of NP.  scale0 = 0 starts the chain anew.
template <int NP>
__device__ __forceinline__ void mma_group(float (&acc)[NP / 2], int scale0,
                                          uint32_t hia, uint32_t loa,
                                          const uint32_t (&ah)[4][4],
                                          const uint32_t (&al)[4][4]) {
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const uint64_t dh = desc_sw128(hia + 32 * s, 16, 1024);
    const uint64_t dl = desc_sw128(loa + 32 * s, 16, 1024);
    Wgmma<NP>::tf32(acc, al[s], dh, s ? 1 : scale0);
    Wgmma<NP>::tf32(acc, ah[s], dl, 1);
    Wgmma<NP>::tf32(acc, ah[s], dh, 1);
  }
  wgmma_commit();
}

// S, AS, BS: (F, m, k) row-major behind the three maps (BS's is S's when
// BS is S).  Block (x * panels + p, f) takes the row tiles x, x + gx, ...
// of instance f for panel p = (slab j, chunk) and writes its entries of
// part[f][x][2][k][k] (S'AS first, then S'BS).
template <typename T, int NP>
__global__ void __launch_bounds__(kThreads, 1)
    gram_pair_kernel(const __grid_constant__ CUtensorMap map_s,
                     const __grid_constant__ CUtensorMap map_as,
                     const __grid_constant__ CUtensorMap map_bs,
                     const GramArgs args, float* __restrict__ part) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int W = 128 / sizeof(T);   // columns of a 128-byte box
  constexpr int XB = 64 / W;           // boxes of a 64-column slab
  constexpr int ND = NP / 2;           // accumulators a thread
  // the arguments in registers (read through a reference to the parameter,
  // every field would be reloaded after each shared-memory store)
  const GramArgs a = args;

  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  const uint32_t base = smem_addr(smem);
  unsigned char* ring =
      smem + (((base + kBarBytes + 1023u) & ~1023u) - base);

  const int R = a.rows;
  const int box_bytes = R * 128;
  const int land_off = a.boxes * box_bytes;   // routes 1, 2: landing
  const int stage_bytes = land_off + a.landing;
  const int lspan = (R * a.k * (int)sizeof(T) + 47) / 16 * 16;   // route 1
  unsigned char* trans = ring + a.stages * stage_bytes;   // f32 only

  const int bx = blockIdx.x / a.panels, p = blockIdx.x % a.panels;
  const int f = blockIdx.y;
  const int x0 = 64 * (p / a.chunks);   // X columns of the two slabs
  const int n0 = NP * (p % a.chunks);   // S columns of the chunk
  const long long m = a.m;
  const long long tiles = (m + R - 1) / R;
  const int ntiles = (int)((tiles - bx + a.gx - 1) / a.gx);

  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- the producer warp (its warpgroup's three others give their
    // registers to the consumers and leave) ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x >= kConsumers + 32) return;
    const int lane = threadIdx.x & 31;
    constexpr int size = sizeof(T);
    const unsigned long long array_bytes =
        (unsigned long long)fleet_rows(a) * a.k * size;
    for (int it = 0; it < ntiles; ++it) {
      const int st = it % a.stages;
      const uint32_t par = (uint32_t)(it / a.stages) & 1u;
      const long long r0 = ((long long)it * a.gx + bx) * R;
      const int valid = (int)(m - r0 < R ? m - r0 : R);
      unsigned char* dst = ring + (size_t)st * stage_bytes;
      if (a.route == 0) {
        if (lane == 0) {
          mbar_wait(&empty[st], par ^ 1u);
          trace(it, 0);
          mbar_expect_tx(&full[st], stage_bytes);
          for (int b = 0; b < a.boxes; ++b) {
            const int arr = box_array<XB>(b, a.same);
            tma_load_3d(dst + b * box_bytes,
                        arr == 0 ? &map_s : arr == 1 ? &map_as : &map_bs,
                        &full[st], box_col<XB, W>(b, x0, n0), (int)r0, f);
          }
          trace(it, 1);
        }
      } else {
        if (lane == 0) {
          mbar_wait(&empty[st], par ^ 1u);
          trace(it, 0);
        }
        __syncwarp();
        unsigned char* land = dst + land_off;
        if (a.route == 1) {
          // lane i copies array i's span: rows r0 .. r0 + valid, all k
          // columns, one contiguous run of bytes
          if (lane < (a.same ? 2 : 3)) {
            const unsigned long long base = ptr_of(a, lane);
            const unsigned long long at =
                base +
                (unsigned long long)(((long long)f * m + r0) * a.k) * size;
            copy_span<T>(land + lane * lspan, at,
                         (unsigned long long)valid * a.k * size,
                         base + array_bytes, &full[st]);
          }
        } else {
          // row r of box b: its columns before k, [col, col + W)
          for (int q = lane; q < a.boxes * valid; q += 32) {
            const int b = q / valid, r = q - b * valid;
            const int col = box_col<XB, W>(b, x0, n0);
            if (col >= a.k) continue;
            const unsigned long long base =
                ptr_of(a, box_array<XB>(b, a.same));
            const unsigned long long at =
                base + (unsigned long long)(((long long)f * m + r0 + r) *
                                                a.k + col) * size;
            copy_span<T>(land + (size_t)(b * R + r) * kSpan, at,
                         (unsigned long long)(min(W, a.k - col) * size),
                         base + array_bytes, &full[st]);
          }
        }
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(&full[st]);
          trace(it, 1);
        }
      }
    }
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
    return;
  }

  // ---- the consumer warpgroups ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = threadIdx.x >> 7;          // 0: AS's slab, 1: X1's
  const int w = (threadIdx.x >> 5) & 3;     // warp of the warpgroup
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float sum[ND], acc[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) sum[i] = acc[i] = 0.f;
  // f32: this thread's fragment gathers, rows 2t and 2t + 1 of a k-step,
  // columns 16 (w % 2) + g and + 8 of box w / 2 of its slab
  int goff[4];
  {
    const int cl = 16 * (w & 1) + g;
    goff[0] = swz<float>(2 * t, cl);
    goff[1] = swz<float>(2 * t, cl + 8);
    goff[2] = swz<float>(2 * t + 1, cl);
    goff[3] = swz<float>(2 * t + 1, cl + 8);
  }

  // Tile it's stage: wait for it to fill, then (routes 1, 2) lay its rows
  // out; f32 also transposes S's chunk into trans[it & 1].
  auto prepare = [&](int it) {
    const int st = it % a.stages;
    const long long r0 = ((long long)it * a.gx + bx) * R;
    const int valid = (int)(m - r0 < R ? m - r0 : R);
    unsigned char* stage = ring + (size_t)st * stage_bytes;
    const bool first = threadIdx.x == 0;
    if (first) trace(it, 2);
    mbar_wait(&full[st], (uint32_t)(it / a.stages) & 1u);
    if (first) trace(it, 3);
    if (a.route != 0) {
      const long long first = ((long long)f * m + r0) * a.k * sizeof(T);
      const int shift[3] = {(int)((a.ptr[0] + first) & 15),
                            (int)((a.ptr[1] + first) & 15),
                            (int)((a.ptr[2] + first) & 15)};
      repack<T, XB, W>(stage, stage + land_off, lspan, a, x0, n0, valid,
                       shift);
      fence_proxy_async();
      consumer_sync();
      // the producer writes only the landing area on these routes: it is
      // free once laid out (the boxes are next written a ring later)
      if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[st]);
    }
    if constexpr (kF32) {
      unsigned char* hi = trans + (size_t)(it & 1) * 2 * NP * R * 4;
      transpose_split<NP>(stage + (a.reuse ? XB : 2 * XB) * box_bytes,
                          box_bytes, hi, hi + NP * R * 4, R);
      fence_proxy_async();
    }
    if (first) trace(it, 4);
  };

  if constexpr (kF32) {
    // tile it's products run while tile it + 1 is prepared: its A
    // fragments come from registers and B from trans[it & 1], so its stage
    // is free once gathered
    // two sets of fragments where the accumulators leave room (NP <= 64;
    // wider chunks run 32-row tiles, one group a tile)
    constexpr bool kTwoSets = NP <= 64;
    uint32_t ah0[4][4], al0[4][4], ah1[4][4], al1[4][4];
    const int groups = R / 32;           // four k-steps (32 rows) a group
    const int kb = NP * 128;             // bytes a 32-row block of B
    prepare(0);
    consumer_sync();
    for (int it = 0; it < ntiles; ++it) {
      const int st = it % a.stages;
      const int keep = kFoldChains ? 0 : it > 0;   // continue the chain
      const unsigned char* xs = ring + (size_t)st * stage_bytes +
                                (wg * XB + (w >> 1)) * box_bytes;
      const uint32_t hia =
          smem_addr(trans + (size_t)(it & 1) * 2 * NP * R * 4);
      const uint32_t loa = hia + NP * R * 4;
      fence_regs(acc);
      gather4(xs, goff, ah0, al0);
      mma_group<NP>(acc, keep, hia, loa, ah0, al0);
      if constexpr (kTwoSets) {
        // the next group's fragments are gathered while this one's
        // products run (R <= 128: at most four groups)
        if (groups > 1) {
          wgmma_wait<1>();
          gather4(xs + 4096, goff, ah1, al1);
          mma_group<NP>(acc, 1, hia + kb, loa + kb, ah1, al1);
        }
        if (groups > 2) {
          wgmma_wait<1>();
          gather4(xs + 2 * 4096, goff, ah0, al0);
          mma_group<NP>(acc, 1, hia + 2 * kb, loa + 2 * kb, ah0, al0);
        }
        if (groups > 3) {
          wgmma_wait<1>();
          gather4(xs + 3 * 4096, goff, ah1, al1);
          mma_group<NP>(acc, 1, hia + 3 * kb, loa + 3 * kb, ah1, al1);
        }
      } else {
        for (int gi = 1; gi < groups; ++gi) {
          wgmma_wait<0>();
          gather4(xs + gi * 4096, goff, ah0, al0);
          mma_group<NP>(acc, 1, hia + gi * kb, loa + gi * kb, ah0, al0);
        }
      }
      if (threadIdx.x == 0) trace(it, 5);
      __syncwarp();
      if (lane == 0 && a.route == 0) mbar_arrive(&empty[st]);
      if (it + 1 < ntiles) prepare(it + 1);
      wgmma_wait<0>();
      fence_regs(acc);
      if (threadIdx.x == 0) trace(it, 6);
      hold_regs(ah0);
      hold_regs(al0);
      if constexpr (kTwoSets) {
        hold_regs(ah1);
        hold_regs(al1);
      }
      // the tile's chain into the f32 sums (rounded adds)
#pragma unroll
      for (int i = 0; i < ND; ++i)
        sum[i] = kFoldChains ? sum[i] + acc[i] : acc[i];
      // every product of tile it is done before trans[it & 1] is written
      // again; tile it + 1's transposition is complete
      consumer_sync();
      if (threadIdx.x == 0) trace(it, 7);
    }
  } else {
    for (int it = 0; it < ntiles; ++it) {
      const int st = it % a.stages;
      const int keep = kFoldChains ? 0 : it > 0;   // continue the chain
      unsigned char* stage = ring + (size_t)st * stage_bytes;
      prepare(it);
      const uint64_t da =
          desc_sw128(smem_addr(stage + wg * box_bytes), box_bytes, 1024);
      const uint64_t db = desc_sw128(
          smem_addr(stage + (a.reuse ? XB : 2 * XB) * box_bytes), box_bytes,
          1024);
      fence_regs(acc);
      wgmma_fence();
      for (int s = 0; s < R / 16; ++s)   // 16 rows = 2048 bytes a k-step
        Wgmma<NP>::bf16(acc, da + (uint64_t)(s * 128),
                        db + (uint64_t)(s * 128), s | keep);
      wgmma_commit();
      if (threadIdx.x == 0) trace(it, 5);
      wgmma_wait<0>();
      fence_regs(acc);
      if (threadIdx.x == 0) trace(it, 6);
      // the tile's chain into the f32 sums (rounded adds)
#pragma unroll
      for (int i = 0; i < ND; ++i)
        sum[i] = kFoldChains ? sum[i] + acc[i] : acc[i];
      __syncwarp();
      if (lane == 0 && a.route == 0) mbar_arrive(&empty[st]);
      if (threadIdx.x == 0) trace(it, 7);
    }
  }
  // the finishing kernel may start launching (it waits for this grid)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  // D[c][i] = (S'X)[i][c]: this warpgroup's Gram, transposed back
  const size_t kk = (size_t)a.k * (size_t)a.k;
  float* out = part + ((size_t)f * a.gx + bx) * 2 * kk + (size_t)wg * kk;
#pragma unroll
  for (int i = 0; i < ND; ++i) {
    const int c = x0 + 16 * w + g + 8 * ((i & 3) >> 1);
    const int sc = n0 + 8 * (i >> 2) + 2 * t + (i & 1);
    if (c < a.k && sc < a.k) out[(size_t)sc * a.k + c] = sum[i];
  }
}

// out[f][e] = sum over blocks x of part[f][x][e], e < nent = 2 k^2: slice y
// of a (32, ns) block, ns = min(nblk, kFinishSlices), adds x = y, y + ns,
// ... in order in double, then slice 0 adds the slices in order and rounds
// to f32.
__global__ void __launch_bounds__(32 * kFinishSlices)
    gram_finish_kernel(const float* part, int nblk, int nent, float* out) {
  __shared__ double red[kFinishSlices][32];
  // launched early (programmatic dependent launch): wait for the partials
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int e = blockIdx.x * 32 + threadIdx.x;
  const int ns = blockDim.y;
  double v = 0.0;
  if (e < nent) {
    const float* p = part + (size_t)blockIdx.y * nblk * nent + e;
#pragma unroll 4
    for (int x = threadIdx.y; x < nblk; x += ns)
      v += (double)p[(size_t)x * nent];
  }
  red[threadIdx.y][threadIdx.x] = v;
  __syncthreads();
  if (threadIdx.y == 0 && e < nent) {
    double s = 0.0;
    for (int y = 0; y < ns; ++y) s += red[y][threadIdx.x];
    out[(size_t)blockIdx.y * nent + e] = (float)s;
  }
}

// ---- host side ----

using Kernel = void (*)(CUtensorMap, CUtensorMap, CUtensorMap, GramArgs,
                        float*);

template <typename T>
Kernel instance(int np) {
  static const Kernel kernels[kNpMax / 16] = {
      gram_pair_kernel<T, 16>, gram_pair_kernel<T, 32>,
      gram_pair_kernel<T, 48>, gram_pair_kernel<T, 64>,
      gram_pair_kernel<T, 80>, gram_pair_kernel<T, 96>,
      gram_pair_kernel<T, 112>, gram_pair_kernel<T, 128>};
  return kernels[np / 16 - 1];
}

Kernel instance_for(int bf16, int np) {
  return bf16 ? instance<__nv_bfloat16>(np) : instance<float>(np);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime's lookup.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The (F, m, k) block as a 3-D map of (box_cols x rows x 1) boxes with
// the 128-byte swizzle (route 0; routes 1 and 2 pass it unused).
cudaError_t make_map(CUtensorMap* map, const void* ptr, int bf16, int fleet,
                     long long m, int k, const GramPlan& p) {
  if (p.route != 0) return cudaSuccess;
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const int size = bf16 ? 2 : 4;
  const cuuint64_t dims[3] = {(cuuint64_t)k, (cuuint64_t)m,
                              (cuuint64_t)fleet};
  const cuuint64_t strides[2] = {(cuuint64_t)k * size,
                                 (cuuint64_t)m * k * size};
  const cuuint32_t box[3] = {(cuuint32_t)p.box_cols, (cuuint32_t)p.rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = encode(
      map,
      bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      3, const_cast<void*>(ptr), dims, strides, box, estr,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Row streams per instance: one wave over the fleet's panels (blocks that
// fit at once), each stream at least one tile.  Also opts the instance in
// to the largest dynamic shared memory.
cudaError_t geometry(int bf16, int fleet, long long m, int k, int same,
                     int aligned, int* grid) {
  const GramPlan p = make_plan(bf16, k, same, aligned);
  const Kernel kernel = instance_for(bf16, p.np);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmemCap);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                    p.smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) per_sm = 1;
  const long long tiles = (m + p.rows - 1) / p.rows;
  long long want =
      (long long)sms * per_sm / ((long long)fleet * p.panels);
  if (want > tiles) want = tiles;
  *grid = want < 1 ? 1 : (int)want;
  return cudaSuccess;
}

int launch(int bf16, const void* s, const void* as, const void* bs,
           int fleet, long long m, int k, int same, int grid, float* part,
           float* out, cudaStream_t st) {
  const int aligned =
      ((reinterpret_cast<uintptr_t>(s) | reinterpret_cast<uintptr_t>(as) |
        reinterpret_cast<uintptr_t>(bs)) % 16) == 0;
  const GramPlan p = make_plan(bf16, k, same, aligned);
  // the 3-D map's row coordinate is an int32
  if (p.route == 0 && m > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  GramArgs a;
  a.m = m;
  a.k = k;
  a.same = same;
  a.route = p.route;
  a.chunks = p.chunks;
  a.panels = p.panels;
  a.rows = p.rows;
  a.stages = p.stages;
  a.boxes = p.boxes;
  a.reuse = p.reuse;
  a.gx = grid;
  a.landing = landing_bytes(p, bf16 ? 2 : 4, k, same, p.rows);
  CUtensorMap maps[3] = {};
  const void* ptrs[3] = {s, as, same ? s : bs};
  for (int i = 0; i < 3; ++i) {
    a.ptr[i] = reinterpret_cast<unsigned long long>(ptrs[i]);
    const cudaError_t e = make_map(&maps[i], ptrs[i], bf16, fleet, m, k, p);
    if (e != cudaSuccess) return (int)e;
  }
  const Kernel kernel = instance_for(bf16, p.np);
  kernel<<<dim3(grid * p.panels, fleet), kThreads, p.smem, st>>>(
      maps[0], maps[1], maps[2], a, part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int nent = 2 * k * k;
  // a programmatic dependent launch: its blocks are scheduled while the
  // partials' grid drains, and wait for it to complete
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((nent + 31) / 32, fleet);
  // slices of the blocks' partials an entry: enough threads to fill the
  // card when there are few entries, one slice when there are many
  long long ns = kFinishThreads / ((long long)nent * fleet);
  if (ns > kFinishSlices) ns = kFinishSlices;
  if (ns > grid) ns = grid;
  if (ns < 1) ns = 1;
  cfg.blockDim = dim3(32, (unsigned)ns);
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

}  // namespace

extern "C" {

// The traced launches' event times (kTrace; n <= 512 values), or, with
// clear = 1, zeros written over them (out is not read).
int gram_pair_trace(long long* out, int n, int clear) {
  if (clear) {
    static const long long zeros[kTraceTiles * kTraceEvents] = {};
    return (int)cudaMemcpyToSymbol(g_trace, zeros, sizeof(zeros));
  }
  return (int)cudaMemcpyFromSymbol(out, g_trace, n * sizeof(long long));
}

const char* gram_pair_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The launch plan of a call (the fields of GramPlan in order, then the row
// streams per instance): out[13].  aligned = 1 when the three base
// pointers are 16-byte aligned.
int gram_pair_plan(int bf16, int fleet, long long m, int k, int same,
                   int aligned, int* out) {
  const GramPlan p = make_plan(bf16, k, same, aligned);
  const int f[12] = {p.route, p.box_cols, p.slabs, p.chunks, p.np,
                     p.panels, p.cluster, p.rows, p.stages, p.boxes,
                     p.reuse, p.smem};
  for (int i = 0; i < 12; ++i) out[i] = f[i];
  return (int)geometry(bf16, fleet, m, k, same, aligned, &out[12]);
}

// Row streams per instance of a gram_pair launch over a fleet of (m, k)
// blocks, k >= 1, m >= 1, same = 1 when BS will be S, aligned = 1 when
// the three bases will be 16-byte aligned; the caller sizes the partials
// as fleet * grid * 2 k^2 floats.  Also opts the kernel in to its dynamic
// shared memory: call it once per shape before the first launch.
int gram_pair_geometry(int bf16, int fleet, long long m, int k, int same,
                       int aligned, int* grid) {
  return (int)geometry(bf16, fleet, m, k, same, aligned, grid);
}

// out[f][0] = S_f' AS_f and out[f][1] = S_f' BS_f, (k, k) f32 each, for the
// fleet's (m, k) row-major blocks (S, AS, BS of one dtype).  same = 1: BS
// is S (S is read once and bs is not read).  Enqueues on `stream` and
// returns cudaGetLastError() after its two launches (0 when accepted).
int gram_pair_run(int bf16, const void* s, const void* as, const void* bs,
                  int fleet, long long m, int k, int same, int grid,
                  float* part, float* out, void* stream) {
  return launch(bf16, s, as, bs, fleet, m, k, same, grid, part, out,
                (cudaStream_t)stream);
}

}  // extern "C"
