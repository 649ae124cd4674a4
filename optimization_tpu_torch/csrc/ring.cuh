// The mbarrier ring shared by the port's TMA-fed kernels (csrc/gram_pair.cu,
// csrc/streamed_cg_any.cu): shared-memory addresses, the mbarrier
// operations (init, expect_tx, arrive, a wait that traps instead of
// hanging), 1-D bulk copies from device memory into shared memory, a span
// copy that lands an array's unaligned end by plain copies, and the proxy
// fence for generic-proxy shared-memory writes.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// An element's bits (moved, never computed on).
template <typename T> struct Bits { using type = unsigned short; };
template <> struct Bits<float> { using type = uint32_t; };

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_add_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Wait for the phase of the given parity to complete.  A ring that never
// fills (a wrong byte count) traps after ~10 s instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  long long t0 = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) t0 = clock64();
    else if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// bytes (a multiple of 16) from a 16-byte aligned global address
__device__ __forceinline__ void bulk_load(void* dst, unsigned long long src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The bytes [at, at + n) of an array ending at `end` into dst + (at & 15):
// their 16-byte aligned part by one bulk copy (its bytes added to the
// barrier's count first), what lies in the array's last partial 16 bytes
// by plain copies (the caller's arrive, after a __syncwarp, publishes them).
template <typename T>
__device__ __forceinline__ void copy_span(unsigned char* dst,
                                          unsigned long long at,
                                          unsigned long long n,
                                          unsigned long long end,
                                          uint64_t* bar) {
  using B = typename Bits<T>::type;
  const unsigned long long lo = at & ~15ull, last = end & ~15ull;
  unsigned long long up = (at + n + 15) & ~15ull;
  if (up > last) up = last > lo ? last : lo;
  if (up > lo) {
    mbar_add_tx(bar, (int)(up - lo));
    bulk_load(dst, lo, (int)(up - lo), bar);
  }
  for (unsigned long long x = up > at ? up : at; x < at + n; x += sizeof(T))
    *reinterpret_cast<B*>(dst + (x - lo)) = *reinterpret_cast<const B*>(x);
}

// generic-proxy writes to shared memory, visible to wgmma and TMA
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

}  // namespace
