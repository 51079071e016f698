// bulk_copy.cuh: Hopper's bulk-copy engine and the mbarriers that report
// its completion, for sm_90a.
//
// One thread asks for a 1-D run of bytes to be copied from device memory
// into shared memory (cp.async.bulk); the copy engine computes the
// addresses and, when the bytes have landed, decrements the transaction
// count of an mbarrier in shared memory.  A phase of the barrier completes
// when every expected thread has arrived AND the byte count announced with
// expect_tx has arrived.  Both ends of a copy must be 16-byte aligned and
// its size a multiple of 16 bytes.  A wrong byte count or phase parity
// does not fail by itself: the waiting block would hang, so callers derive
// both from one place, and wait() traps after a bounded time.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bulk {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Set up a barrier whose phases complete after `count` arrivals (plus the
// bytes each phase expects).  Then fence_init() and a block barrier before
// any thread or copy uses it.
__device__ __forceinline__ void init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible to the copy engine.
__device__ __forceinline__ void fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Orders this thread's earlier shared-memory accesses before the bulk
// copies it issues next (the copy engine is another proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Announce `bytes` more bytes for the current phase, without arriving.
// The issuing thread announces a copy's bytes before it issues the copy.
__device__ __forceinline__ void expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Arrive `count` times on the current phase.  Release semantics: this
// thread's earlier shared-memory accesses are ordered before the phase
// completes.
__device__ __forceinline__ void arrive(uint64_t* bar, uint32_t count = 1) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Whether the phase of parity `parity` has completed (phases alternate
// 0, 1, 0, ...; the first one waited for has parity 0).  The hardware may
// suspend the thread a while before answering no.
__device__ __forceinline__ bool try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.b32 %0, 1, 0, P1;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the phase of parity `parity`.  A phase that has not completed
// after ~2^32 cycles (about 2 s) can only be a wrong byte count or parity:
// the block traps, so the launch fails with an error instead of hanging
// the card.
__device__ __forceinline__ void wait(uint64_t* bar, uint32_t parity) {
  if (try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!try_wait(bar, parity)) {
    if (clock64() - t0 > (1ll << 32)) __trap();
  }
}

// `bytes` from device memory at `src` to shared memory at `dst`, completing
// on `bar`.  Both addresses 16-byte aligned, bytes a multiple of 16.
__device__ __forceinline__ void copy_g2s(void* dst, const void* src, uint32_t bytes,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Ask for `bytes` at `src` (16-byte aligned, a multiple of 16) to be
// brought into L2, with no completion to wait for.
__device__ __forceinline__ void prefetch_l2(const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(src), "r"(bytes) : "memory");
}

}  // namespace bulk
