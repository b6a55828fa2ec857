// The 1-D bulk copy from global to shared memory (TMA without a tensor
// map) and the mbarrier it reports to, shared by the kernels that stage
// tables in a block's shared memory (tri_intersect.cu, curves.cu) and by the
// copy probes (dma_probe.cu).
//
// One thread posts the byte count on an mbarrier (arrive.expect_tx) and
// starts one cp.async.bulk; every thread that reads the bytes waits on the
// barrier's phase. Source, destination and byte count are multiples of 16.
// A wait that does not end (a wrong byte count, a faulting copy) traps
// after two seconds instead of hanging the card. A block must not exit
// while a copy into its shared memory is in flight: wait for it first.
#pragma once

#include <stdint.h>

namespace pbrt_tpu_torch {

// an mbarrier wait that lasts this long (ns) traps: a copy arrives in
// microseconds
constexpr unsigned long long kBulkWaitNs = 2000000000ull;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Thread 0 initialises n barriers for one arrival each; ends in a block
// barrier, so every thread of the block calls it.
__device__ __forceinline__ void mbar_init(uint64_t* bars, int n) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < n; ++i) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_addr(bars + i))
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// Called by one thread: posts `bytes` on bar and starts the copy.
__device__ __forceinline__ void bulk_start(void* dst, const void* src,
                                           uint32_t bytes, uint64_t* bar) {
  const uint32_t b = smem_addr(bar);
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(b)
      : "memory");
}

// Returns when the phase `parity` of bar has completed; after it the
// calling thread may read the copied bytes.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t b = smem_addr(bar);
  unsigned long long start = 0ull;   // set at the first failed poll
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(b), "r"(parity)
        : "memory");
    if (done) return;
    const unsigned long long now = global_ns();
    if (start == 0ull) start = now;
    if (now - start > kBulkWaitNs) __trap();
  }
}

}  // namespace pbrt_tpu_torch
