// Global -> shared page-copy probes for Hopper (sm_90a).
//
// Replaces the four TPU copy probes, which asked which local-copy forms
// work on a TPU:
//   dma_var             tools/exp_dma_var.py   inline kern (six VARs)
//   dma_sched_pipelined tools/exp_dma_var2.py  inline kern, VAR=blockspec_*
//   dma_sched_manual    tools/exp_dma_var2.py  inline kern, VAR=ds_*
//   dma_ladder          tools/exp_dma_min.py   kernel, STAGE=1..4
// They compute what those kernels compute: a block stages pages of rows x
// 128 floats in its shared memory and adds one number per staged page to
// its (8, 128) tile of x. On this card the question is which copy path
// from global to shared memory is fastest, at which page size: it sizes
// the paged traversal kernels (bvh8_forest.cu, bvh8_binned.cu), whose
// pages are 150-190 KB and whose copy loop is the `ld` path below.
//
// The TPU's two scratch spaces (SMEM, VMEM) are both a block's shared
// memory here, so the *_smem and *_vmem variants share one body. What
// differs on Hopper is the copy path, a run-time switch of every probe:
//   ld        plain cooperative float4 loads and shared stores, then
//             __syncthreads(): through registers, synchronous;
//   cp_async  cp.async.cg.shared.global, 16 B per thread per step, one
//             commit group per page, wait_group, then __syncthreads();
//   bulk      the 1-D bulk copy (TMA without a tensor map): one thread
//             posts the page's bytes on an mbarrier (arrive.expect_tx) and
//             starts one cp.async.bulk.shared::cluster.global; every thread
//             waits on the barrier's phase. A wait that does not end (a
//             wrong byte count, a faulting copy) traps after two seconds.
//
// The grid: a TPU grid's steps run in order and an output block revisited
// across p accumulates in place. Here block b loops over its P schedule
// entries itself, keeps the sum in a register and writes its tile once;
// the schedule is read from global memory. dma_var's blocks all write the
// same tile with the same value.
//
// reduce: 0 adds the staged page's first element (the TPU probes'
// function); 1 adds the sum of the whole staged page (every thread reads
// its share from shared memory, then a block reduction), so that the
// consumer reads every staged byte. The callers fill pages with small
// integers so every f32 sum is exact in any order.
//
// What bounds it: bytes. A probe moves pages and does one add per staged
// float at most; its floor is the staged bytes over the memory rate (from
// L2 where the page array fits it, 50 MB).
//
// One block is 1,024 threads. Dynamic shared memory: the page buffers;
// static: 32 floats of reduction scratch and the mbarriers, 256 B with
// the padding to the buffers' 128 B alignment (ptxas reports it).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kLanes = 128;          // floats a page row
constexpr int kTile = 8 * kLanes;    // a block's tile of x and out
// an mbarrier wait that lasts this long (ns) traps: a page arrives in
// microseconds
constexpr unsigned long long kWaitNs = 2000000000ull;

enum Copy { kLd = 0, kCpAsync = 1, kBulk = 2 };
enum Variant { kSlice = 0, kFull = 1, kTwoHop = 2 };

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

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

// Starts the copy of n16 float4 from src (global) to dst (shared). Every
// thread of the block calls it. ld: the copy itself; cp_async: the
// thread's share, committed as one group; bulk: thread 0 posts the byte
// count on bar and starts the copy.
__device__ __forceinline__ void copy_start(int copy, float4* dst,
                                           const float4* __restrict__ src,
                                           int n16, uint64_t* bar) {
  if (copy == kLd) {
    for (int j = threadIdx.x; j < n16; j += kThreads) dst[j] = src[j];
  } else if (copy == kCpAsync) {
    for (int j = threadIdx.x; j < n16; j += kThreads) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       smem_addr(dst + j)),
                   "l"(src + j)
                   : "memory");
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  } else if (threadIdx.x == 0) {
    const uint32_t bytes = static_cast<uint32_t>(n16) * 16u;
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
}

// Waits for a started copy; after it every thread may read the page.
// pending: cp_async groups started after this one that may stay in flight
// (0 or 1); parity: the phase of bar this copy completes.
__device__ __forceinline__ void copy_wait(int copy, uint64_t* bar,
                                          uint32_t parity, int pending) {
  if (copy == kBulk) {
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
      if (now - start > kWaitNs) __trap();
    }
  }
  if (copy == kCpAsync) {
    if (pending) {
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
  }
  __syncthreads();
}

// The number a staged page of n16 float4 adds: its first element, or the
// sum of all of it, the same value on every thread. With reduce = 1 it
// holds two barriers, so it also orders the page's reads before what
// follows.
__device__ __forceinline__ float page_value(int reduce, const float4* page,
                                            int n16, float* red) {
  if (!reduce) return reinterpret_cast<const float*>(page)[0];
  float s = 0.0f;
  for (int j = threadIdx.x; j < n16; j += kThreads) {
    const float4 v = page[j];
    s += (v.x + v.y) + (v.z + v.w);
  }
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = s;
  __syncthreads();
  float total = 0.0f;
  for (int w = 0; w < kThreads / 32; ++w) total += red[w];
  __syncthreads();
  return total;
}

__device__ __forceinline__ void write_tile(const float* __restrict__ x,
                                           float* __restrict__ out, int tile,
                                           float acc) {
  for (int j = threadIdx.x; j < kTile; j += kThreads)
    out[size_t(tile) * kTile + j] = x[size_t(tile) * kTile + j] + acc;
}

// a schedule entry outside the page array is a caller's fault: fail, do
// not read beyond the array
__device__ __forceinline__ int checked_page(int k, int n_pages) {
  if (static_cast<unsigned>(k) >= static_cast<unsigned>(n_pages)) __trap();
  return k;
}

// ---------------------------------------------------------------------------
// dma_var: one copy into scratch, out = x + value(scratch).
//   slice   page `page` alone;
//   full    all n_pages pages, the value read from page `page` of scratch;
//   two_hop page `page` into buffer A by `copy`, then A into buffer B
//           through registers, the value read from B.
__global__ void __launch_bounds__(kThreads)
dma_var_kernel(const float* __restrict__ pages, const float* __restrict__ x,
               float* __restrict__ out, int n_pages, int page_f4, int page,
               int variant, int copy, int reduce) {
  extern __shared__ __align__(128) float4 scr[];
  __shared__ float red[kThreads / 32];
  __shared__ __align__(8) uint64_t bar[1];
  if (copy == kBulk) mbar_init(bar, 1);
  const float4* src = reinterpret_cast<const float4*>(pages);
  const float4* staged = scr;
  if (variant == kFull) {
    copy_start(copy, scr, src, n_pages * page_f4, bar);
    copy_wait(copy, bar, 0u, 0);
    staged = scr + size_t(page) * page_f4;
  } else {
    copy_start(copy, scr, src + size_t(page) * page_f4, page_f4, bar);
    copy_wait(copy, bar, 0u, 0);
    if (variant == kTwoHop) {
      float4* second = scr + page_f4;
      for (int j = threadIdx.x; j < page_f4; j += kThreads)
        second[j] = scr[j];
      __syncthreads();
      staged = second;
    }
  }
  write_tile(x, out, 0, page_value(reduce, staged, page_f4, red));
}

// ---------------------------------------------------------------------------
// dma_sched_manual: block b stages page sched[b * P + p] for p = 0..P-1 in
// one buffer, start then wait, and adds each page's value.
__global__ void __launch_bounds__(kThreads)
dma_sched_manual_kernel(const float* __restrict__ pages,
                        const int* __restrict__ sched,
                        const float* __restrict__ x, float* __restrict__ out,
                        int n_pages, int page_f4, int P, int copy,
                        int reduce) {
  extern __shared__ __align__(128) float4 scr[];
  __shared__ float red[kThreads / 32];
  __shared__ __align__(8) uint64_t bar[1];
  if (copy == kBulk) mbar_init(bar, 1);
  const float4* src = reinterpret_cast<const float4*>(pages);
  float acc = 0.0f;
  for (int p = 0; p < P; ++p) {
    const int k = checked_page(sched[blockIdx.x * P + p], n_pages);
    // the previous page's reads are over before the buffer is overwritten
    __syncthreads();
    copy_start(copy, scr, src + size_t(k) * page_f4, page_f4, bar);
    copy_wait(copy, bar, p & 1, 0);
    acc += page_value(reduce, scr, page_f4, red);
  }
  write_tile(x, out, blockIdx.x, acc);
}

// ---------------------------------------------------------------------------
// dma_sched_pipelined: the same sum with two buffers: the copy of page
// p + 1 is started before page p is consumed (cp_async: one group a stage,
// wait_group 1; bulk: one mbarrier a stage with its phase bit). The ld
// path has no asynchronous form: its loads of page p + 1 are started ahead
// of page p's reads but retire through registers before them, so it runs
// unpipelined.
__global__ void __launch_bounds__(kThreads)
dma_sched_pipelined_kernel(const float* __restrict__ pages,
                           const int* __restrict__ sched,
                           const float* __restrict__ x,
                           float* __restrict__ out, int n_pages, int page_f4,
                           int P, int copy, int reduce) {
  extern __shared__ __align__(128) float4 scr[];
  __shared__ float red[kThreads / 32];
  __shared__ __align__(8) uint64_t bar[2];
  if (copy == kBulk) mbar_init(bar, 2);
  const float4* src = reinterpret_cast<const float4*>(pages);
  const int* row = sched + blockIdx.x * P;
  float acc = 0.0f;
  if (P > 0) {
    copy_start(copy, scr, src + size_t(checked_page(row[0], n_pages)) *
                                    page_f4, page_f4, bar);
  }
  for (int p = 0; p < P; ++p) {
    const int s = p & 1;
    const bool more = p + 1 < P;
    if (more) {
      // buffer s ^ 1 held page p - 1, whose reads ended at the barrier
      // that closed the last trip
      copy_start(copy, scr + size_t(s ^ 1) * page_f4,
                 src + size_t(checked_page(row[p + 1], n_pages)) * page_f4,
                 page_f4, bar + (s ^ 1));
    }
    copy_wait(copy, bar + s, (p >> 1) & 1, more ? 1 : 0);
    acc += page_value(reduce, scr + size_t(s) * page_f4, page_f4, red);
    __syncthreads();
  }
  write_tile(x, out, blockIdx.x, acc);
}

// ---------------------------------------------------------------------------
// dma_ladder: the binned kernel's ladder. A schedule entry < 0 means no
// page. Stage 1 copies page max(k, 0) at every p and adds only at p = 0
// (when valid); stage 2 copies only under the block-uniform predicate
// k >= 0; stage 3 adds at every valid p; stage 4 adds, at every valid p, a
// loop of three scalar reads scr[i, 1] * 0.
__global__ void __launch_bounds__(kThreads)
dma_ladder_kernel(const float* __restrict__ pages,
                  const int* __restrict__ sched, const float* __restrict__ x,
                  float* __restrict__ out, int n_pages, int page_f4, int P,
                  int stage, int copy, int reduce) {
  extern __shared__ __align__(128) float4 scr[];
  __shared__ float red[kThreads / 32];
  __shared__ __align__(8) uint64_t bar[1];
  if (copy == kBulk) mbar_init(bar, 1);
  const float4* src = reinterpret_cast<const float4*>(pages);
  const float* scr_f = reinterpret_cast<const float*>(scr);
  float acc = 0.0f;
  uint32_t phase = 0u;   // bar's phase: flips with every copy made
  for (int p = 0; p < P; ++p) {
    const int k = sched[blockIdx.x * P + p];
    const bool valid = k >= 0;
    if (valid || stage < 2) {
      const int kc = checked_page(valid ? k : 0, n_pages);
      __syncthreads();
      copy_start(copy, scr, src + size_t(kc) * page_f4, page_f4, bar);
      copy_wait(copy, bar, phase, 0);
      phase ^= 1u;
    }
    if (valid && (stage >= 3 || p == 0))
      acc += page_value(reduce, scr, page_f4, red);
    if (valid && stage >= 4) {
      for (int i = 0; i < 3; ++i) acc += scr_f[i * kLanes + 1] * 0.0f;
    }
  }
  write_tile(x, out, blockIdx.x, acc);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace

// pages (n_pages, rows, 128) float32 contiguous; x, out float32; sched
// int32; every launch runs on the calling thread's current device with
// blocks of 1,024 threads and smem bytes of dynamic shared memory (the
// caller sizes it: the buffers the probe stages into, at most 232,448 B
// with the 256 B of static shared memory). Each returns cudaGetLastError()
// after the launch.

// x, out (8, 128): every one of `blocks` blocks writes the whole tile.
extern "C" int dma_var_launch(const float* pages, const float* x, float* out,
                              int n_pages, int rows, int page, int variant,
                              int copy, int reduce, int blocks, int smem,
                              void* stream) {
  cudaError_t err = allow_smem(dma_var_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dma_var_kernel<<<blocks, kThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      pages, x, out, n_pages, rows * (kLanes / 4), page, variant, copy,
      reduce);
  return static_cast<int>(cudaGetLastError());
}

// sched (B * P,); x, out (B * 8, 128); one block a schedule row.
extern "C" int dma_sched_launch(const float* pages, const int* sched,
                                const float* x, float* out, int n_pages,
                                int rows, int B, int P, int pipelined,
                                int copy, int reduce, int smem,
                                void* stream) {
  const int page_f4 = rows * (kLanes / 4);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pipelined) {
    cudaError_t err = allow_smem(dma_sched_pipelined_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    dma_sched_pipelined_kernel<<<B, kThreads, smem, s>>>(
        pages, sched, x, out, n_pages, page_f4, P, copy, reduce);
  } else {
    cudaError_t err = allow_smem(dma_sched_manual_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    dma_sched_manual_kernel<<<B, kThreads, smem, s>>>(
        pages, sched, x, out, n_pages, page_f4, P, copy, reduce);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dma_ladder_launch(const float* pages, const int* sched,
                                 const float* x, float* out, int n_pages,
                                 int rows, int B, int P, int stage, int copy,
                                 int reduce, int smem, void* stream) {
  cudaError_t err = allow_smem(dma_ladder_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dma_ladder_kernel<<<B, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      pages, sched, x, out, n_pages, rows * (kLanes / 4), P, stage, copy,
      reduce);
  return static_cast<int>(cudaGetLastError());
}
