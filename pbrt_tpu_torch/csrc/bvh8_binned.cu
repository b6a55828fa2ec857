// Page-binned BVH8 traversal for Hopper (sm_90a): one round of the host
// loop of pbrt_tpu_torch/ops/bvh8_pages.py::binned_intersect.
//
// Replaces the TPU kernel pbrt_tpu/ops/pallas_bvh8.py::_binned_kernel
// (launched by _run_binned, entry binned_intersect; body _traverse_page).
// The TPU grid (B, P) ran a ray block's P scheduled pages as consecutive
// grid steps that accumulated into the block's output. Here one CTA of
// 1,024 threads owns one ray block (one ray per thread) and walks the P
// entries of its schedule in a loop. For each valid entry it copies the
// page's three tables (frames, quantised child words, 9-float triangles)
// from global into shared memory with plain cooperative loads, and each
// ray that holds no hit yet (any hit) traverses the page with
// bvh8_traverse.cuh, the whole-tree kernel's traversal, reading shared
// memory. A page-local hit becomes a global triangle slot by the page's
// start. Invalid entries (padding of a block with fewer than P pages) are
// skipped. The rounds, the page_entries pre-pass and the schedule stay on
// the host, one launch per round.
//
// What bounds it on this card: each valid entry copies a whole page (up to
// 227 KB, the most shared memory a block can have) whatever share of its
// nodes the block's rays visit; the pages of the million-triangle terrain
// (68 MB) exceed the 50 MB L2, so the copies stream from L2 and HBM. The
// traversal itself is latency-bound like the whole-tree kernel's.
// One CTA per SM (its shared memory), 1,024 threads of at most 64
// registers.
//
// Per-ray semantics, as the plain version (binned_round_plain): the page's
// root union box against the ray's running t first; closest hit keeps the
// strict-< running minimum across pages in schedule order; in any-hit mode
// a ray that holds a hit from an earlier page skips the page, and returns
// at its first hit in a page. Built with -fmad=false.
#include <cuda_runtime.h>
#include <math.h>

#include "bvh8_traverse.cuh"

namespace {

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
bvh8_binned_kernel(const float* __restrict__ nodes_f,
                   const int* __restrict__ nodes_q,
                   const float* __restrict__ tris,
                   const int* __restrict__ page_start,
                   const int* __restrict__ sched,
                   const unsigned char* __restrict__ valid,
                   const float* __restrict__ o, const float* __restrict__ d,
                   float* __restrict__ t, int* __restrict__ slot,
                   float* __restrict__ b1, float* __restrict__ b2, int n,
                   int P, int nfl, int nql, int tl, int any_hit) {
  extern __shared__ float4 smem4[];
  float* s_nf = reinterpret_cast<float*>(smem4);
  int* s_nq = reinterpret_cast<int*>(s_nf + nfl);
  float* s_tr = reinterpret_cast<float*>(s_nq + nql);
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool ray = i < n;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 1.0f, dy = 1.0f, dz = 1.0f;
  float t_c = -1.0f, b1_c = 0.0f, b2_c = 0.0f;
  int slot_c = -1;
  if (ray) {
    ox = o[3 * i];
    oy = o[3 * i + 1];
    oz = o[3 * i + 2];
    dx = d[3 * i];
    dy = d[3 * i + 1];
    dz = d[3 * i + 2];
    t_c = t[i];
    slot_c = slot[i];
    b1_c = b1[i];
    b2_c = b2[i];
  }
  const float ix = 1.0f / (dx == 0.0f ? 1e-20f : dx);
  const float iy = 1.0f / (dy == 0.0f ? 1e-20f : dy);
  const float iz = 1.0f / (dz == 0.0f ? 1e-20f : dz);
  int stack[pbrt_tpu_torch::kBvh8Stack];
  for (int p = 0; p < P; ++p) {
    const int e = blockIdx.x * P + p;
    if (!valid[e]) continue;            // uniform across the block
    const int k = sched[e];
    __syncthreads();                    // the previous page is done with
    // the page widths are multiples of 128 floats: copy in float4s
    const float4* g_nf = reinterpret_cast<const float4*>(nodes_f +
                                                         size_t(k) * nfl);
    const float4* g_nq = reinterpret_cast<const float4*>(nodes_q +
                                                         size_t(k) * nql);
    const float4* g_tr = reinterpret_cast<const float4*>(tris +
                                                         size_t(k) * tl);
    float4* s4_nf = reinterpret_cast<float4*>(s_nf);
    float4* s4_nq = reinterpret_cast<float4*>(s_nq);
    float4* s4_tr = reinterpret_cast<float4*>(s_tr);
    for (int j = threadIdx.x; j < nfl / 4; j += kThreads) s4_nf[j] = g_nf[j];
    for (int j = threadIdx.x; j < nql / 4; j += kThreads) s4_nq[j] = g_nq[j];
    for (int j = threadIdx.x; j < tl / 4; j += kThreads) s4_tr[j] = g_tr[j];
    __syncthreads();
    if (!ray || (any_hit && slot_c >= 0)) continue;
    float t_b = t_c, u = b1_c, v = b2_c;
    int loc = -1;
    pbrt_tpu_torch::bvh8_walk<pbrt_tpu_torch::SharedPage>(
        s_nf, s_nq, s_tr, ox, oy, oz, dx, dy, dz, ix, iy, iz, any_hit, stack,
        t_b, loc, u, v);
    if (loc >= 0) {
      t_c = t_b;
      slot_c = loc + page_start[k];
      b1_c = u;
      b2_c = v;
    }
  }
  if (ray) {
    t[i] = t_c;
    slot[i] = slot_c;
    b1[i] = b1_c;
    b2[i] = b2_c;
  }
}

}  // namespace

// nodes_f (K, nfl), nodes_q (K, nql), tris (K, tl): the chunked pages
// (ops/bvh8.py BVH8Chunked), widths multiples of 128; page_start (K,)
// int32; sched (B, P) int32 and valid (B, P) uint8: each ray block's pages
// for this round; o, d (n, 3) float32; t, b1, b2 (n,) float32 and slot (n,)
// int32: the carried hits, updated in place. Dynamic shared memory: (nfl +
// nql + tl) * 4 bytes, at most 232,448 (the caller checks). Runs on the
// calling thread's current device. Returns cudaGetLastError() after the
// launch.
extern "C" int bvh8_binned_launch(const float* nodes_f, const int* nodes_q,
                                  const float* tris, const int* page_start,
                                  const int* sched,
                                  const unsigned char* valid, const float* o,
                                  const float* d, float* t, int* slot,
                                  float* b1, float* b2, int n, int P,
                                  int nfl, int nql, int tl, int any_hit,
                                  void* stream) {
  const int smem = (nfl + nql + tl) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      bvh8_binned_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n + kThreads - 1) / kThreads;
  bvh8_binned_kernel<<<blocks, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      nodes_f, nodes_q, tris, page_start, sched, valid, o, d, t, slot, b1,
      b2, n, P, nfl, nql, tl, any_hit);
  return static_cast<int>(cudaGetLastError());
}
