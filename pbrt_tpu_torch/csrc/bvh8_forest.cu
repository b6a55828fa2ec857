// BVH8 forest traversal for Hopper (sm_90a): pages staged in shared memory.
//
// Replaces the TPU kernel pbrt_tpu/ops/pallas_bvh8.py::_forest_kernel
// (launched by _run_forest, entry forest_intersect). The forest is the
// binary SAH tree cut into K subtree chunks, each an unquantised 8-wide
// BVH packed with its triangles into one page of rows x 128 floats
// (ops/bvh8.py BVH8Forest): 72 floats a node (8 children [lo3, hi3, first,
// cnt], cnt 0 interior, -1 empty; the split axis at float 64), then
// 10-float triangles [p0, e1, e2, original id] from float tri_base on.
//
// Design: one CTA of 1,024 threads per block of 1,024 rays, one ray per
// thread with a 96-entry stack in local memory. The CTA walks the K chunks
// in order. For each, every ray slab-tests the chunk's root box (meta)
// against its own running t (in any-hit mode only while it holds no hit);
// __syncthreads_or decides whether any ray of the CTA needs the page, and
// if one does, the CTA copies the page into dynamic shared memory with
// plain cooperative float4 loads and each such ray traverses it. The TPU
// kernel shared one stack and the push order of the block's majority
// direction among its 1,024 rays; here each ray pushes by its own sign, so
// only the winner of an exact t tie can differ.
//
// What bounds it on this card: a page is copied whole (up to 227 KB)
// whenever one ray of the CTA needs it, so the bytes staged are pages x
// CTAs that touch them, far more than the tables; incoherent rays make
// every CTA copy every page. The traversal itself is latency-bound.
// One CTA per SM (its shared memory), at most 64 registers a thread.
//
// Per-ray semantics, as the plain version (forest_intersect_plain): chunks
// in order, node 0 of a chunk entered when its root box passes, children
// slab-tested against the running t, leaf triangles in slot order with the
// strict-< test of tri_intersect.cuh (t > 1e-5), interior children pushed
// so the near side pops first; the hit's id is the triangle's own float
// id. Built with -fmad=false.
#include <cuda_runtime.h>
#include <math.h>

#include "slab.cuh"
#include "tri_intersect.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kStack = 96;
constexpr int kWidth = 8;
constexpr int kNodeF = kWidth * 8 + 8;   // 72 floats a node
constexpr int kTriF = 10;
constexpr int kMeta = 8;
constexpr float kTMin = 1e-5f;

using pbrt_tpu_torch::slab;

// one ray through the page in shared memory; t_best, prim, b1, b2 carry
// the best hit so far and are overwritten by a better one
__device__ __forceinline__ void forest_walk(
    const float* __restrict__ page, int tri_base, float ox, float oy,
    float oz, float dx, float dy, float dz, float ix, float iy, float iz,
    bool any_hit, int* stack, float& t_best, int& prim, float& b1,
    float& b2) {
  int sp = 0;
  stack[sp++] = 0;
  while (sp > 0) {
    const int cur = stack[--sp];
    const float* node = page + cur * kNodeF;
    const int axis = __float2int_rn(node[kWidth * 8]);
    const bool neg = (axis == 0 ? dx : (axis == 1 ? dy : dz)) < 0.0f;
    unsigned hit = 0u;   // bit c: child c's box is hit at entry
#pragma unroll
    for (int c = 0; c < kWidth; ++c) {
      const float* ch = node + 8 * c;
      if (slab(ch[0], ch[1], ch[2], ch[3], ch[4], ch[5], ox, oy, oz, ix, iy,
               iz, t_best)) {
        hit |= 1u << c;
      }
    }
    // leaves, in slot order
#pragma unroll
    for (int c = 0; c < kWidth; ++c) {
      const int cnt = __float2int_rn(node[8 * c + 7]);
      if (!((hit >> c) & 1u) || cnt <= 0) continue;
      const int first = __float2int_rn(node[8 * c + 6]);
      for (int k = 0; k < cnt; ++k) {
        const float* row = page + tri_base + (first + k) * kTriF;
        float t, u, v;
        if (pbrt_tpu_torch::tri_test(row, ox, oy, oz, dx, dy, dz, t_best, t,
                                     u, v, kTMin)) {
          t_best = t;
          prim = __float2int_rn(row[9]);
          b1 = u;
          b2 = v;
          if (any_hit) return;
        }
      }
    }
    // interior children, the near side pushed last so it pops first
#pragma unroll
    for (int j = 0; j < kWidth; ++j) {
      const int c = neg ? j : kWidth - 1 - j;
      if (((hit >> c) & 1u) && __float2int_rn(node[8 * c + 7]) == 0) {
        stack[sp++] = __float2int_rn(node[8 * c + 6]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
bvh8_forest_kernel(const float* __restrict__ meta,
                   const float* __restrict__ pages,
                   const float* __restrict__ o, const float* __restrict__ d,
                   const float* __restrict__ t_max, float* __restrict__ t_out,
                   int* __restrict__ prim_out, float* __restrict__ b1_out,
                   float* __restrict__ b2_out, int n, int n_chunks,
                   int page_floats, int any_hit) {
  extern __shared__ float4 page4[];
  float* page = reinterpret_cast<float*>(page4);
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool ray = i < n;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 1.0f, dy = 1.0f, dz = 1.0f;
  float t_best = -1.0f;
  if (ray) {
    ox = o[3 * i];
    oy = o[3 * i + 1];
    oz = o[3 * i + 2];
    dx = d[3 * i];
    dy = d[3 * i + 1];
    dz = d[3 * i + 2];
    t_best = t_max[i];
  }
  const float ix = 1.0f / (dx == 0.0f ? 1e-20f : dx);
  const float iy = 1.0f / (dy == 0.0f ? 1e-20f : dy);
  const float iz = 1.0f / (dz == 0.0f ? 1e-20f : dz);
  int prim = -1;
  float b1 = 0.0f, b2 = 0.0f;
  int stack[kStack];
  for (int k = 0; k < n_chunks; ++k) {
    const float* m = meta + kMeta * k;
    const bool need = ray && !(any_hit && prim >= 0) &&
                      slab(__ldg(m + 2), __ldg(m + 3), __ldg(m + 4),
                           __ldg(m + 5), __ldg(m + 6), __ldg(m + 7), ox, oy,
                           oz, ix, iy, iz, t_best);
    // also the barrier after which the previous page may be overwritten
    if (!__syncthreads_or(need)) continue;
    const float4* src = reinterpret_cast<const float4*>(
        pages + size_t(k) * page_floats);
    for (int j = threadIdx.x; j < page_floats / 4; j += kThreads)
      page4[j] = src[j];
    __syncthreads();
    if (need) {
      forest_walk(page, __float2int_rn(__ldg(m + 1)), ox, oy, oz, dx, dy, dz,
                  ix, iy, iz, any_hit, stack, t_best, prim, b1, b2);
    }
  }
  if (ray) {
    const bool found = prim >= 0;
    t_out[i] = found ? t_best : INFINITY;
    prim_out[i] = prim;
    b1_out[i] = b1;
    b2_out[i] = b2;
  }
}

}  // namespace

// meta (K*8,) float32 and pages (K, page_floats) float32: the forest
// (ops/bvh8.py BVH8Forest), page_floats a multiple of 128; o, d (n, 3),
// t_max, t, b1, b2 (n,) float32; prim (n,) int32 (original ids, exact as
// floats up to 2^24). Dynamic shared memory: page_floats * 4 bytes, at
// most 232,448 (the caller checks). Runs on the calling thread's current
// device. Returns cudaGetLastError() after the launch.
extern "C" int bvh8_forest_launch(const float* meta, const float* pages,
                                  const float* o, const float* d,
                                  const float* t_max, float* t, int* prim,
                                  float* b1, float* b2, int n, int n_chunks,
                                  int page_floats, int any_hit,
                                  void* stream) {
  const int smem = page_floats * 4;
  cudaError_t err = cudaFuncSetAttribute(
      bvh8_forest_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n + kThreads - 1) / kThreads;
  bvh8_forest_kernel<<<blocks, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      meta, pages, o, d, t_max, t, prim, b1, b2, n, n_chunks, page_floats,
      any_hit);
  return static_cast<int>(cudaGetLastError());
}
