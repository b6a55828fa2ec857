// 8-wide BVH closest/any-hit traversal for Hopper (sm_90a).
//
// Replaces the TPU kernel pbrt_tpu/ops/pallas_bvh8.py::_bvh8_kernel (body
// _traverse_page, entry bvh8_intersect), and with it chunked_intersect,
// which only exists to fit the TPU's scalar memory.
//
// What bounds it on this card: per ray it reads 28 B and writes 16 B, and
// per visited node 128 B of node data (a 32 B frame and 96 B of quantised
// child words) and 36 B per tested triangle. The tables of a scene of tens
// of thousands of triangles (about 1 MB) stay in the 50 MB L2, so a
// traversal is bound by the latency of dependent node and triangle loads
// and by divergence between the rays of a warp, not by HBM bandwidth.
//
// Design: one thread per ray, a 96-entry stack in local memory, the whole
// tree in global memory read through the read-only path. No shared-memory
// pages, no chunking, no ray packets. The traversal is bvh8_traverse.cuh's
// (shared with the binned page kernel, bvh8_binned.cu), with the semantics
// of pbrt_tpu_torch/ops/bvh8.py (bvh8_intersect_plain), kept operation for
// operation; the library builds with -fmad=false, so every product and sum
// rounds as in the plain version.
#include <cuda_runtime.h>
#include <math.h>

#include "bvh8_traverse.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
bvh8_kernel(const float* __restrict__ nodes_f, const int* __restrict__ nodes_q,
            const float* __restrict__ tris,
            const int* __restrict__ prim_indices, const float* __restrict__ o,
            const float* __restrict__ d, const float* __restrict__ t_max,
            float* __restrict__ t_out, int* __restrict__ prim_out,
            float* __restrict__ b1_out, float* __restrict__ b2_out, int n,
            int any_hit) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
  const float ix = 1.0f / (dx == 0.0f ? 1e-20f : dx);
  const float iy = 1.0f / (dy == 0.0f ? 1e-20f : dy);
  const float iz = 1.0f / (dz == 0.0f ? 1e-20f : dz);
  float t_best = t_max[i];
  int slot = -1;
  float b1 = 0.0f, b2 = 0.0f;
  int stack[pbrt_tpu_torch::kBvh8Stack];
  pbrt_tpu_torch::bvh8_walk<pbrt_tpu_torch::GlobalPage>(
      nodes_f, nodes_q, tris, ox, oy, oz, dx, dy, dz, ix, iy, iz, any_hit,
      stack, t_best, slot, b1, b2);
  const bool found = slot >= 0;
  t_out[i] = found ? t_best : INFINITY;
  prim_out[i] = found ? __ldg(prim_indices + slot) : -1;
  b1_out[i] = b1;
  b2_out[i] = b2;
}

}  // namespace

// nodes_f, nodes_q, tris, prim_indices: the BVH8 tables (ops/bvh8.py);
// o, d: (n, 3) float32; t_max, t, b1, b2: (n,) float32; prim: (n,) int32.
// Runs on the calling thread's current device, which the caller sets to the
// one the tensors live on. Returns cudaGetLastError() after the launch.
extern "C" int bvh8_intersect_launch(const float* nodes_f, const int* nodes_q,
                                     const float* tris,
                                     const int* prim_indices, const float* o,
                                     const float* d, const float* t_max,
                                     float* t, int* prim, float* b1,
                                     float* b2, int n, int any_hit,
                                     void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  bvh8_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      nodes_f, nodes_q, tris, prim_indices, o, d, t_max, t, prim, b1, b2, n,
      any_hit);
  return static_cast<int>(cudaGetLastError());
}
