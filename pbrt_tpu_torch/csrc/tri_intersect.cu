// Brute-force ray-triangle intersection for Hopper (sm_90a).
//
// Replaces the TPU kernel pbrt_tpu/ops/pallas_intersect.py::_tri_kernel
// (body _tri_block_math, entry brute_force_intersect).
//
// What bounds it on this card: per ray it reads 28 B (o, d, t_max) and
// writes 16 B, against ~30 dependent flops per triangle; at the cornell
// box's 32 triangles that is ~1000 flops per 44 B, so it is bound by
// latency and instruction throughput, not by memory bandwidth.
//
// Design: one thread per ray runs the whole pool (tri_intersect.cuh). The
// pool (<= a few KB) is copied once per block into shared memory; all
// threads of a warp read the same triangle row together, which shared
// memory broadcasts without bank conflicts. Nothing crosses blocks.
#include <cuda_runtime.h>

#include "tri_intersect.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
tri_intersect_kernel(const float* __restrict__ tri,
                     const float* __restrict__ o, const float* __restrict__ d,
                     const float* __restrict__ t_max, float* __restrict__ t_out,
                     int* __restrict__ prim_out, float* __restrict__ b1_out,
                     float* __restrict__ b2_out, int n, int n_tris,
                     int n_real, int any_hit) {
  extern __shared__ float s_tri[];
  for (int i = threadIdx.x; i < n_tris * pbrt_tpu_torch::kTriFloats;
       i += blockDim.x) {
    s_tri[i] = tri[i];
  }
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const pbrt_tpu_torch::Hit h = pbrt_tpu_torch::intersect_pool(
      s_tri, n_tris, n_real, o[3 * i], o[3 * i + 1], o[3 * i + 2], d[3 * i],
      d[3 * i + 1], d[3 * i + 2], t_max[i], any_hit != 0);
  t_out[i] = h.t;
  prim_out[i] = h.prim;
  b1_out[i] = h.b1;
  b2_out[i] = h.b2;
}

}  // namespace

// o, d: (n, 3) float32; t_max, t, b1, b2: (n,) float32; prim: (n,) int32.
// Runs on the calling thread's current device, which the caller sets to the
// one the tensors live on. Returns cudaGetLastError() after the launch.
extern "C" int tri_intersect_launch(const float* tri, const float* o,
                                    const float* d, const float* t_max,
                                    float* t, int* prim, float* b1, float* b2,
                                    int n, int n_tris, int n_real,
                                    int any_hit, void* stream) {
  const size_t smem = sizeof(float) * n_tris * pbrt_tpu_torch::kTriFloats;
  const int blocks = (n + kThreads - 1) / kThreads;
  tri_intersect_kernel<<<blocks, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      tri, o, d, t_max, t, prim, b1, b2, n, n_tris, n_real, any_hit);
  return static_cast<int>(cudaGetLastError());
}
