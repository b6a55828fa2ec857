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
// pages, no chunking, no ray packets. Semantics are those of
// pbrt_tpu_torch/ops/bvh8.py (bvh8_intersect_plain), kept operation for
// operation: slabs of slab.cuh, children dequantised as origin + q * scale,
// leaves in slot order with the strict-< triangle test of
// tri_intersect.cuh (t > 1e-5), interior children pushed by the ray's own
// direction sign along the node axis. The library builds with -fmad=false,
// so every product and sum rounds as in the plain version.
#include <cuda_runtime.h>
#include <math.h>

#include "slab.cuh"
#include "tri_intersect.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kStack = 96;
constexpr int kWidth = 8;
constexpr int kNodeF = 8;
constexpr int kNodeQ = kWidth * 3;
constexpr int kTriFloats9 = 9;
constexpr int kCntEmpty = 255;
constexpr float kTMin = 1e-5f;

using pbrt_tpu_torch::slab;

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
  int stack[kStack];
  int sp = 0;
  if (slab(__ldg(nodes_f), __ldg(nodes_f + 1), __ldg(nodes_f + 2),
           __ldg(nodes_f + 3), __ldg(nodes_f + 4), __ldg(nodes_f + 5), ox, oy,
           oz, ix, iy, iz, t_best)) {
    stack[sp++] = 0;
  }
  while (sp > 0) {
    const int cur = stack[--sp];
    const float* fr = nodes_f + 8 + cur * kNodeF;
    const float onx = __ldg(fr), ony = __ldg(fr + 1), onz = __ldg(fr + 2);
    const float sx = __ldg(fr + 3), sy = __ldg(fr + 4), sz = __ldg(fr + 5);
    const int axis = __float2int_rn(__ldg(fr + 6));
    const bool neg = (axis == 0 ? dx : (axis == 1 ? dy : dz)) < 0.0f;
    const int* q = nodes_q + cur * kNodeQ;
    int w0[kWidth], first[kWidth];
    unsigned hit = 0u;   // bit c: child c's box is hit at entry
#pragma unroll
    for (int c = 0; c < kWidth; ++c) {
      w0[c] = __ldg(q + 3 * c);
      const int w1 = __ldg(q + 3 * c + 1);
      first[c] = __ldg(q + 3 * c + 2);
      const float lox = onx + static_cast<float>(w0[c] & 255) * sx;
      const float loy = ony + static_cast<float>((w0[c] >> 8) & 255) * sy;
      const float loz = onz + static_cast<float>((w0[c] >> 16) & 255) * sz;
      const float hix = onx + static_cast<float>(w1 & 255) * sx;
      const float hiy = ony + static_cast<float>((w1 >> 8) & 255) * sy;
      const float hiz = onz + static_cast<float>((w1 >> 16) & 255) * sz;
      if (slab(lox, loy, loz, hix, hiy, hiz, ox, oy, oz, ix, iy, iz,
               t_best)) {
        hit |= 1u << c;
      }
    }
    // leaves, in slot order
#pragma unroll
    for (int c = 0; c < kWidth; ++c) {
      const int cnt = (w0[c] >> 24) & 255;
      if (!((hit >> c) & 1u) || cnt == 0 || cnt == kCntEmpty) continue;
      for (int k = 0; k < cnt; ++k) {
        const int s = first[c] + k;
        float t, u, v;
        if (pbrt_tpu_torch::tri_test(tris + kTriFloats9 * s, ox, oy, oz, dx,
                                     dy, dz, t_best, t, u, v, kTMin)) {
          t_best = t;
          slot = s;
          b1 = u;
          b2 = v;
          if (any_hit) goto done;
        }
      }
    }
    // interior children, the near side pushed last so it pops first
    if (neg) {
#pragma unroll
      for (int c = 0; c < kWidth; ++c) {
        if (((hit >> c) & 1u) && ((w0[c] >> 24) & 255) == 0) {
          stack[sp++] = first[c];
        }
      }
    } else {
#pragma unroll
      for (int c = kWidth - 1; c >= 0; --c) {
        if (((hit >> c) & 1u) && ((w0[c] >> 24) & 255) == 0) {
          stack[sp++] = first[c];
        }
      }
    }
  }
done:
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
