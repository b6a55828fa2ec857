// Binary BVH closest/any-hit traversal for Hopper (sm_90a), in one level or
// in two (a TLAS over instances, each instance entering a prototype's BLAS).
//
// Replaces two TPU kernels of pbrt_tpu/ops/pallas_bvh.py:
// - _bvh_kernel (body _traverse_block, entry bvh_intersect): the
//   single-level packet BVH2, here bvh2_kernel<false>;
// - _bvh2_kernel (body _traverse_two_level, entry
//   two_level_intersect_pallas): the TLAS/BLAS traversal of static
//   instances, here bvh2_kernel<true>.
// Both share the node rows, slab test, triangle test, leaf loop and push
// rule; the two-level one adds the ENTER/RETURN stack tokens and the
// instance transform.
//
// What bounds it on this card: per ray it reads 28 B and writes 16-20 B,
// and per visited node a 32 B row, per tested triangle a 40 B row, per
// entered instance 56 B of its row. The tables of the scenes that use it
// (kB to a few MB) stay in the 50 MB L2, so a traversal is bound by the
// latency of dependent node and triangle loads and by divergence between
// the rays of a warp, not by HBM bandwidth.
//
// Design: one thread per ray, a 64-entry int stack in local memory (the
// reference's STACK), every table in global memory read through the
// read-only path. The TPU kernel shares one scalar SMEM stack among a
// 1,024-ray block and pushes children by the block's majority direction;
// here each ray has its own stack and pushes by the sign of its own world
// direction along the node axis, which can change only the winner of an
// exact t tie and the prim an any-hit query reports. Semantics are those of
// pbrt_tpu_torch/ops/bvh2.py (_traverse, the plain version), kept
// operation for operation:
// - node rows (Nn, 8) [lo, hi, roff, meta], the ints value-encoded floats,
//   meta = nprim << 2 | axis; a leaf holds at most 4 prims; in two-level
//   mode a node index >= tlas_root is a TLAS node, whose leaf prims are
//   instances;
// - slabs of slab.cuh on the current-space ray, inv_d = 1 / (d == 0 ?
//   1e-20 : d);
// - Moeller-Trumbore on raw vertex rows [p0, p1, p2, id] (10 floats):
//   accepted when det * s > 1e-12 (s the sign of det), u_n >= 0, v_n >= 0,
//   u_n + v_n <= det * s, t = t_n * (1 / det_a) > 1e-5 and t < t_best
//   (strict: on equal t the earlier triangle of a leaf wins);
// - a TLAS leaf pushes ENTER = -2 - instance for each of its prims in
//   order; popping ENTER maps the world ray by the instance's w2o (row
//   columns 0:12, each row a0 x + a1 y + a2 z + a3; directions without a3,
//   not normalised, so t stays the world ray's), sets the current instance
//   from column 25, pushes RETURN (-1) and jumps to the BLAS root in column
//   24; popping RETURN restores the world ray and pops again at once;
// - an any-hit ray ends at its first accepted triangle.
// The library builds with -fmad=false, so every product and sum rounds as
// in the plain version.
#include <cuda_runtime.h>
#include <math.h>

#include "slab.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kStack = 64;
constexpr int kMaxLeaf = 4;
constexpr int kNodeCols = 8;
constexpr int kTriCols = 10;
constexpr int kInstCols = 66;
constexpr int kReturn = -1;
constexpr float kTMin = 1e-5f;

using pbrt_tpu_torch::slab;

__device__ __forceinline__ float inv_dir(float d) {
  return 1.0f / (d == 0.0f ? 1e-20f : d);
}

// Moeller-Trumbore on a raw [p0, p1, p2, id] row, in the operation order of
// ops/bvh2.py::_tri_test. True when the hit is accepted below t_best.
__device__ __forceinline__ bool tri_test_raw(const float* __restrict__ r,
                                             float ox, float oy, float oz,
                                             float dx, float dy, float dz,
                                             float t_best, float& t,
                                             float& b1, float& b2) {
  const float p0x = __ldg(r), p0y = __ldg(r + 1), p0z = __ldg(r + 2);
  const float e1x = __ldg(r + 3) - p0x, e1y = __ldg(r + 4) - p0y,
              e1z = __ldg(r + 5) - p0z;
  const float e2x = __ldg(r + 6) - p0x, e2y = __ldg(r + 7) - p0y,
              e2z = __ldg(r + 8) - p0z;
  const float pvx = dy * e2z - dz * e2y;
  const float pvy = dz * e2x - dx * e2z;
  const float pvz = dx * e2y - dy * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  const float s = det < 0.0f ? -1.0f : 1.0f;
  const float det_a = det * s;
  const float tx = ox - p0x, ty = oy - p0y, tz = oz - p0z;
  const float u_n = (tx * pvx + ty * pvy + tz * pvz) * s;
  const float qvx = ty * e1z - tz * e1y;
  const float qvy = tz * e1x - tx * e1z;
  const float qvz = tx * e1y - ty * e1x;
  const float v_n = (dx * qvx + dy * qvy + dz * qvz) * s;
  const float t_n = (e2x * qvx + e2y * qvy + e2z * qvz) * s;
  const float inv_det = 1.0f / (det_a == 0.0f ? 1.0f : det_a);
  t = t_n * inv_det;
  b1 = u_n * inv_det;
  b2 = v_n * inv_det;
  return det_a > 1e-12f && u_n >= 0.0f && v_n >= 0.0f &&
         u_n + v_n <= det_a && t > kTMin && t < t_best;
}

template <bool kTwoLevel>
__global__ void __launch_bounds__(kThreads)
bvh2_kernel(const float* __restrict__ nodes, const float* __restrict__ insts,
            const float* __restrict__ tris, const float* __restrict__ o,
            const float* __restrict__ d, const float* __restrict__ t_max,
            float* __restrict__ t_out, int* __restrict__ prim_out,
            float* __restrict__ b1_out, float* __restrict__ b2_out,
            int* __restrict__ inst_out, int n, int tlas_root, int any_hit) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float wox = o[3 * i], woy = o[3 * i + 1], woz = o[3 * i + 2];
  const float wdx = d[3 * i], wdy = d[3 * i + 1], wdz = d[3 * i + 2];
  // the current-space ray: the world ray, or an instance's object-space one
  float ox = wox, oy = woy, oz = woz, dx = wdx, dy = wdy, dz = wdz;
  float ix = inv_dir(dx), iy = inv_dir(dy), iz = inv_dir(dz);
  float t_best = t_max[i];
  int prim = -1, inst = -1, cur_inst = -1;
  float b1 = 0.0f, b2 = 0.0f;
  int stack[kStack];
  int sp = 0;
  int cur = kTwoLevel ? tlas_root : 0;
  while (true) {
    const float4 ra = __ldg(reinterpret_cast<const float4*>(
        nodes + kNodeCols * cur));
    const float4 rb = __ldg(reinterpret_cast<const float4*>(
        nodes + kNodeCols * cur + 4));
    const int roff = __float2int_rn(rb.z);
    const int meta = __float2int_rn(rb.w);
    const int nprim = meta >> 2;
    const int axis = meta & 3;
    if (slab(ra.x, ra.y, ra.z, ra.w, rb.x, rb.y, ox, oy, oz, ix, iy, iz,
             t_best)) {
      if (nprim == 0) {
        // interior: push the far child, descend into the near one
        const bool neg = (axis == 0 ? wdx : (axis == 1 ? wdy : wdz)) < 0.0f;
        stack[sp++] = neg ? cur + 1 : roff;
        cur = neg ? roff : cur + 1;
        continue;
      }
      const int m = nprim < kMaxLeaf ? nprim : kMaxLeaf;
      if (kTwoLevel && cur >= tlas_root) {
        for (int k = 0; k < m; ++k) stack[sp++] = -2 - (roff + k);
      } else {
        for (int k = 0; k < m; ++k) {
          const float* r = tris + kTriCols * (roff + k);
          float t, u, v;
          if (tri_test_raw(r, ox, oy, oz, dx, dy, dz, t_best, t, u, v)) {
            t_best = t;
            prim = __float2int_rn(__ldg(r + 9));
            inst = cur_inst;
            b1 = u;
            b2 = v;
            if (any_hit) goto done;
          }
        }
      }
    }
    // pop, with the two-level tokens
    if (sp == 0) break;
    int tok = stack[--sp];
    if (kTwoLevel) {
      if (tok == kReturn) {
        ox = wox; oy = woy; oz = woz;
        dx = wdx; dy = wdy; dz = wdz;
        ix = inv_dir(dx); iy = inv_dir(dy); iz = inv_dir(dz);
        cur_inst = -1;
        if (sp == 0) break;
        tok = stack[--sp];
      }
      if (tok <= -2) {
        const float* a = insts + kInstCols * (-2 - tok);
        const float a00 = __ldg(a), a01 = __ldg(a + 1), a02 = __ldg(a + 2),
                    a03 = __ldg(a + 3), a10 = __ldg(a + 4),
                    a11 = __ldg(a + 5), a12 = __ldg(a + 6),
                    a13 = __ldg(a + 7), a20 = __ldg(a + 8),
                    a21 = __ldg(a + 9), a22 = __ldg(a + 10),
                    a23 = __ldg(a + 11);
        ox = a00 * wox + a01 * woy + a02 * woz + a03;
        oy = a10 * wox + a11 * woy + a12 * woz + a13;
        oz = a20 * wox + a21 * woy + a22 * woz + a23;
        dx = a00 * wdx + a01 * wdy + a02 * wdz;
        dy = a10 * wdx + a11 * wdy + a12 * wdz;
        dz = a20 * wdx + a21 * wdy + a22 * wdz;
        ix = inv_dir(dx); iy = inv_dir(dy); iz = inv_dir(dz);
        cur_inst = __float2int_rn(__ldg(a + 25));
        stack[sp++] = kReturn;
        cur = __float2int_rn(__ldg(a + 24));
        continue;
      }
    }
    cur = tok;
  }
done:
  const bool found = prim >= 0;
  t_out[i] = found ? t_best : INFINITY;
  prim_out[i] = prim;
  b1_out[i] = b1;
  b2_out[i] = b2;
  if (kTwoLevel) inst_out[i] = inst;
}

}  // namespace

// nodes (Nn*8,), tris (T*10,) float32: the BVH tables (ops/bvh2.py); insts
// (I*66,) float32 and inst_out (n,) int32 in two-level mode, else unused;
// o, d: (n, 3) float32; t_max, t, b1, b2: (n,) float32; prim: (n,) int32.
// Runs on the calling thread's current device, which the caller sets to the
// one the tensors live on. Returns cudaGetLastError() after the launch.
extern "C" int bvh2_intersect_launch(const float* nodes, const float* insts,
                                     const float* tris, const float* o,
                                     const float* d, const float* t_max,
                                     float* t, int* prim, float* b1,
                                     float* b2, int* inst, int n,
                                     int tlas_root, int two_level,
                                     int any_hit, void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (two_level) {
    bvh2_kernel<true><<<blocks, kThreads, 0, s>>>(
        nodes, insts, tris, o, d, t_max, t, prim, b1, b2, inst, n, tlas_root,
        any_hit);
  } else {
    bvh2_kernel<false><<<blocks, kThreads, 0, s>>>(
        nodes, insts, tris, o, d, t_max, t, prim, b1, b2, inst, n, tlas_root,
        any_hit);
  }
  return static_cast<int>(cudaGetLastError());
}
