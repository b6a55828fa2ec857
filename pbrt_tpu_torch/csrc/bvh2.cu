// Binary BVH closest/any-hit traversal for Hopper (sm_90a), in one level or
// in two (a TLAS over instances, each instance entering a prototype's BLAS).
//
// Replaces two TPU kernels of pbrt_tpu/ops/pallas_bvh.py:
// - _bvh_kernel (body _traverse_block, entry bvh_intersect): the
//   single-level packet BVH2, here bvh2_kernel;
// - _bvh2_kernel (body _traverse_two_level, entry
//   two_level_intersect_pallas via _run2): the TLAS/BLAS traversal of
//   static instances, here two_level_kernel.
// The TPU kernels share one scalar SMEM stack among a 1,024-ray block and
// push children by the block's majority direction; here each ray has its
// own stack and pushes by the sign of its own world direction along the
// node axis, which can change only the winner of an exact t tie and the
// prim an any-hit query reports.
//
// What bounds them on this card: per ray 28 B in and 16-20 B out, and the
// tables of the scenes that use them (kB to a few MB) stay in the 50 MB L2,
// so a walk is bound by the latency of its chain of dependent fetches and
// by the instructions a warp issues for its 32 divergent rays, not by HBM.
// The instances scene (25 instances of a 12-triangle cube) makes the walk
// short: ~13 node visits, 2 instance entries and 1.6 triangle tests a
// camera ray, so what a step costs a visit counts, and so does what a
// launch costs per ray.
//
// The two-level kernel's design, a thread a ray over the node rows as the
// single-level one:
// - 64 B instance rows [w2o (12), BLAS root's node row, instance id, 0, 0]
//   read as four float4, in place of fourteen scalar loads of the 264 B
//   reference row; the world ray's reciprocals stay in registers for
//   RETURN (the same division of the same value: the same bits);
// - 48 B triangle rows [p0, p1 - p0, p2 - p0, id, 0, 0] read as three
//   float4: the edges are subtracted once at scene build, one float32
//   subtraction each as the test makes them (-fmad=false), so they are the
//   same floats (ops/bvh2.py::kernel_tables);
// - the slab tests look for NaN once (slab.cuh, slab_entry), with the
//   answers of slab.
// Measured and dropped (PERF.md has the times): a persistent grid whose
// warps refill (from one counter for the grid or from a block's own
// chunks), with the leaves of a warp tested side by side (while-while),
// and both children's boxes in the parent (the curve kernel's wide rows,
// with far children's entry distances on the stack). They paid on 2^20
// rays into the 64-instance grid of a 20,482-triangle mesh but cost up to
// 1.85x on the instances wave's short walks; the wide rows alone were
// slower than the node rows on every ray set.
//
// Semantics are those of pbrt_tpu_torch/ops/bvh2.py (_traverse, the plain
// version), kept operation for operation:
// - node rows (Nn, 8) [lo, hi, roff, meta], the ints value-encoded floats,
//   meta = nprim << 2 | axis; a leaf holds at most 4 prims; in two levels a
//   node index >= tlas_root is a TLAS node, whose leaf prims are
//   instances;
// - slabs on the current-space ray against the running t_best, inv_d = 1 /
//   (d == 0 ? 1e-20 : d);
// - Moeller-Trumbore on [p0, p1 - p0, p2 - p0]: accepted when det * s >
//   1e-12 (s the sign of det), u_n >= 0, v_n >= 0, u_n + v_n <= det * s,
//   t = t_n * (1 / det_a) > 1e-5 and t < t_best (strict: on equal t the
//   earlier triangle of a leaf wins);
// - a TLAS leaf pushes ENTER = -2 - instance for each of its prims in
//   order; popping ENTER maps the world ray by the instance's w2o (each
//   row a0 x + a1 y + a2 z + a3; directions without a3, not normalised, so
//   t stays the world ray's), sets the current instance, pushes RETURN (-1)
//   and goes to the BLAS root; popping RETURN restores the world ray and
//   pops again at once;
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
constexpr float kTMin = 1e-5f;

using pbrt_tpu_torch::slab;
using pbrt_tpu_torch::slab_entry;

__device__ __forceinline__ float inv_dir(float d) {
  return 1.0f / (d == 0.0f ? 1e-20f : d);
}

// Moeller-Trumbore on a triangle's p0 and edges, in the operation order of
// ops/bvh2.py::_tri_test. True when the hit is accepted below t_best.
__device__ __forceinline__ bool tri_test_edges(
    float p0x, float p0y, float p0z, float e1x, float e1y, float e1z,
    float e2x, float e2y, float e2z, float ox, float oy, float oz, float dx,
    float dy, float dz, float t_best, float& t, float& b1, float& b2) {
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

// The same test on a raw [p0, p1, p2, id] row: the edges subtracted here.
__device__ __forceinline__ bool tri_test_raw(const float* __restrict__ r,
                                             float ox, float oy, float oz,
                                             float dx, float dy, float dz,
                                             float t_best, float& t,
                                             float& b1, float& b2) {
  const float p0x = __ldg(r), p0y = __ldg(r + 1), p0z = __ldg(r + 2);
  return tri_test_edges(p0x, p0y, p0z, __ldg(r + 3) - p0x,
                        __ldg(r + 4) - p0y, __ldg(r + 5) - p0z,
                        __ldg(r + 6) - p0x, __ldg(r + 7) - p0y,
                        __ldg(r + 8) - p0z, ox, oy, oz, dx, dy, dz, t_best,
                        t, b1, b2);
}

// ---------------------------------------------------------------------------
// One level: a thread a ray over the node rows and the raw triangle rows.

__global__ void __launch_bounds__(kThreads)
bvh2_kernel(const float* __restrict__ nodes, const float* __restrict__ tris,
            const float* __restrict__ o, const float* __restrict__ d,
            const float* __restrict__ t_max, float* __restrict__ t_out,
            int* __restrict__ prim_out, float* __restrict__ b1_out,
            float* __restrict__ b2_out, int n, int any_hit) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
  const float ix = inv_dir(dx), iy = inv_dir(dy), iz = inv_dir(dz);
  float t_best = t_max[i];
  int prim = -1;
  float b1 = 0.0f, b2 = 0.0f;
  int stack[kStack];
  int sp = 0;
  int cur = 0;
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
        const bool neg = (axis == 0 ? dx : (axis == 1 ? dy : dz)) < 0.0f;
        stack[sp++] = neg ? cur + 1 : roff;
        cur = neg ? roff : cur + 1;
        continue;
      }
      const int m = nprim < kMaxLeaf ? nprim : kMaxLeaf;
      for (int k = 0; k < m; ++k) {
        const float* r = tris + kTriCols * (roff + k);
        float t, u, v;
        if (tri_test_raw(r, ox, oy, oz, dx, dy, dz, t_best, t, u, v)) {
          t_best = t;
          prim = __float2int_rn(__ldg(r + 9));
          b1 = u;
          b2 = v;
          if (any_hit) goto done;
        }
      }
    }
    if (sp == 0) break;
    cur = stack[--sp];
  }
done:
  const bool found = prim >= 0;
  t_out[i] = found ? t_best : INFINITY;
  prim_out[i] = prim;
  b1_out[i] = b1;
  b2_out[i] = b2;
}

// ---------------------------------------------------------------------------
// Two levels: a thread a ray over the node rows, the instances and
// triangles from the kernel's own rows.

constexpr int kInstQuads = 4;     // 16 B quarters of a 64 B instance row
constexpr int kTriQuads = 3;      // of a 48 B triangle row
// stack tokens besides node rows (>= 0): RETURN, and ENTER instance k as
// -2 - k
constexpr int kReturn = -1;

__global__ void __launch_bounds__(kThreads)
two_level_kernel(const float* __restrict__ nodes,
                 const float4* __restrict__ insts,
                 const float4* __restrict__ rows,
                 const float* __restrict__ o, const float* __restrict__ d,
                 const float* __restrict__ t_max, float* __restrict__ t_out,
                 int* __restrict__ prim_out, float* __restrict__ b1_out,
                 float* __restrict__ b2_out, int* __restrict__ inst_out, int n,
                 int tlas_root, int any_hit) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float wox = o[3 * i], woy = o[3 * i + 1], woz = o[3 * i + 2];
  const float wdx = d[3 * i], wdy = d[3 * i + 1], wdz = d[3 * i + 2];
  const float wix = inv_dir(wdx), wiy = inv_dir(wdy), wiz = inv_dir(wdz);
  float ox = wox, oy = woy, oz = woz, dx = wdx, dy = wdy, dz = wdz;
  float ix = wix, iy = wiy, iz = wiz;
  float t_best = t_max[i];
  int prim = -1, inst = -1, cur_inst = -1;
  float b1 = 0.0f, b2 = 0.0f;
  int stack[kStack];
  int sp = 0;
  int cur = tlas_root;
  while (true) {
    const float4 ra = __ldg(reinterpret_cast<const float4*>(
        nodes + kNodeCols * cur));
    const float4 rb = __ldg(reinterpret_cast<const float4*>(
        nodes + kNodeCols * cur + 4));
    const int roff = __float2int_rn(rb.z);
    const int meta = __float2int_rn(rb.w);
    const int nprim = meta >> 2;
    const int axis = meta & 3;
    float tmin;
    if (slab_entry(ra.x, ra.y, ra.z, ra.w, rb.x, rb.y, ox, oy, oz, ix, iy,
                   iz, t_best, tmin)) {
      if (nprim == 0) {
        const bool neg = (axis == 0 ? wdx : (axis == 1 ? wdy : wdz)) < 0.0f;
        stack[sp++] = neg ? cur + 1 : roff;
        cur = neg ? roff : cur + 1;
        continue;
      }
      const int m = nprim < kMaxLeaf ? nprim : kMaxLeaf;
      if (cur >= tlas_root) {
        for (int k = 0; k < m; ++k) stack[sp++] = -2 - (roff + k);
      } else {
        for (int k = 0; k < m; ++k) {
          // qa = p0.xyz e1.x; qb = e1.yz e2.xy; qc = e2.z id 0 0
          const float4* r = rows + size_t(kTriQuads) * (roff + k);
          const float4 qa = __ldg(r), qb = __ldg(r + 1), qc = __ldg(r + 2);
          float t, u, v;
          const bool ok = tri_test_edges(qa.x, qa.y, qa.z, qa.w, qb.x, qb.y,
                                         qb.z, qb.w, qc.x, ox, oy, oz, dx, dy,
                                         dz, t_best, t, u, v);
          if (ok) {
            t_best = t;
            prim = __float2int_rn(qc.y);
            inst = cur_inst;
            b1 = u;
            b2 = v;
            if (any_hit) goto done;
          }
        }
      }
    }
    if (sp == 0) break;
    int tok = stack[--sp];
    if (tok == kReturn) {
      ox = wox, oy = woy, oz = woz, dx = wdx, dy = wdy, dz = wdz;
      ix = wix, iy = wiy, iz = wiz;
      cur_inst = -1;
      if (sp == 0) break;
      tok = stack[--sp];
    }
    if (tok <= -2) {
      const float4* a = insts + size_t(kInstQuads) * (-2 - tok);
      const float4 r0 = __ldg(a), r1 = __ldg(a + 1), r2 = __ldg(a + 2),
                   r3 = __ldg(a + 3);
      ox = r0.x * wox + r0.y * woy + r0.z * woz + r0.w;
      oy = r1.x * wox + r1.y * woy + r1.z * woz + r1.w;
      oz = r2.x * wox + r2.y * woy + r2.z * woz + r2.w;
      dx = r0.x * wdx + r0.y * wdy + r0.z * wdz;
      dy = r1.x * wdx + r1.y * wdy + r1.z * wdz;
      dz = r2.x * wdx + r2.y * wdy + r2.z * wdz;
      ix = inv_dir(dx), iy = inv_dir(dy), iz = inv_dir(dz);
      cur_inst = __float_as_int(r3.y);
      stack[sp++] = kReturn;
      cur = __float_as_int(r3.x);
      continue;
    }
    cur = tok;
  }
done:
  const bool found = prim >= 0;
  t_out[i] = found ? t_best : INFINITY;
  prim_out[i] = prim;
  b1_out[i] = b1;
  b2_out[i] = b2;
  inst_out[i] = inst;
}

}  // namespace

// nodes (Nn*8,), tris (T*10,) float32: the binary BVH's tables
// (ops/bvh2.py); o, d: (n, 3) float32; t_max, t, b1, b2: (n,) float32;
// prim: (n,) int32. Runs on the calling thread's current device, which the
// caller sets to the one the tensors live on. Returns cudaGetLastError()
// after the launch.
extern "C" int bvh2_intersect_launch(const float* nodes, const float* tris,
                                     const float* o, const float* d,
                                     const float* t_max, float* t, int* prim,
                                     float* b1, float* b2, int n, int any_hit,
                                     void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  bvh2_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      nodes, tris, o, d, t_max, t, prim, b1, b2, n, any_hit);
  return static_cast<int>(cudaGetLastError());
}

// nodes (Nn*8,) float32: the BLAS node rows, then the TLAS's from
// tlas_root on; insts (I*16,) float32: the kernel's instance rows, rows
// (T*12,) float32 its triangle rows (ops/bvh2.py::kernel_tables); nodes,
// insts and rows 16-byte aligned. o, d: (n, 3) float32; t_max, t, b1, b2: (n,) float32; prim, inst: (n,)
// int32. Runs on the calling thread's current device, which the caller sets to the
// one the tensors live on. Returns cudaGetLastError() after the launch.
extern "C" int two_level_launch(const float* nodes, const float* insts,
                                const float* rows, const float* o,
                                const float* d, const float* t_max, float* t,
                                int* prim, float* b1, float* b2, int* inst,
                                int n, int tlas_root, int any_hit,
                                void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  two_level_kernel<<<blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      nodes, reinterpret_cast<const float4*>(insts),
      reinterpret_cast<const float4*>(rows), o, d, t_max, t, prim, b1, b2,
      inst, n, tlas_root, any_hit);
  return static_cast<int>(cudaGetLastError());
}
