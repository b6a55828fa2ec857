// Curve-BVH closest/any-hit traversal for Hopper (sm_90a): cubic Bezier
// hair and fur, pre-split into linear sub-segments at scene build.
//
// Replaces the TPU kernel _curve_kernel of pbrt_tpu/ops/curves.py (body
// _curve_packet_body, entry packet_intersect_curves via _curve_run). There
// the curve BVH's node rows sit whole in SMEM, the whole sub-segment pool
// in VMEM as (S/8, 128) rows, rays arrive as seven (8, 128) planes, and one
// 64-entry SMEM stack is shared by a 1,024-ray block that pushes children
// by the block's majority direction sign.
//
// What bounds it on this card: per ray it reads 28 B and writes 8 B, and
// per visited node a 32 B row, per tested segment 48 B of its 64 B row.
// The node and segment tables of a fur patch (the hair scene's 524,288
// segments: 32 MB of rows and 19 MB of nodes) do not all stay in the 50 MB
// L2, and a traversal is a chain of dependent loads that diverges between
// the rays of a warp: latency and divergence bound it, not HBM bandwidth or
// arithmetic.
//
// Design: one thread per ray, a 64-entry int stack in local memory, both
// tables in global memory read through the read-only path (a node as two
// 16 B loads, a segment row as the three of its four 16 B quarters that
// the test reads). Each ray pushes by the sign of its
// own direction along the node axis, which can change only the winner of
// an exact t tie and the segment an any-hit query reports. Semantics are
// those of pbrt_tpu_torch/ops/curves.py (curves_intersect_plain, the plain
// version), kept operation for operation:
// - node rows (Nn, 8) [lo, hi, roff, meta], the ints value-encoded floats,
//   meta = nprim << 2 | axis, at most 4 segments a leaf;
// - slabs of slab.cuh against the running t_best, inv_d = 1 / (d == 0 ?
//   1e-20 : d);
// - segment rows (S, 16) [pa, pb, wa, wb, ua, ub, n(3), type, id, 0] in
//   leaf order; the test projects both ends into the ray's Duff frame
//   (dn = d / |d|), takes the closest approach of the ray to the chord
//   (w clamped to [0, 1]), accepts when dist^2 <= 0.25 hw^2 (hw the lerped
//   width), and puts t at the axis depth, less the tube profile's edge for
//   a cylinder (type 1), over |d|; a segment is accepted when t > 1e-4 and
//   t < t_best (strict: the earlier segment of a leaf wins a tie);
// - an any-hit ray ends at its first accepted segment.
// The library builds with -fmad=false, so every product and sum rounds as
// in the plain version, and min/max propagate NaN as torch's do.
#include <cuda_runtime.h>
#include <math.h>

#include "slab.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kStack = 64;
constexpr int kMaxLeaf = 4;
constexpr int kNodeCols = 8;
constexpr int kSegCols = 16;
constexpr float kTMin = 1e-4f;

using pbrt_tpu_torch::max_nan;
using pbrt_tpu_torch::min_nan;
using pbrt_tpu_torch::slab;

__device__ __forceinline__ float inv_dir(float d) {
  return 1.0f / (d == 0.0f ? 1e-20f : d);
}

// The ray's unit direction and its Duff frame (utils/vecmath.py
// coordinate_system), in the plain version's operation order.
struct RayFrame {
  float dnx, dny, dnz, t1x, t1y, t1z, t2x, t2y, t2z, dlen;
};

__device__ __forceinline__ RayFrame ray_frame(float dx, float dy, float dz) {
  RayFrame f;
  f.dlen = sqrtf(dx * dx + dy * dy + dz * dz);
  const float len_c = max_nan(f.dlen, 1e-20f);
  f.dnx = dx / len_c;
  f.dny = dy / len_c;
  f.dnz = dz / len_c;
  const float sgn = f.dnz >= 0.0f ? 1.0f : -1.0f;
  const float a = -1.0f / (sgn + f.dnz);
  const float b = f.dnx * f.dny * a;
  f.t1x = 1.0f + sgn * (f.dnx * f.dnx) * a;
  f.t1y = sgn * b;
  f.t1z = -sgn * f.dnx;
  f.t2x = b;
  f.t2y = sgn + (f.dny * f.dny) * a;
  f.t2z = -f.dny;
  return f;
}

// The width-aware 2-D segment test (ops/curves.py::_segment_core). True
// when the segment is accepted below t_best; t is its depth.
__device__ __forceinline__ bool segment_test(const float* __restrict__ r,
                                             float ox, float oy, float oz,
                                             const RayFrame& f, float t_best,
                                             float& t) {
  const float4 q0 = __ldg(reinterpret_cast<const float4*>(r));
  const float4 q1 = __ldg(reinterpret_cast<const float4*>(r + 4));
  const float4 q3 = __ldg(reinterpret_cast<const float4*>(r + 12));
  // q0 = pa.x pa.y pa.z pb.x; q1 = pb.y pb.z wa wb; q3.y = type
  const float pax = q0.x - ox, pay = q0.y - oy, paz = q0.z - oz;
  const float pbx = q0.w - ox, pby = q1.x - oy, pbz = q1.y - oz;
  const float ax = pax * f.t1x + pay * f.t1y + paz * f.t1z;
  const float ay = pax * f.t2x + pay * f.t2y + paz * f.t2z;
  const float az = pax * f.dnx + pay * f.dny + paz * f.dnz;
  const float bx = pbx * f.t1x + pby * f.t1y + pbz * f.t1z;
  const float by = pbx * f.t2x + pby * f.t2y + pbz * f.t2z;
  const float bz = pbx * f.dnx + pby * f.dny + pbz * f.dnz;
  const float ex = bx - ax;
  const float ey = by - ay;
  const float seg_len2 = max_nan(ex * ex + ey * ey, 1e-16f);
  const float w = min_nan(max_nan(-(ax * ex + ay * ey) / seg_len2, 0.0f),
                          1.0f);
  const float cx = ax + w * ex;
  const float cy = ay + w * ey;
  const float dist2 = cx * cx + cy * cy;
  const float hw = q1.z + (q1.w - q1.z) * w;
  const float hw2 = 0.25f * hw * hw;
  const bool inside = dist2 <= hw2;
  const float z_axis = az + w * (bz - az);
  const float edge = sqrtf(max_nan(hw2 - dist2, 0.0f));
  const float z_hit = q3.y == 1.0f ? z_axis - edge : z_axis;
  t = z_hit / max_nan(f.dlen, 1e-12f);
  return inside && t > kTMin && t < t_best;
}

__global__ void __launch_bounds__(kThreads)
curves_kernel(const float* __restrict__ nodes, const float* __restrict__ segs,
              const float* __restrict__ o, const float* __restrict__ d,
              const float* __restrict__ t_max, float* __restrict__ t_out,
              int* __restrict__ seg_out, int n, int any_hit) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
  const float ix = inv_dir(dx), iy = inv_dir(dy), iz = inv_dir(dz);
  const RayFrame f = ray_frame(dx, dy, dz);
  float t_best = t_max[i];
  int seg = -1;
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
        float t;
        if (segment_test(segs + kSegCols * (roff + k), ox, oy, oz, f, t_best,
                         t)) {
          t_best = t;
          seg = roff + k;
          if (any_hit) goto done;
        }
      }
    }
    if (sp == 0) break;
    cur = stack[--sp];
  }
done:
  t_out[i] = seg >= 0 ? t_best : INFINITY;
  seg_out[i] = seg;
}

}  // namespace

// nodes (Nn*8,), segs (S*16,) float32: the curve BVH and its segment rows
// in leaf order (ops/curves.py), both 16-byte aligned; o, d: (n, 3)
// float32; t_max, t: (n,) float32; seg: (n,) int32. Runs on the calling
// thread's current device, which the caller sets to the one the tensors
// live on. Returns cudaGetLastError() after the launch.
extern "C" int curves_intersect_launch(const float* nodes, const float* segs,
                                       const float* o, const float* d,
                                       const float* t_max, float* t, int* seg,
                                       int n, int any_hit, void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  curves_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      nodes, segs, o, d, t_max, t, seg, n, any_hit);
  return static_cast<int>(cudaGetLastError());
}
