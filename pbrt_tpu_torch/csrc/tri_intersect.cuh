// Ray-triangle test and the brute-force closest/any-hit loop shared by the
// standalone intersection kernel (tri_intersect.cu) and the path-tracing
// megakernel (megawave.cu), so both make the same hit decisions.
//
// Semantics of pbrt_tpu/ops/pallas_intersect.py::_tri_block_math:
// Moeller-Trumbore on rows [p0, e1, e2, pad] (16 floats per triangle, edges
// precomputed), relative barycentric tolerance 1e-6 * |det|, t > 1e-6,
// t below the running bound, padding rows masked by index (n_real).
// The BVH8 kernel (bvh8.cu) runs the same test on its 9-float rows
// [p0, e1, e2] with its own lower t bound (1e-5).
// Closest hit keeps the lower index on equal t. Any hit scans groups of
// four triangles (the reference kernel's unroll) and stops after the first
// group that holds a hit. The expressions keep the operation order of
// pbrt_tpu_torch/ops/tri_intersect.py; the library builds with
// -fmad=false, so each product and sum rounds on its own as in PyTorch.
#pragma once

namespace pbrt_tpu_torch {

constexpr int kTriFloats = 16;
constexpr int kHitGroup = 4;

struct Hit {
  float t;    // hit distance, t_max on a miss
  int prim;   // pool index, -1 on a miss
  float b1;
  float b2;
};

__device__ __forceinline__ bool tri_test(const float* __restrict__ r,
                                         float ox, float oy, float oz,
                                         float dx, float dy, float dz,
                                         float t_bound, float& t, float& b1,
                                         float& b2, float t_min = 1e-6f) {
  const float p0x = r[0], p0y = r[1], p0z = r[2];
  const float e1x = r[3], e1y = r[4], e1z = r[5];
  const float e2x = r[6], e2y = r[7], e2z = r[8];
  const float pvx = dy * e2z - dz * e2y;
  const float pvy = dz * e2x - dx * e2z;
  const float pvz = dx * e2y - dy * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  const float sgn = det < 0.0f ? -1.0f : 1.0f;
  const float det_a = det * sgn;
  const float tx = ox - p0x;
  const float ty = oy - p0y;
  const float tz = oz - p0z;
  const float u_n = (tx * pvx + ty * pvy + tz * pvz) * sgn;
  const float qvx = ty * e1z - tz * e1y;
  const float qvy = tz * e1x - tx * e1z;
  const float qvz = tx * e1y - ty * e1x;
  const float v_n = (dx * qvx + dy * qvy + dz * qvz) * sgn;
  const float t_n = (e2x * qvx + e2y * qvy + e2z * qvz) * sgn;
  const float tol = 1e-6f * det_a;
  const float inv_det = 1.0f / (det_a == 0.0f ? 1.0f : det_a);
  t = t_n * inv_det;
  b1 = u_n * inv_det;
  b2 = v_n * inv_det;
  return det_a > 1e-12f && u_n >= -tol && v_n >= -tol &&
         u_n + v_n <= det_a + tol && t > t_min && t < t_bound;
}

// tri: the pool (n_tris rows, n_tris a multiple of kHitGroup), normally in
// shared memory: every thread of a warp reads the same row at once.
__device__ __forceinline__ Hit intersect_pool(const float* __restrict__ tri,
                                              int n_tris, int n_real,
                                              float ox, float oy, float oz,
                                              float dx, float dy, float dz,
                                              float t_max, bool any_hit) {
  Hit h{t_max, -1, 0.0f, 0.0f};
  for (int g = 0; g < n_tris; g += kHitGroup) {
    for (int k = g; k < g + kHitGroup && k < n_real; ++k) {
      float t, b1, b2;
      if (tri_test(tri + k * kTriFloats, ox, oy, oz, dx, dy, dz, h.t, t, b1,
                   b2)) {
        h = Hit{t, k, b1, b2};
      }
    }
    if (any_hit && h.prim >= 0) break;
  }
  return h;
}

}  // namespace pbrt_tpu_torch
