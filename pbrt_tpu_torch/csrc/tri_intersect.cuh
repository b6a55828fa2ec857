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
// group that holds a hit. A pool of any size is scanned a tile of rows at a
// time (scan_rows): tiles in ascending pool order keep both rules. The expressions keep the operation order of
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

// One pool row from shared memory: the nine floats the test reads, as two
// 16 B loads and one 4 B load (a row starts on a 64 B boundary, and a warp
// reads one row at a time, which shared memory broadcasts).
struct TriRow {
  float4 a;   // p0.x p0.y p0.z e1.x
  float4 b;   // e1.y e1.z e2.x e2.y
  float c;    // e2.z
};

__device__ __forceinline__ TriRow load_row(const float* __restrict__ r) {
  return TriRow{*reinterpret_cast<const float4*>(r),
                *reinterpret_cast<const float4*>(r + 4), r[8]};
}

__device__ __forceinline__ bool tri_test(const TriRow& q, float ox, float oy,
                                         float oz, float dx, float dy,
                                         float dz, float t_bound, float& t,
                                         float& b1, float& b2) {
  const float r[9] = {q.a.x, q.a.y, q.a.z, q.a.w, q.b.x,
                      q.b.y, q.b.z, q.b.w, q.c};
  return tri_test(r, ox, oy, oz, dx, dy, dz, t_bound, t, b1, b2);
}

// Scans `rows` rows (a multiple of kHitGroup) at `tile`, which hold the
// pool rows base .. base + rows - 1, and folds them into h. Returns true
// when an any-hit ray has its hit and need look no further.
//
// The four rows of a group are tested side by side, each against the bound
// the group started with, and the winner is then taken in row order with
// the strict `t < h.t` of the serial scan. This gives the serial scan's
// bits: a row's t, b1 and b2 do not depend on the bound, which enters only
// the last comparison of its test, and that comparison is monotone in the
// bound. A row the serial scan accepts has t below the running bound, which
// is at most the group's, so it passes here too and is accepted by the same
// `t < h.t`; a row that passes here but not the running bound fails that
// `t < h.t` and is dropped, as the serial scan drops it. The four tests no
// longer wait on one another's h.t.
__device__ __forceinline__ bool scan_rows(const float* __restrict__ tile,
                                          int rows, int base, int n_real,
                                          float ox, float oy, float oz,
                                          float dx, float dy, float dz,
                                          bool any_hit, Hit& h) {
  for (int g = 0; g < rows; g += kHitGroup) {
    float t[kHitGroup], b1[kHitGroup], b2[kHitGroup];
    bool ok[kHitGroup];
    const float bound = h.t;
#pragma unroll
    for (int k = 0; k < kHitGroup; ++k) {
      ok[k] = tri_test(load_row(tile + (g + k) * kTriFloats), ox, oy, oz, dx,
                       dy, dz, bound, t[k], b1[k], b2[k]) &&
              base + g + k < n_real;
    }
#pragma unroll
    for (int k = 0; k < kHitGroup; ++k) {
      if (ok[k] && t[k] < h.t) h = Hit{t[k], base + g + k, b1[k], b2[k]};
    }
    if (any_hit && h.prim >= 0) return true;
  }
  return false;
}

// tri: the whole pool (n_tris rows, n_tris a multiple of kHitGroup) in
// shared memory, 16-byte aligned.
__device__ __forceinline__ Hit intersect_pool(const float* __restrict__ tri,
                                              int n_tris, int n_real,
                                              float ox, float oy, float oz,
                                              float dx, float dy, float dz,
                                              float t_max, bool any_hit) {
  Hit h{t_max, -1, 0.0f, 0.0f};
  scan_rows(tri, n_tris, 0, n_real, ox, oy, oz, dx, dy, dz, any_hit, h);
  return h;
}

}  // namespace pbrt_tpu_torch
