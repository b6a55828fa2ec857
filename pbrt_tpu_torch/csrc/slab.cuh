// Ray/box slab test shared by the BVH traversal kernels (bvh8.cu, bvh2.cu).
//
// The reference's test, operation for operation: t = (plane - o) * inv_d
// per axis, the entry t clamped below at 0, the exit t above at the ray's
// running t_best, accepted when tmin <= tmax * 1.0000004. Min and max
// propagate NaN like torch.minimum / torch.maximum (fminf/fmaxf would drop
// it), so the kernels agree with their plain PyTorch versions bit for bit.
#pragma once

#include <math.h>

namespace pbrt_tpu_torch {

// torch.minimum / torch.maximum: NaN if either operand is NaN
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? a + b : fminf(a, b);
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}

__device__ __forceinline__ bool slab(float lox, float loy, float loz,
                                     float hix, float hiy, float hiz,
                                     float ox, float oy, float oz, float ix,
                                     float iy, float iz, float t_best) {
  const float tx0 = (lox - ox) * ix;
  const float tx1 = (hix - ox) * ix;
  const float ty0 = (loy - oy) * iy;
  const float ty1 = (hiy - oy) * iy;
  const float tz0 = (loz - oz) * iz;
  const float tz1 = (hiz - oz) * iz;
  const float tmin = max_nan(max_nan(min_nan(tx0, tx1), min_nan(ty0, ty1)),
                             max_nan(min_nan(tz0, tz1), 0.0f));
  const float tmax = min_nan(min_nan(max_nan(tx0, tx1), max_nan(ty0, ty1)),
                             min_nan(max_nan(tz0, tz1), t_best));
  return tmin <= tmax * 1.0000004f;
}

}  // namespace pbrt_tpu_torch
