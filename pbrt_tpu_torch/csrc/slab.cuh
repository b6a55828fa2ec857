// Ray/box slab test shared by the BVH traversal kernels (bvh8.cu, bvh2.cu,
// curves.cu).
//
// The reference's test, operation for operation: t = (plane - o) * inv_d
// per axis, the entry t clamped below at 0, the exit t above at the ray's
// running t_best, accepted when tmin <= tmax * 1.0000004. Min and max
// propagate NaN like torch.minimum / torch.maximum (fminf/fmaxf alone would
// drop it), so the kernels agree with their plain PyTorch versions bit for
// bit.
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

// The test of slab() below, with the entry distance tmin it found (which
// does not depend on t_best); the curve kernel's. torch.minimum and
// torch.maximum propagate NaN, so a NaN among the six products or in t_best
// makes tmin or tmax NaN and the test false; where there is none, they are
// fminf and fmaxf. So NaN is looked for once, here, and not inside each of
// the twelve min and max (min_nan, max_nan): the same answers, and the same
// tmin wherever the test passes, at a third of the cost.
__device__ __forceinline__ bool slab_entry(float lox, float loy, float loz,
                                           float hix, float hiy, float hiz,
                                           float ox, float oy, float oz,
                                           float ix, float iy, float iz,
                                           float t_best, float& tmin) {
  const float tx0 = (lox - ox) * ix;
  const float tx1 = (hix - ox) * ix;
  const float ty0 = (loy - oy) * iy;
  const float ty1 = (hiy - oy) * iy;
  const float tz0 = (loz - oz) * iz;
  const float tz1 = (hiz - oz) * iz;
  const bool any_nan = (tx0 != tx0) | (tx1 != tx1) | (ty0 != ty0) |
                       (ty1 != ty1) | (tz0 != tz0) | (tz1 != tz1) |
                       (t_best != t_best);
  tmin = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
               fmaxf(fminf(tz0, tz1), 0.0f));
  const float tmax = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                           fminf(fmaxf(tz0, tz1), t_best));
  return !any_nan & (tmin <= tmax * 1.0000004f);
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

// A box that passed slab_entry under an earlier, larger t_best, tested
// again under the present one: tmax is the smaller of the box's own exit
// distance and t_best, scaling by 1.0000004 is monotone, and tmin stayed
// under the scaled exit distance, so what is left of the test is this.
__device__ __forceinline__ bool slab_again(float tmin, float t_best) {
  return tmin <= t_best * 1.0000004f;
}

}  // namespace pbrt_tpu_torch
