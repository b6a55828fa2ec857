// One ray's traversal of a quantised 8-wide BVH, shared by the whole-tree
// kernel (bvh8.cu, the tree in global memory) and the binned page kernel
// (bvh8_binned.cu, a page staged in shared memory).
//
// Semantics of pbrt_tpu_torch/ops/bvh8.py (walk with quantised_nodes),
// operation for operation: the root union box (nodes_f[0:6]) first; a
// visit dequantises the popped node's 8 child boxes as origin + q * scale
// and slab-tests them against the running t_best (slab.cuh); leaf children
// in slot order, each leaf's triangles in order, with the strict-<
// triangle test of tri_intersect.cuh on 9-float rows (t > 1e-5); then the
// interior children hit at entry, pushed by the ray's own direction sign
// along the node's axis so the near side pops first. An any-hit query
// returns at the first accepted triangle. The sources build with
// -fmad=false, so every product and sum rounds as in the plain version.
#pragma once

#include "slab.cuh"
#include "tri_intersect.cuh"

namespace pbrt_tpu_torch {

constexpr int kBvh8Stack = 96;
constexpr int kBvh8Width = 8;
constexpr int kBvh8NodeF = 8;                 // frame floats per node
constexpr int kBvh8NodeQ = kBvh8Width * 3;    // child words per node
constexpr int kBvh8CntEmpty = 255;
constexpr float kBvh8TMin = 1e-5f;

// Where a page lives: the read-only cache path for global memory, plain
// loads for shared memory.
struct GlobalPage {
  template <class T>
  __device__ __forceinline__ static T ld(const T* p) { return __ldg(p); }
};
struct SharedPage {
  template <class T>
  __device__ __forceinline__ static T ld(const T* p) { return *p; }
};

// Traverses the tree (nodes_f, nodes_q, tris) for the ray o, d with
// inverse direction i. On entry t_best is the ray's bound, slot the hit
// carried so far (-1: none) and b1, b2 its barycentrics; a better hit
// overwrites all four (slot: the triangle's row in this tree). stack holds
// kBvh8Stack entries.
template <class Page>
__device__ __forceinline__ void bvh8_walk(
    const float* __restrict__ nodes_f, const int* __restrict__ nodes_q,
    const float* __restrict__ tris, float ox, float oy, float oz, float dx,
    float dy, float dz, float ix, float iy, float iz, bool any_hit,
    int* stack, float& t_best, int& slot, float& b1, float& b2) {
  int sp = 0;
  if (slab(Page::ld(nodes_f), Page::ld(nodes_f + 1), Page::ld(nodes_f + 2),
           Page::ld(nodes_f + 3), Page::ld(nodes_f + 4), Page::ld(nodes_f + 5),
           ox, oy, oz, ix, iy, iz, t_best)) {
    stack[sp++] = 0;
  }
  while (sp > 0) {
    const int cur = stack[--sp];
    const float* fr = nodes_f + 8 + cur * kBvh8NodeF;
    const float onx = Page::ld(fr), ony = Page::ld(fr + 1);
    const float onz = Page::ld(fr + 2);
    const float sx = Page::ld(fr + 3), sy = Page::ld(fr + 4);
    const float sz = Page::ld(fr + 5);
    const int axis = __float2int_rn(Page::ld(fr + 6));
    const bool neg = (axis == 0 ? dx : (axis == 1 ? dy : dz)) < 0.0f;
    const int* q = nodes_q + cur * kBvh8NodeQ;
    int w0[kBvh8Width], first[kBvh8Width];
    unsigned hit = 0u;   // bit c: child c's box is hit at entry
#pragma unroll
    for (int c = 0; c < kBvh8Width; ++c) {
      w0[c] = Page::ld(q + 3 * c);
      const int w1 = Page::ld(q + 3 * c + 1);
      first[c] = Page::ld(q + 3 * c + 2);
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
    for (int c = 0; c < kBvh8Width; ++c) {
      const int cnt = (w0[c] >> 24) & 255;
      if (!((hit >> c) & 1u) || cnt == 0 || cnt == kBvh8CntEmpty) continue;
      for (int k = 0; k < cnt; ++k) {
        const int s = first[c] + k;
        float t, u, v;
        if (tri_test(tris + 9 * s, ox, oy, oz, dx, dy, dz, t_best, t, u, v,
                     kBvh8TMin)) {
          t_best = t;
          slot = s;
          b1 = u;
          b2 = v;
          if (any_hit) return;
        }
      }
    }
    // interior children, the near side pushed last so it pops first
    if (neg) {
#pragma unroll
      for (int c = 0; c < kBvh8Width; ++c) {
        if (((hit >> c) & 1u) && ((w0[c] >> 24) & 255) == 0) {
          stack[sp++] = first[c];
        }
      }
    } else {
#pragma unroll
      for (int c = kBvh8Width - 1; c >= 0; --c) {
        if (((hit >> c) & 1u) && ((w0[c] >> 24) & 255) == 0) {
          stack[sp++] = first[c];
        }
      }
    }
  }
}

}  // namespace pbrt_tpu_torch
