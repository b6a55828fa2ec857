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
// What bounds it on this card: not bytes (28 B in and 8 B out a ray, the
// tables once) and not arithmetic, but how a warp walks: a binary tree over
// a fur patch (the hair scene: 524,288 segments, 24 levels, 19 MB of nodes
// and 32 MB of segment rows, together over the 50 MB L2) is a chain of
// dependent fetches at 32 different addresses a warp, the rays of a warp
// end after very different numbers of steps, and at any moment only a few
// of them hold a leaf, whose segment test is the longest piece of code.
//
// Design:
// - Child boxes in the parent. The kernel walks a table derived from the
//   reference-layout rows at upload (ops/curves.py::wide_nodes): one 64 B
//   row an interior node, [left box, right box, left ref, right ref, axis,
//   0], read as four 16 B loads, the rows in the reference's depth-first
//   order, so an interior left child is the next row (half the time in its
//   parent's 128 B line). A ref >= 0 is an interior row; a ref < 0 is a
//   leaf, ~ref = first segment << 3 | segments. One fetch tests both
//   children; a child that misses costs no fetch and no stack entry.
//   Leaves own no row. (A warp makes as many 16 B requests a box as
//   before, so this step alone gained nothing; the next ones build on it.)
// - Persistent warps that refill. The grid is as many blocks as the card
//   holds at once. A warp draws chunks of kChunk consecutive rays from a
//   global counter; when at least kRefillIdle of its lanes have finished,
//   those lanes take the chunk's next rays while the others walk on (a
//   ray's result depends on its own inputs alone, so the order rays run in
//   changes no bit).
// - Two loops in one (Aila and Laine's while-while): a lane walks interior
//   rows until it holds a leaf, then waits for the others, so that the warp
//   tests its leaves side by side; a loop that takes a node or a leaf a
//   pass runs the long segment test for the one or two lanes that happen
//   to hold a leaf in that pass. The waiting ends when fewer than
//   kMinWalkers lanes still walk.
// - The stack, in local memory, holds (ref, entry distance) of far
//   children that were hit; a popped entry is tested again against the
//   present t_best without a fetch (slab.cuh, slab_again).
// - Both slab tests of a step look for NaN once (slab.cuh, slab_entry)
//   instead of inside every min and max.
// - The ray's frame for the segment test is computed once a ray and kept
//   in registers.
// Measured and dropped (PERF.md has the times): the rows in breadth-first order
// with the top 1,024 or 2,048 of them staged in shared memory (slower: it
// takes the room of L1 and of resident blocks), the stack in shared
// memory, the frame in shared memory or computed again at every leaf, and
// more resident blocks at fewer registers (they spill).
//
// Semantics are those of pbrt_tpu_torch/ops/curves.py
// (curves_intersect_plain, the plain version), whose walk visits a node,
// tests its box against the running t_best, and on an interior hit pushes
// the far child and descends into the near one (near by the sign of the
// ray's own direction along the node axis). This walk gives the same bits:
// - the near child is tested at its parent with the t_best it would be
//   visited with (nothing runs between the two);
// - the far child is tested at its parent with a t_best that can only
//   shrink before its turn comes, and the slab test is monotone in t_best,
//   so a far child that fails at the parent fails at its turn too, and one
//   that passes is pushed and tested again when popped: with the present
//   t_best, as the plain version tests it;
// - so the same leaves are entered in the same order with the same t_best,
//   and their segments are tested in order with the strict t < t_best;
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

// Threads a block: eight warps, each drawing and refilling on its own.
constexpr int kThreads = 256;
// Resident blocks an SM the compiler leaves registers for: 4 x 256 threads
// at up to 64 registers; more blocks at fewer registers spill.
constexpr int kMinBlocks = 4;
// A warp refills once this many of its lanes are idle (or all 32 are): a
// refill stalls the whole warp, so it waits until it serves a quarter of it.
constexpr int kRefillIdle = 8;
// The lanes that hold a leaf wait for the others while at least this many
// still walk; with fewer, they test their leaves at once.
constexpr int kMinWalkers = 8;
constexpr int kStack = 64;
constexpr int kSegCols = 16;
constexpr int kWideQuads = 4;   // 16 B quarters of a 64 B wide row
constexpr int kChunk = 32;      // consecutive rays a warp draws at once
constexpr float kTMin = 1e-4f;

using pbrt_tpu_torch::max_nan;
using pbrt_tpu_torch::min_nan;
using pbrt_tpu_torch::slab;
using pbrt_tpu_torch::slab_again;
using pbrt_tpu_torch::slab_entry;

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

__global__ void __launch_bounds__(kThreads, kMinBlocks)
curves_kernel(const float* __restrict__ nodes, const float4* __restrict__ wide,
              const float* __restrict__ segs, const float* __restrict__ o,
              const float* __restrict__ d, const float* __restrict__ t_max,
              float* __restrict__ t_out, int* __restrict__ seg_out,
              unsigned* __restrict__ next_ray, int n, int any_hit) {
  RayFrame f;
  // the root: its box, and its ref (interior row 0, or a leaf)
  const float4 root_a = __ldg(reinterpret_cast<const float4*>(nodes));
  const float4 root_b = __ldg(reinterpret_cast<const float4*>(nodes) + 1);
  const int root_roff = __float2int_rn(root_b.z);
  const int root_nprim = __float2int_rn(root_b.w) >> 2;
  const int root_ref =
      root_nprim == 0 ? 0 : ~(root_roff << 3 | (root_nprim < 4 ? root_nprim : 4));

  const unsigned lane = threadIdx.x & 31u;
  unsigned chunk_next = 0u, chunk_end = 0u;   // the same on a warp's lanes
  bool exhausted = false;
  bool active = false;
  int ray = 0, cur = 0, sp = 0, seg = -1;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  float ix = 0.0f, iy = 0.0f, iz = 0.0f, t_best = 0.0f;
  int stack_ref[kStack];
  float stack_tmin[kStack];
  // the next stack entry whose box the ray still reaches, into next;
  // false when the stack runs out
  auto pop = [&](int& next) {
    while (sp > 0) {
      --sp;
      if (slab_again(stack_tmin[sp], t_best)) {
        next = stack_ref[sp];
        return true;
      }
    }
    return false;
  };
  bool started = false;   // the lane holds a ray whose result is not written
  while (true) {
    // ---- refill: finished lanes take the next rays of the warp's chunk ----
    const unsigned idle = __ballot_sync(0xffffffffu, !active);
    const int n_idle = __popc(idle);
    if (!exhausted && (n_idle >= kRefillIdle || n_idle == 32)) {
      if (chunk_next == chunk_end) {
        unsigned base = 0u;
        if (lane == 0u) base = atomicAdd(next_ray, unsigned(kChunk));
        base = __shfl_sync(0xffffffffu, base, 0);
        chunk_next = base < unsigned(n) ? base : unsigned(n);
        chunk_end = base + kChunk < unsigned(n) ? base + kChunk : unsigned(n);
        exhausted = chunk_next == chunk_end;
      }
      const unsigned rank = __popc(idle & ((1u << lane) - 1u));
      const unsigned avail = chunk_end - chunk_next;
      if (!active && rank < avail) {
        ray = int(chunk_next + rank);
        ox = o[3 * ray], oy = o[3 * ray + 1], oz = o[3 * ray + 2];
        dx = d[3 * ray], dy = d[3 * ray + 1], dz = d[3 * ray + 2];
        ix = inv_dir(dx), iy = inv_dir(dy), iz = inv_dir(dz);
        t_best = t_max[ray];
        seg = -1;
        sp = 0;
        cur = root_ref;
        if (slab(root_a.x, root_a.y, root_a.z, root_a.w, root_b.x, root_b.y,
                 ox, oy, oz, ix, iy, iz, t_best)) {
          active = started = true;
          f = ray_frame(dx, dy, dz);
        } else {
          t_out[ray] = INFINITY;
          seg_out[ray] = -1;
        }
      }
      chunk_next += unsigned(n_idle) < avail ? unsigned(n_idle) : avail;
    } else if (n_idle == 32) {
      break;   // no ray left and none under way
    }
    // ---- walk: interior rows until this lane holds a leaf or has
    // finished; the lanes that hold one wait, so that the warp tests its
    // leaves side by side and not one lane at a time ----
    while (active && cur >= 0) {
      const float4* row = wide + size_t(kWideQuads) * cur;
      const float4 q0 = __ldg(row), q1 = __ldg(row + 1), q2 = __ldg(row + 2),
                   q3 = __ldg(row + 3);
      // q0 = loL.xyz hiL.x; q1 = hiL.yz loR.xy; q2 = loR.z hiR.xyz;
      // q3 = left ref, right ref, axis, 0 (int bits)
      float t_l, t_r;
      const bool hit_l = slab_entry(q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, ox, oy,
                                    oz, ix, iy, iz, t_best, t_l);
      const bool hit_r = slab_entry(q1.z, q1.w, q2.x, q2.y, q2.z, q2.w, ox, oy,
                                    oz, ix, iy, iz, t_best, t_r);
      const int axis = __float_as_int(q3.z);
      const bool neg = (axis == 0 ? dx : (axis == 1 ? dy : dz)) < 0.0f;
      const int ref_l = __float_as_int(q3.x), ref_r = __float_as_int(q3.y);
      const bool hit_near = neg ? hit_r : hit_l;
      const bool hit_far = neg ? hit_l : hit_r;
      if (hit_near) {
        if (hit_far) {
          stack_ref[sp] = neg ? ref_l : ref_r;
          stack_tmin[sp++] = neg ? t_l : t_r;
        }
        cur = neg ? ref_r : ref_l;
      } else if (hit_far) {
        cur = neg ? ref_l : ref_r;
      } else {
        active = pop(cur);
      }
      // when only a few lanes still walk, the waiting ones go first (a
      // heuristic: the lanes that run together here, no more)
      if (__popc(__activemask()) < kMinWalkers) break;
    }
    // ---- leaves ----
    if (active && cur < 0) {
      const int code = ~cur;
      const int roff = code >> 3;
      const int m = code & 7;
      bool found = false;
      for (int k = 0; k < m; ++k) {
        float t;
        if (segment_test(segs + size_t(kSegCols) * (roff + k), ox, oy, oz, f,
                         t_best, t)) {
          t_best = t;
          seg = roff + k;
          found = true;
          if (any_hit) break;
        }
      }
      active = !(any_hit && found) && pop(cur);
    }
    if (started && !active) {
      t_out[ray] = seg >= 0 ? t_best : INFINITY;
      seg_out[ray] = seg;
      started = false;
    }
  }
}

}  // namespace

// nodes (Nn*8,) float32: the curve BVH in the reference layout (row 0, the
// root, is read); wide (n_wide*16,) int32: its kernel layout
// (ops/curves.py::wide_nodes); segs (S*16,) float32: the segment rows in
// leaf order; all 16-byte aligned. o, d: (n, 3) float32; t_max, t: (n,)
// float32; seg: (n,) int32; next_ray: one uint32 of scratch, zeroed here on
// the stream. The tree is at most 64 deep (the stack's entries). Runs on
// the calling thread's current device, which the caller sets to the one
// the tensors live on. Returns the first CUDA error, or cudaGetLastError()
// after the launch.
extern "C" int curves_intersect_launch(const float* nodes, const int* wide,
                                       const float* segs, const float* o,
                                       const float* d, const float* t_max,
                                       float* t, int* seg, unsigned* next_ray,
                                       int n, int any_hit, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, curves_kernel, kThreads, 0)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  // persistent blocks: as many as run at once, and no more than have a
  // chunk to draw
  const int chunks = (n + kChunk - 1) / kChunk;
  const int want = (chunks + kThreads / 32 - 1) / (kThreads / 32);
  const int blocks = want < sms * per_sm ? want : sms * per_sm;
  if ((err = cudaMemsetAsync(next_ray, 0, sizeof(unsigned), st)) !=
      cudaSuccess) {
    return static_cast<int>(err);
  }
  curves_kernel<<<blocks, kThreads, 0, st>>>(
      nodes, reinterpret_cast<const float4*>(wide), segs, o, d, t_max, t, seg,
      next_ray, n, any_hit);
  return static_cast<int>(cudaGetLastError());
}
