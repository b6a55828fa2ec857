// 8-wide BVH closest/any-hit traversal for Hopper (sm_90a).
//
// Replaces the TPU kernel pbrt_tpu/ops/pallas_bvh8.py::_bvh8_kernel (body
// _traverse_page, entry bvh8_intersect via _run8), and with it
// chunked_intersect, which only exists to fit the TPU's scalar memory. There
// a 1,024-ray block walks the quantised tree from SMEM with one shared
// stack, pushing children by the block's majority direction sign.
//
// What bounds it on this card: not bytes (28 B in and 16 B out a ray; the
// tables of a scene of tens of thousands of triangles, about 1 MB, stay in
// the 50 MB L2) and not arithmetic (a visit is eight dequantised slab
// tests), but how busy a warp's lanes are while each walks a chain of
// dependent node fetches: the rays of a warp end after very different
// numbers of visits, and the bounce and shadow queries of a render wave
// carry dead lanes (t_max < 0, finished paths) that fail the root box at
// once and leave their lane idle for the rest of a one-thread-a-ray grid.
//
// Design:
// - Persistent warps that refill. The grid is as many 256-thread blocks as
//   the card holds at once (three an SM, at most 80 registers a thread).
//   Each block draws chunks of kChunk consecutive rays from a counter in
//   its own shared memory, chunk k of block b being chunk b + k * gridDim.x
//   of the launch, so that every block samples every part of the rays; when
//   at least kRefillIdle lanes of a warp are idle, they take the chunk's
//   next rays while the others walk on. A ray whose root box misses (a dead
//   lane) is written at once and its lane refilled. A ray's result depends
//   on its own inputs alone, so the order the rays run in changes no bit.
// - A node's 32 B frame and 96 B of child words are read as two float4 and
//   six int4 loads (nodes_f from float 8 and nodes_q 16 B-aligned, which
//   the wrapper checks).
// - The eight child slabs look for NaN once (slab.cuh, slab_entry), with
//   the answers of slab.
// - A lane tests its own hit leaves at its node, as the plain version does.
// Measured and dropped (PERF.md has the times): one counter for the whole
// grid (its same-address atomics cost ~8 us a launch of 160,000 rays, more
// than a sparse shadow query takes), the leaves of a warp tested side by
// side (while-while: 7% slower on 2^20 box rays, no faster on a wave), a
// 48 B triangle row read as three float4 (no faster), 128 x 8, 256 x 4 and
// 512 x 2 blocks, refill at 4, 16 and 32 idle lanes.
//
// Semantics are those of pbrt_tpu_torch/ops/bvh8.py (bvh8_intersect_plain),
// kept operation for operation: the root union box (nodes_f[0:6]) first; a
// visit dequantises the popped node's 8 child boxes as origin + q * scale
// and slab-tests them against the running t_best; leaf children in slot
// order, each leaf's triangles in order, with the strict-< triangle test of
// tri_intersect.cuh on 9-float rows (t > 1e-5); the interior children hit
// at entry pushed by the ray's own direction sign along the node's axis, so
// that the near side pops first. The plain version tests the leaves before
// it pushes; this kernel pushes first, which gives the same stack: the
// pushes read only the mask taken at entry, and leaf tests pop nothing. An
// any-hit query ends at the first accepted triangle. The library builds
// with -fmad=false, so every product and sum rounds as in the plain
// version.
#include <cuda_runtime.h>
#include <math.h>

#include <map>
#include <mutex>

#include "slab.cuh"
#include "tri_intersect.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 3;     // resident blocks an SM: 80 registers
constexpr int kRefillIdle = 8;    // idle lanes of a warp that refill
constexpr int kChunk = 32;        // consecutive rays a warp draws at once
constexpr int kStack = 96;
constexpr int kWidth = 8;
constexpr int kNodeF = 8;         // frame floats a node
constexpr int kNodeQ = kWidth * 3;
constexpr int kCntEmpty = 255;
constexpr float kTMin = 1e-5f;
constexpr unsigned kFull = 0xffffffffu;

using pbrt_tpu_torch::slab;
using pbrt_tpu_torch::slab_entry;

__device__ __forceinline__ float inv_dir(float d) {
  return 1.0f / (d == 0.0f ? 1e-20f : d);
}

// Triangle s against the ray: tri_intersect.cuh's test on its 9-float row
// [p0, e1, e2].
__device__ __forceinline__ bool tri_hit(const float* __restrict__ tris, int s,
                                        float ox, float oy, float oz,
                                        float dx, float dy, float dz,
                                        float t_best, float& t, float& b1,
                                        float& b2) {
  float r[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) r[k] = __ldg(tris + 9 * s + k);
  return pbrt_tpu_torch::tri_test(r, ox, oy, oz, dx, dy, dz, t_best, t, b1,
                                  b2, kTMin);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
bvh8_kernel(const float* __restrict__ nodes_f, const int* __restrict__ nodes_q,
            const float* __restrict__ tris,
            const int* __restrict__ prim_indices, const float* __restrict__ o,
            const float* __restrict__ d, const float* __restrict__ t_max,
            float* __restrict__ t_out, int* __restrict__ prim_out,
            float* __restrict__ b1_out, float* __restrict__ b2_out, int n,
            int any_hit) {
  // the block's count of the chunks it has drawn: chunk k of block b holds
  // rays (b + k * gridDim.x) * kChunk on
  __shared__ unsigned s_chunk;
  if (threadIdx.x == 0) s_chunk = 0u;
  __syncthreads();
  const unsigned n_chunks = (unsigned(n) + kChunk - 1u) / kChunk;
  // the root union box
  const float4 root_a = __ldg(reinterpret_cast<const float4*>(nodes_f));
  const float2 root_b = __ldg(reinterpret_cast<const float2*>(nodes_f + 4));
  const unsigned lane_lt = (1u << (threadIdx.x & 31u)) - 1u;
  unsigned chunk_next = 0u, chunk_end = 0u;   // the same on a warp's lanes
  bool exhausted = false;
  bool active = false;    // the lane holds a ray still under way
  int ray = 0, sp = 0, slot = -1;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  float ix = 0.0f, iy = 0.0f, iz = 0.0f, t_best = 0.0f, b1 = 0.0f, b2 = 0.0f;
  int stack[kStack];
  while (true) {
    // ---- refill: idle lanes take the next rays of the warp's chunk; a ray
    // that misses the root box is written at once and its lane refilled ----
    unsigned idle = __ballot_sync(kFull, !active);
    while (!exhausted &&
           (__popc(idle) >= kRefillIdle || idle == kFull)) {
      if (chunk_next == chunk_end) {
        unsigned base = unsigned(n);
        if ((threadIdx.x & 31u) == 0u) {
          const unsigned c = blockIdx.x + atomicAdd(&s_chunk, 1u) * gridDim.x;
          if (c < n_chunks) base = c * kChunk;
        }
        base = __shfl_sync(kFull, base, 0);
        chunk_next = base;
        chunk_end = base + kChunk < unsigned(n) ? base + kChunk : unsigned(n);
        if (chunk_next >= chunk_end) {
          exhausted = true;
          break;
        }
      }
      const unsigned avail = chunk_end - chunk_next;
      const unsigned rank = __popc(idle & lane_lt);
      if (!active && rank < avail) {
        ray = int(chunk_next + rank);
        ox = o[3 * ray], oy = o[3 * ray + 1], oz = o[3 * ray + 2];
        dx = d[3 * ray], dy = d[3 * ray + 1], dz = d[3 * ray + 2];
        ix = inv_dir(dx), iy = inv_dir(dy), iz = inv_dir(dz);
        t_best = t_max[ray];
        slot = -1;
        b1 = b2 = 0.0f;
        if (slab(root_a.x, root_a.y, root_a.z, root_a.w, root_b.x, root_b.y,
                 ox, oy, oz, ix, iy, iz, t_best)) {
          active = true;
          sp = 0;
          stack[sp++] = 0;
        } else {
          t_out[ray] = INFINITY;
          prim_out[ray] = -1;
          b1_out[ray] = 0.0f;
          b2_out[ray] = 0.0f;
        }
      }
      const unsigned n_idle = __popc(idle);
      chunk_next += n_idle < avail ? n_idle : avail;
      idle = __ballot_sync(kFull, !active);
    }
    if (idle == kFull) break;   // no ray left and none under way
    if (!active) continue;
    // ---- one node: its eight children's boxes, the interior ones hit
    // pushed, the leaves hit tested ----
    const int cur = stack[--sp];
    const float4* fr =
        reinterpret_cast<const float4*>(nodes_f + kNodeF * (cur + 1));
    const float4 f0 = __ldg(fr), f1 = __ldg(fr + 1);
    const int4* qv = reinterpret_cast<const int4*>(nodes_q + kNodeQ * cur);
    int w[kNodeQ];
#pragma unroll
    for (int k = 0; k < kNodeQ / 4; ++k) {
      const int4 v = __ldg(qv + k);
      w[4 * k] = v.x;
      w[4 * k + 1] = v.y;
      w[4 * k + 2] = v.z;
      w[4 * k + 3] = v.w;
    }
    const float onx = f0.x, ony = f0.y, onz = f0.z;
    const float sx = f0.w, sy = f1.x, sz = f1.y;
    const int axis = __float2int_rn(f1.z);
    const bool neg = (axis == 0 ? dx : (axis == 1 ? dy : dz)) < 0.0f;
    unsigned hit = 0u, leaf = 0u, inner = 0u;
#pragma unroll
    for (int c = 0; c < kWidth; ++c) {
      const int w0 = w[3 * c], w1 = w[3 * c + 1];
      const int cnt = (w0 >> 24) & 255;
      const float lox = onx + static_cast<float>(w0 & 255) * sx;
      const float loy = ony + static_cast<float>((w0 >> 8) & 255) * sy;
      const float loz = onz + static_cast<float>((w0 >> 16) & 255) * sz;
      const float hix = onx + static_cast<float>(w1 & 255) * sx;
      const float hiy = ony + static_cast<float>((w1 >> 8) & 255) * sy;
      const float hiz = onz + static_cast<float>((w1 >> 16) & 255) * sz;
      float tmin;
      if (slab_entry(lox, loy, loz, hix, hiy, hiz, ox, oy, oz, ix, iy, iz,
                     t_best, tmin)) {
        hit |= 1u << c;
      }
      if (cnt == 0) inner |= 1u << c;
      else if (cnt != kCntEmpty) leaf |= 1u << c;
    }
    // interior children hit at entry, the near side pushed last so that it
    // pops first
    const unsigned push = hit & inner;
    if (neg) {
#pragma unroll
      for (int c = 0; c < kWidth; ++c) {
        if ((push >> c) & 1u) stack[sp++] = w[3 * c + 2];
      }
    } else {
#pragma unroll
      for (int c = kWidth - 1; c >= 0; --c) {
        if ((push >> c) & 1u) stack[sp++] = w[3 * c + 2];
      }
    }
    // the leaves hit, in slot order, each leaf's triangles in order
    bool done = false;
    for (unsigned leaves = hit & leaf; leaves != 0u && !done;
         leaves &= leaves - 1u) {
      const int c = __ffs(leaves) - 1;
      const int s0 = w[3 * c + 2];
      const int s_end = s0 + ((w[3 * c] >> 24) & 255);
      for (int s = s0; s < s_end; ++s) {
        float t, u, v;
        if (tri_hit(tris, s, ox, oy, oz, dx, dy, dz, t_best, t, u, v)) {
          t_best = t;
          slot = s;
          b1 = u;
          b2 = v;
          if (any_hit) {
            done = true;
            break;
          }
        }
      }
    }
    if (done || sp == 0) {
      const bool found = slot >= 0;
      t_out[ray] = found ? t_best : INFINITY;
      prim_out[ray] = found ? __ldg(prim_indices + slot) : -1;
      b1_out[ray] = b1;
      b2_out[ray] = b2;
      active = false;
    }
  }
}

// The persistent grid: as many blocks as the card holds at once, and no
// more than have a chunk of rays to draw. The SM count and the blocks an SM
// are queried once a device.
cudaError_t grid_size(int n, int* blocks, int* blocks_per_sm) {
  static std::mutex mu;
  static std::map<int, std::pair<int, int>> resident;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  int per_sm = 0, sms = 0;
  {
    const std::lock_guard<std::mutex> lock(mu);
    const auto it = resident.find(device);
    if (it != resident.end()) {
      per_sm = it->second.first;
      sms = it->second.second;
    } else {
      if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                        device)) != cudaSuccess ||
          (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &per_sm, bvh8_kernel, kThreads, 0)) != cudaSuccess)
        return err;
      if (per_sm < 1) return cudaErrorInvalidConfiguration;
      resident[device] = {per_sm, sms};
    }
  }
  *blocks_per_sm = per_sm;
  const int chunks = (n + kChunk - 1) / kChunk;
  const int want = (chunks + kThreads / 32 - 1) / (kThreads / 32);
  *blocks = want < sms * per_sm ? want : sms * per_sm;
  return cudaSuccess;
}

}  // namespace

// The grid bvh8_intersect_launch uses for n rays on the calling thread's
// current device: blocks, blocks an SM, threads a block.
extern "C" int bvh8_grid(int n, int* blocks, int* blocks_per_sm,
                         int* threads) {
  *threads = kThreads;
  return static_cast<int>(grid_size(n, blocks, blocks_per_sm));
}

// nodes_f, nodes_q, tris, prim_indices: the BVH8 tables (ops/bvh8.py),
// nodes_f and nodes_q 16-byte aligned. o, d: (n, 3) float32; t_max, t, b1,
// b2: (n,) float32; prim: (n,) int32; n > 0. Runs on the calling thread's
// current device, which the caller sets to the one the tensors live on.
// Returns the first CUDA error, or cudaGetLastError() after the launch.
extern "C" int bvh8_intersect_launch(const float* nodes_f, const int* nodes_q,
                                     const float* tris,
                                     const int* prim_indices, const float* o,
                                     const float* d, const float* t_max,
                                     float* t, int* prim, float* b1,
                                     float* b2, int n, int any_hit,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int blocks = 0, per_sm = 0;
  cudaError_t err;
  if ((err = grid_size(n, &blocks, &per_sm)) != cudaSuccess)
    return static_cast<int>(err);
  bvh8_kernel<<<blocks, kThreads, 0, st>>>(
      nodes_f, nodes_q, tris, prim_indices, o, d, t_max, t, prim, b1, b2, n,
      any_hit);
  return static_cast<int>(cudaGetLastError());
}
