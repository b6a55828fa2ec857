// Brute-force ray-triangle intersection for Hopper (sm_90a).
//
// Replaces the TPU kernel pbrt_tpu/ops/pallas_intersect.py::_tri_kernel
// (body _tri_block_math, entry brute_force_intersect), which takes a pool
// of any size.
//
// What bounds it on this card: operations. Per ray it reads 28 B (o, d,
// t_max) and writes 16 B, against some 60 flops per triangle that
// -fmad=false keeps as separate multiplies and adds; at the cornell box's
// 32 triangles that is ~2,000 flops per 44 B and at 4,096 triangles
// 250,000: the arithmetic units, and below a few hundred triangles the launch
// itself.
//
// Design: one thread per ray, 256-thread blocks. The pool streams through
// shared memory in tiles of at most kTileRows rows, two buffers: thread 0
// starts the bulk copy (bulk_copy.cuh) of tile k + 1 on its own mbarrier
// before the block scans tile k, so a pool of any size fits and only the
// first tile's copy is exposed. A small pool is one tile and one copy. The
// rows stay whole (64 B, of which the test reads 36): the bulk copy moves
// contiguous multiples of 16 B at no thread's cost, a 36 B row
// would save no global traffic (both of its 32 B sectors are read either
// way), and a warp reads one row at a time as a broadcast of two 16 B
// loads and one 4 B load, so the unused bytes cost shared-memory room only
// (32 KB a block at most). Tiles run in ascending pool order and hold whole
// groups of four, so the closest hit keeps the lower index on equal t and
// an any-hit ray stops after the first group that holds a hit, as in the
// plain version. A ray that is done still meets its block at the tile
// barriers; the block leaves early when every ray is done. Within a tile
// the four tests of a group run side by side (tri_intersect.cuh, scan_rows,
// which also proves that the bits are the serial scan's).
#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"
#include "tri_intersect.cuh"

namespace {

constexpr int kThreads = 256;
// rows a tile (a multiple of kHitGroup): 16 KB a buffer, 32 KB a block, so
// seven blocks still share an SM
constexpr int kTileRows = 256;
static_assert(kTileRows % pbrt_tpu_torch::kHitGroup == 0, "whole groups");

using pbrt_tpu_torch::bulk_start;
using pbrt_tpu_torch::kTriFloats;
using pbrt_tpu_torch::mbar_init;
using pbrt_tpu_torch::mbar_wait;

__global__ void __launch_bounds__(kThreads)
tri_intersect_kernel(const float* __restrict__ tri,
                     const float* __restrict__ o, const float* __restrict__ d,
                     const float* __restrict__ t_max, float* __restrict__ t_out,
                     int* __restrict__ prim_out, float* __restrict__ b1_out,
                     float* __restrict__ b2_out, int n, int n_tris,
                     int n_real, int tile_rows, int any_hit) {
  extern __shared__ __align__(128) float s_tile[];   // two tile buffers
  __shared__ __align__(8) uint64_t bar[2];
  mbar_init(bar, 2);
  const int n_tiles = (n_tris + tile_rows - 1) / tile_rows;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  pbrt_tpu_torch::Hit h{0.0f, -1, 0.0f, 0.0f};
  if (live) {
    ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
    dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
    h.t = t_max[i];
  }
  // rows of tile k; the copy of tile k into buffer k & 1
  auto rows_of = [&](int k) {
    const int left = n_tris - k * tile_rows;
    return left < tile_rows ? left : tile_rows;
  };
  auto start = [&](int k) {
    bulk_start(s_tile + (k & 1) * tile_rows * kTriFloats,
               tri + size_t(k) * tile_rows * kTriFloats,
               uint32_t(rows_of(k)) * kTriFloats * sizeof(float),
               bar + (k & 1));
  };
  if (threadIdx.x == 0 && n_tiles > 0) start(0);
  bool done = !live;
  for (int k = 0; k < n_tiles; ++k) {
    const bool more = k + 1 < n_tiles;
    // buffer (k + 1) & 1 held tile k - 1, whose reads ended at the barrier
    // that closed the last trip
    if (more && threadIdx.x == 0) start(k + 1);
    mbar_wait(bar + (k & 1), (k >> 1) & 1);
    if (!done) {
      done = pbrt_tpu_torch::scan_rows(
          s_tile + (k & 1) * tile_rows * kTriFloats, rows_of(k),
          k * tile_rows, n_real, ox, oy, oz, dx, dy, dz, any_hit != 0, h);
    }
    if (__syncthreads_and(done)) {
      // no block exits with a copy into its shared memory in flight
      if (more) mbar_wait(bar + ((k + 1) & 1), ((k + 1) >> 1) & 1);
      break;
    }
  }
  if (!live) return;
  t_out[i] = h.t;
  prim_out[i] = h.prim;
  b1_out[i] = h.b1;
  b2_out[i] = h.b2;
}

}  // namespace

// tri: (n_tris, 16) float32 rows, n_tris a multiple of 4, 16-byte aligned;
// o, d: (n, 3) float32; t_max, t, b1, b2: (n,) float32; prim: (n,) int32.
// Runs on the calling thread's current device, which the caller sets to the
// one the tensors live on. Returns cudaGetLastError() after the launch.
extern "C" int tri_intersect_launch(const float* tri, const float* o,
                                    const float* d, const float* t_max,
                                    float* t, int* prim, float* b1, float* b2,
                                    int n, int n_tris, int n_real,
                                    int any_hit, void* stream) {
  // (an empty pool: no tile, every ray a miss)
  const int tile_rows =
      n_tris < kTileRows ? (n_tris > 0 ? n_tris : 1) : kTileRows;
  const size_t smem = 2 * sizeof(float) * tile_rows * kTriFloats;
  const int blocks = (n + kThreads - 1) / kThreads;
  tri_intersect_kernel<<<blocks, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      tri, o, d, t_max, t, prim, b1, b2, n, n_tris, n_real, tile_rows,
      any_hit);
  return static_cast<int>(cudaGetLastError());
}
