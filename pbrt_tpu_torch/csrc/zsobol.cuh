// The ZSobol sampler (fast index shuffle) shared by the path-tracing
// megakernel (megawave.cu) and the front end's lanes kernel
// (megafront.cu), so both draw the same bits as
// pbrt_tpu_torch/samplers.py.
//
// The Sobol' products without their 32-step loop: dimension 0's generator
// matrix is the bit reversal (column i is 1 << (31 - i)), so its product is
// __brev; dimension 1's is four lookups in 256-entry byte tables (the
// wrapper's ops/megawave.sobol_table). Both are the same integers as the
// matrix products.
#pragma once

#include <stdint.h>

namespace pbrt_tpu_torch {

__device__ __forceinline__ uint32_t fast_owen(uint32_t v, uint32_t seed) {
  v = __brev(v);
  v ^= v * 0x3D20ADEAu;
  v += seed;
  v *= (seed >> 16) | 1u;
  v ^= v * 0x05526C56u;
  v ^= v * 0x53A22864u;
  return __brev(v);
}

// u32 -> [0, 1): __uint2float_rn(v) * 2^-32 is the round-to-nearest
// conversion the reference builds from two exact int32 parts (a Mosaic
// workaround, megawave.py _u32_to_f); bit-identical
__device__ __forceinline__ float u32_to_f(uint32_t v) {
  return fminf(__uint2float_rn(v) * 0x1p-32f, 0x1.fffffep-1f);
}

struct ZSobol {
  int shift;                    // 32 - the index's meaningful bits
  const uint32_t* seeds;        // (n_dims, 3) per-dimension scramble seeds
  const uint32_t* sobol;        // the Sobol' table (d2 only)

  __device__ __forceinline__ uint32_t index(uint32_t mi, int dim) const {
    return fast_owen(mi << shift, seeds[3 * dim]) >> shift;
  }
  // dimension 0's product: its columns are 1 << (31 - i)
  __device__ __forceinline__ uint32_t product0(uint32_t idx) const {
    return __brev(idx);
  }
  // dimension 1's: the xor of one entry of each byte table
  __device__ __forceinline__ uint32_t product1(uint32_t idx) const {
    return sobol[idx & 255u] ^ sobol[256 + ((idx >> 8) & 255u)] ^
           sobol[512 + ((idx >> 16) & 255u)] ^ sobol[768 + (idx >> 24)];
  }
  __device__ __forceinline__ float d1(uint32_t mi, int dim) const {
    return u32_to_f(fast_owen(product0(index(mi, dim)), seeds[3 * dim + 1]));
  }
  __device__ __forceinline__ void d2(uint32_t mi, int dim, float& a,
                                     float& b) const {
    const uint32_t idx = index(mi, dim);
    a = u32_to_f(fast_owen(product0(idx), seeds[3 * dim + 1]));
    b = u32_to_f(fast_owen(product1(idx), seeds[3 * dim + 2]));
  }
};

}  // namespace pbrt_tpu_torch
