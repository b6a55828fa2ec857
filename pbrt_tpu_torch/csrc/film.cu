// The film's readout on Hopper (sm_90a): the image of film.get_image,
// computed on the card so that only the finished (H, W, 3) float32 image
// crosses PCIe, and not the whole (H*W, 8) accumulator.
//
// It replaces no TPU kernel: the reference reads the film out in NumPy on
// the host (pbrt_tpu/film.py get_image), and so did the port. Semantics and
// operation order follow the plain version, ops/film_readout.py
// film_readout_plain, pixel for pixel: a thread a pixel reads the row's
// first float4 (rgb_sum, weight_sum), divides by max(weight_sum, 1e-12) in
// float32 (NaN passes as np.maximum passes it), takes the sensor product
// xyz = S rgb in float32 and the colour space's product M xyz in float64,
// each row written out as (m0 * x + m1 * y) + m2 * z, and rounds the result
// to float32. The second product stays in float64 as NumPy's readout had
// it (M is a float64 matrix): a float32 product would be another image.
//
// What bounds it on this card: bytes. It reads 16 B of each 32 B row of the
// accumulator, which costs the whole 32 B sector, and writes 12 B a pixel:
// at 1080p 66.4 MB read and 24.9 MB written. The reads are 16 B a thread on
// a 32 B stride, the writes three floats a thread, neighbouring threads on
// neighbouring pixels; the nine float64 products a pixel hide behind them.
// Built with -fmad=false so each product and sum rounds on its own as
// PyTorch's separate ops do.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;

struct Sensor {
  float s[9];    // xyz_from_sensor_rgb, row-major
};

struct ColourSpace {
  double m[9];   // rgb_from_xyz, row-major
};

__global__ void __launch_bounds__(kThreads)
film_readout_kernel(const float4* __restrict__ accum, float* __restrict__ out,
                    int n_pix, Sensor sensor, ColourSpace space) {
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= n_pix) return;
  const float4 a = accum[2 * pix];
  const float lo = static_cast<float>(1e-12);
  const float w = a.w < lo ? lo : a.w;
  const float rgb[3] = {a.x / w, a.y / w, a.z / w};
  double xyz[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    xyz[c] = static_cast<double>((sensor.s[3 * c] * rgb[0] +
                                  sensor.s[3 * c + 1] * rgb[1]) +
                                 sensor.s[3 * c + 2] * rgb[2]);
  }
  float* o = out + 3 * static_cast<size_t>(pix);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    o[c] = static_cast<float>((space.m[3 * c] * xyz[0] +
                               space.m[3 * c + 1] * xyz[1]) +
                              space.m[3 * c + 2] * xyz[2]);
  }
}

}  // namespace

// The image of the film's accumulator: accum (n_pix, 8) float32, 16-byte
// aligned; out (n_pix, 3) float32; s: the sensor's xyz_from_sensor_rgb and
// m: the colour space's rgb_from_xyz, each 3x3 row-major. Runs on the
// calling thread's current device. Returns cudaGetLastError() after the
// launch.
extern "C" int film_readout_launch(const float* accum, float* out, int n_pix,
                                   const float* s, const double* m,
                                   void* stream) {
  if (n_pix == 0) return 0;
  Sensor sensor;
  ColourSpace space;
  for (int i = 0; i < 9; ++i) {
    sensor.s[i] = s[i];
    space.m[i] = m[i];
  }
  film_readout_kernel<<<(n_pix + kThreads - 1) / kThreads, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(accum), out, n_pix, sensor, space);
  return static_cast<int>(cudaGetLastError());
}
