// The megakernel's front end and film on Hopper (sm_90a): two kernels, one
// on each side of megawave.cu's kernel, for a render whose waves all go
// through the whole-path megakernel with in-kernel camera rays.
//
// They replace no TPU kernel: the reference runs this front end as XLA
// tensor ops around its Pallas megakernel, and so did the port (some 400
// PyTorch launches a wave). Semantics and operation order follow the plain
// versions in pbrt_tpu_torch/ops/megafront.py, lane for lane:
// - mega_lanes_kernel, a thread a lane: the pixel lane % n_pix and the
//   sample index s + lane / n_pix; the morton|spp index
//   (samplers.morton_index); the ZSobol draw of dimension 5
//   (samplers.sample_1d, zsobol.cuh); its four wavelengths
//   (utils/spectrum.sample_visible_wavelengths); the light spectrum at them
//   (lights.eval_light_spectrum on the spectra_pool row every light
//   shares). It writes the megakernel's inputs mi, lam and le.
// - mega_film_kernel, a thread a pixel: the pdf of each of the m lanes'
//   wavelengths again (visible_wavelengths_pdf), the projection of L onto
//   the analytic CIE curves (film.sensor_to_sensor_rgb), non-finite values
//   zeroed and the film row [rgb * w, w, lum, lum^2, 1, 0]
//   (film.add_samples), the m rows summed in sample order and added to the
//   (H*W, 8) accumulator in place: no atomics, no two threads on a pixel.
//
// What bounds them on this card: bytes. The lanes kernel writes 36 B a
// lane (and reads one 1.9 KB spectrum row, cached); the film kernel reads
// 36 B a lane and reads and writes 32 B a pixel. Each is one pass with
// coalesced 16 B accesses; their arithmetic (an atanh, a cosh and six exps
// a wavelength) hides behind the memory traffic.
//
// The expressions keep the plain versions' PyTorch operation order, with
// PyTorch's own rewrites on the card: a / scalar is a * (1 / scalar),
// scalar / t is (1 / t) * scalar (Tensor.__rtruediv__), t ** 2 is t * t, a
// mean of four is ((x0 + x2) + (x1 + x3)) * 0.25 (the reduction's four
// threads combined by shuffles, the farther pair first; measured on the
// card against torch 2.11). Decimal constants are Python floats cast
// to float32 (static_cast<float> of the double). Built with -fmad=false so
// each product and sum rounds on its own as PyTorch's separate ops do.
#include <cuda_runtime.h>
#include <stdint.h>

#include "zsobol.cuh"

namespace {

using pbrt_tpu_torch::ZSobol;

constexpr int kThreads = 256;
constexpr int kLambdaDim = 5;        // the sampler dimension of the draw
constexpr int kNCie = 471;           // 1 nm samples over [360, 830]
constexpr float kLambdaMin = 360.0f;
constexpr float kLambdaMax = 830.0f;

__device__ __forceinline__ uint32_t left_shift_2(uint32_t x) {
  x &= 0xFFFFu;
  x = (x ^ (x << 8)) & 0x00FF00FFu;
  x = (x ^ (x << 4)) & 0x0F0F0F0Fu;
  x = (x ^ (x << 2)) & 0x33333333u;
  return (x ^ (x << 1)) & 0x55555555u;
}

__device__ __forceinline__ bool visible(float lam) {
  return lam >= kLambdaMin && lam <= kLambdaMax;
}

// visible_wavelengths_pdf
__device__ __forceinline__ float wavelength_pdf(float lam) {
  const float x = static_cast<float>(0.0072) * (lam - 538.0f);
  const float c = coshf(x);
  const float pdf = (1.0f / (c * c)) * static_cast<float>(0.0039398042);
  return visible(lam) ? pdf : 0.0f;
}

// _asym_gauss
__device__ __forceinline__ float asym_gauss(float x, float mu, double t1,
                                            double t2) {
  const float t = (x - mu) * (x < mu ? static_cast<float>(t1)
                                     : static_cast<float>(t2));
  return expf((-0.5f * t) * t);
}

__device__ __forceinline__ float cie_x(float l) {
  const float v = static_cast<float>(0.362) * asym_gauss(l, 442.0f, 0.0624,
                                                         0.0374) +
                  static_cast<float>(1.056) * asym_gauss(l, 599.8f, 0.0264,
                                                         0.0323) -
                  static_cast<float>(0.065) * asym_gauss(l, 501.1f, 0.0490,
                                                         0.0382);
  return visible(l) ? v : 0.0f;
}

__device__ __forceinline__ float cie_y(float l) {
  const float v = static_cast<float>(0.821) * asym_gauss(l, 568.8f, 0.0213,
                                                         0.0247) +
                  static_cast<float>(0.286) * asym_gauss(l, 530.9f, 0.0613,
                                                         0.0322);
  return visible(l) ? v : 0.0f;
}

__device__ __forceinline__ float cie_z(float l) {
  const float v = static_cast<float>(1.217) * asym_gauss(l, 437.0f, 0.0845,
                                                         0.0278) +
                  static_cast<float>(0.681) * asym_gauss(l, 459.0f, 0.0385,
                                                         0.0725);
  return visible(l) ? v : 0.0f;
}

// torch.mean over four values on the card
__device__ __forceinline__ float mean4(const float* v) {
  return ((v[0] + v[2]) + (v[1] + v[3])) * 0.25f;
}

__global__ void __launch_bounds__(kThreads)
mega_lanes_kernel(int s, const uint32_t* __restrict__ seeds,
                  const float* __restrict__ spec, uint32_t* __restrict__ mi_out,
                  float4* __restrict__ lam_out, float4* __restrict__ le_out,
                  int n, int n_pix, int width, int log2_spp, int B) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const uint32_t pix = static_cast<uint32_t>(lane % n_pix);
  const uint32_t si = static_cast<uint32_t>(s + lane / n_pix);
  const uint32_t px = pix % static_cast<uint32_t>(width);
  const uint32_t py = pix / static_cast<uint32_t>(width);
  const uint32_t morton = (left_shift_2(py) << 1) | left_shift_2(px);
  const uint32_t mi = (morton << log2_spp) | si;
  const ZSobol zs{32 - B, seeds, nullptr};
  const float u = zs.d1(mi, kLambdaDim);
  float lam[4], le[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float up = u + 0.25f * static_cast<float>(i);
    up = up > 1.0f ? up - 1.0f : up;
    lam[i] = 538.0f - static_cast<float>(138.888889) *
                          atanhf(static_cast<float>(0.85691062) -
                                 static_cast<float>(1.82750197) * up);
    // eval_light_spectrum: linear interpolation of the 1 nm row
    const float x = fminf(fmaxf(lam[i] - kLambdaMin, 0.0f),
                          static_cast<float>(kNCie - 1.000001));
    const int i0 = min(max(static_cast<int>(floorf(x)), 0), kNCie - 2);
    const float frac = x - static_cast<float>(i0);
    le[i] = spec[i0] * (1.0f - frac) + spec[i0 + 1] * frac;
  }
  mi_out[lane] = mi;
  lam_out[lane] = make_float4(lam[0], lam[1], lam[2], lam[3]);
  le_out[lane] = make_float4(le[0], le[1], le[2], le[3]);
}

__global__ void __launch_bounds__(kThreads)
mega_film_kernel(const float4* __restrict__ L_in,
                 const float* __restrict__ fw_in,
                 const float4* __restrict__ lam_in, float4* __restrict__ accum,
                 int n_pix, int m, float imaging_ratio) {
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= n_pix) return;
  const float inv_cie_y = 1.0f / static_cast<float>(106.856895);
  float sum[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) sum[k] = 0.0f;
  for (int j = 0; j < m; ++j) {
    const int lane = j * n_pix + pix;
    const float4 L4 = L_in[lane];
    const float4 lam4 = lam_in[lane];
    const float L[4] = {L4.x, L4.y, L4.z, L4.w};
    const float lam[4] = {lam4.x, lam4.y, lam4.z, lam4.w};
    float px[4], py[4], pz[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      // safe_div_spectrum(L, pdf) / CIE_Y_INTEGRAL
      const float pdf = wavelength_pdf(lam[c]);
      const float w = (pdf != 0.0f ? L[c] / pdf : 0.0f) * inv_cie_y;
      px[c] = cie_x(lam[c]) * w;
      py[c] = cie_y(lam[c]) * w;
      pz[c] = cie_z(lam[c]) * w;
    }
    float rgb[3] = {imaging_ratio * mean4(px), imaging_ratio * mean4(py),
                    imaging_ratio * mean4(pz)};
#pragma unroll
    for (int c = 0; c < 3; ++c) rgb[c] = isfinite(rgb[c]) ? rgb[c] : 0.0f;
    const float lum = (static_cast<float>(0.2126) * rgb[0] +
                       static_cast<float>(0.7152) * rgb[1]) +
                      static_cast<float>(0.0722) * rgb[2];
    const float w = fw_in[lane];
    const float row[8] = {rgb[0] * w, rgb[1] * w, rgb[2] * w, w, lum,
                          lum * lum, 1.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < 8; ++k) sum[k] = sum[k] + row[k];
  }
  float4* out = accum + 2 * pix;
  const float4 a = out[0], b = out[1];
  out[0] = make_float4(a.x + sum[0], a.y + sum[1], a.z + sum[2], a.w + sum[3]);
  out[1] = make_float4(b.x + sum[4], b.y + sum[5], b.z + sum[6], b.w + sum[7]);
}

}  // namespace

// The lanes of the wave whose first sample index is s: n lanes over n_pix
// pixels of a film `width` wide, m = n / n_pix sample indices a pixel.
// seeds: ops/megawave's per-dimension scramble seeds (n_dims*3,) uint32;
// spec: the light's 471-entry spectrum row, float32; out: mi (n,) uint32,
// lam and le (n, 4) float32, 16-byte aligned. Runs on the calling thread's
// current device. Returns cudaGetLastError() after the launch.
extern "C" int mega_lanes_launch(int s, const uint32_t* seeds,
                                 const float* spec, uint32_t* mi, float* lam,
                                 float* le, int n, int n_pix, int width,
                                 int log2_spp, int B, void* stream) {
  if (n == 0) return 0;
  mega_lanes_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      s, seeds, spec, mi, reinterpret_cast<float4*>(lam),
      reinterpret_cast<float4*>(le), n, n_pix, width, log2_spp, B);
  return static_cast<int>(cudaGetLastError());
}

// Adds the wave's n_pix * m lanes into the film: L, lam (n, 4) and fw (n,)
// float32 from the megakernel and the lanes kernel, lane j * n_pix + p
// holding pixel p's j-th sample; accum (n_pix, 8) float32, 16-byte
// aligned, updated in place. Returns cudaGetLastError() after the launch.
extern "C" int mega_film_launch(const float* L, const float* fw,
                                const float* lam, float* accum, int n_pix,
                                int m, float imaging_ratio, void* stream) {
  if (n_pix == 0) return 0;
  mega_film_kernel<<<(n_pix + kThreads - 1) / kThreads, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(L), fw,
      reinterpret_cast<const float4*>(lam), reinterpret_cast<float4*>(accum),
      n_pix, m, imaging_ratio);
  return static_cast<int>(cudaGetLastError());
}
