// The BxDFs on Hopper (sm_90a): bxdfs.bsdf_f, bsdf_pdf and bsdf_sample for
// the diffuse lobe, the conductor and the dielectric (smooth, and rough
// through the Trowbridge-Reitz functions), a thread a lane, in two kernels:
// - bxdf_eval_kernel: f (N, 4) and pdf (N,) of (wo, wi);
// - bxdf_sample_kernel: wi, f, pdf (clamped at 0), valid, specular,
//   transmission, eta_scale and dispersed of (wo, uc, u2).
//
// It replaces no TPU kernel: the reference's BxDFs are XLA tensor code, and
// so is the port's plain version (pbrt_tpu_torch/bxdfs.py), which runs
// every present tag's whole lobe over all lanes: some 3,200 PyTorch
// launches a depth on killeroo, each a few microseconds of host time. Here
// each lane computes only its own tag's lobe, and within the dielectric's
// sample only the branch it takes (smooth or rough; reflection or
// refraction).
//
// Semantics and operation order follow the plain version lane for lane,
// dead lanes included, so that the kernel's bits are PyTorch's on the
// card:
// - each sum and product in the plain code's order: vm.dot is
//   (a0 b0 + a1 b1) + a2 b2, normalize divides by max(sqrt(dot), 1e-20),
//   reflect is -wo + (2 dot) n; the products with n = (0, 0, 1) and with
//   the unit axes of tr_sample_wm are computed, not folded away (they set
//   the sign of zeros and pass NaNs);
// - PyTorch's rewrites on the card: a / scalar is a * (1 / scalar), which
//   for the halves here is exact; scalar / t is (1 / t) * scalar
//   (Tensor.__rtruediv__); Python constants are float32 (PI / 4.0 is
//   float32(pi) / 4, exact);
// - PyTorch's NaN rules: clamp, clamp_min, maximum and amax propagate NaN
//   (fminf and fmaxf alone would not), sign(0) = sign(NaN) = 0, safe_div
//   gives 0 where the divisor is 0, tr_d and tr_lambda give 0 where tan2
//   is not finite;
// - the tag select of bxdfs._select: with one present tag every lane takes
//   that lobe whatever its own tag; with several, a lane of no present tag
//   gets zeros and false.
// sqrtf, sinf and cosf are the CUDA math library's, as PyTorch's own
// elementwise kernels call them; divisions are IEEE (no fast math).
// Built with -fmad=false so each product and sum rounds on its own as
// PyTorch's separate ops do.
//
// What bounds it on this card: bytes. eval reads 84 B a lane (tag,
// albedo, alpha_x, alpha_y, eta, k, wo, wi) and writes 20 B (f, pdf);
// sample reads 84 B (uc and u2 for wi) and writes 40 B: at 160,000 lanes
// 16.6 MB and 19.8 MB, ~5 and ~6 us at 3.35 TB/s. The (N, 4) rows move as
// one 16 B access a thread, the (N, 3) rows as three neighbouring floats,
// so a warp's accesses are contiguous; a lane loads only what its lobe
// reads. A lane's arithmetic (a few hundred float operations, a handful of
// square roots and divisions) hides behind those loads; a warp whose lanes
// hold different tags runs the lobes one after another, still
// microseconds. The gain is the launches that disappear, not the device
// time.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDiffuse = 0;      // bxdfs.BXDF_DIFFUSE, the reference's tags
constexpr int kConductor = 1;
constexpr int kDielectric = 2;
constexpr float kPi = 3.14159274101257324f;        // float32(pi)
constexpr float kPiOver4 = 0.785398185253143311f;  // float32(pi) / 4
constexpr float kPiOver2 = 1.57079637050628662f;   // float32(pi) / 2
constexpr float kInvPi = 0.318309873342514038f;    // float32(1 / pi)

struct V3 {
  float x, y, z;
};

// PyTorch's NaN rules

__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float maximum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

__device__ __forceinline__ float minimum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

__device__ __forceinline__ float sign(float a) {
  return static_cast<float>((0.0f < a) - (a < 0.0f));
}

__device__ __forceinline__ float safe_div(float a, float b) {
  return b != 0.0f ? a / b : 0.0f;
}

__device__ __forceinline__ float safe_sqrt(float x) {
  return sqrtf(clamp_min(x, 0.0f));
}

__device__ __forceinline__ float sqr(float x) { return x * x; }

__device__ __forceinline__ float rcp(float x) { return 1.0f / x; }

// utils/vecmath

__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}

__device__ __forceinline__ V3 neg(V3 a) { return {-a.x, -a.y, -a.z}; }

__device__ __forceinline__ V3 normalize(V3 v) {
  const float l = clamp_min(sqrtf(dot(v, v)), 1e-20f);
  return {v.x / l, v.y / l, v.z / l};
}

__device__ __forceinline__ V3 reflect(V3 wo, V3 n) {
  const float d2 = 2.0f * dot(wo, n);
  return {-wo.x + d2 * n.x, -wo.y + d2 * n.y, -wo.z + d2 * n.z};
}

// refract: valid (no total internal reflection), wt and the eta used; wi
// away from the surface, n to the side of wi (flipped with eta when wi is
// below it)
__device__ __forceinline__ bool refract(V3 wi, V3 n, float eta, V3* wt,
                                        float* eta_used) {
  float cos_i = dot(n, wi);
  const bool flip = cos_i < 0.0f;
  eta = flip ? rcp(eta) : eta;
  *eta_used = eta;
  cos_i = fabsf(cos_i);
  if (flip) n = neg(n);
  const float sin2_i = clamp_min(1.0f - cos_i * cos_i, 0.0f);
  const float sin2_t = sin2_i / (eta * eta);
  const float cos_t = sqrtf(clamp_min(1.0f - sin2_t, 0.0f));
  const float c = cos_i / eta - cos_t;
  *wt = {-wi.x / eta + c * n.x, -wi.y / eta + c * n.y,
         -wi.z / eta + c * n.z};
  return sin2_t < 1.0f;
}

__device__ __forceinline__ float sin2_theta(V3 w) {
  return clamp_min(1.0f - w.z * w.z, 0.0f);
}

__device__ __forceinline__ float tan2_theta(V3 w) {
  return sin2_theta(w) / (w.z * w.z);
}

__device__ __forceinline__ float cos_phi(V3 w) {
  const float s = sqrtf(sin2_theta(w));
  return s == 0.0f ? 1.0f : clamp(w.x / clamp_min(s, 1e-20f), -1.0f, 1.0f);
}

__device__ __forceinline__ float sin_phi(V3 w) {
  const float s = sqrtf(sin2_theta(w));
  return s == 0.0f ? 0.0f : clamp(w.y / clamp_min(s, 1e-20f), -1.0f, 1.0f);
}

// Fresnel

__device__ float fr_dielectric(float cos_theta_i, float eta) {
  float c = clamp(cos_theta_i, -1.0f, 1.0f);
  eta = c < 0.0f ? rcp(eta) : eta;
  c = fabsf(c);
  const float sin2_i = 1.0f - sqr(c);
  const float sin2_t = sin2_i / sqr(eta);
  const float cos_t = safe_sqrt(1.0f - sin2_t);
  const float r_parl = safe_div(eta * c - cos_t, eta * c + cos_t);
  const float r_perp = safe_div(c - eta * cos_t, c + eta * cos_t);
  const float F = 0.5f * (sqr(r_parl) + sqr(r_perp));
  return sin2_t >= 1.0f ? 1.0f : F;
}

__device__ __forceinline__ void cdiv(float ar, float ai, float br, float bi,
                                     float* re, float* im) {
  const float den = clamp_min(sqr(br) + sqr(bi), 1e-30f);
  *re = (ar * br + ai * bi) / den;
  *im = (ai * br - ar * bi) / den;
}

// one wavelength of fr_complex; c = clamp(|cos_theta_i|, 0, 1)
__device__ float fr_complex1(float c, float eta, float k) {
  const float cos2 = sqr(c);
  const float sin2 = 1.0f - cos2;
  const float e2r = sqr(eta) - sqr(k);
  const float e2i = 2.0f * eta * k;
  const float wr = e2r - sin2;
  const float wi = e2i;
  const float mag = sqrtf(clamp_min(sqr(wr) + sqr(wi), 1e-30f));
  const float sr = sqrtf(clamp_min((mag + wr) * 0.5f, 0.0f));
  const float si = sign(wi) * sqrtf(clamp_min((mag - wr) * 0.5f, 0.0f));
  float rp_r, rp_i, rl_r, rl_i;
  cdiv(c - sr, -si, c + sr, si, &rp_r, &rp_i);
  const float r_perp = sqr(rp_r) + sqr(rp_i);
  cdiv(e2r * c - sr, e2i * c - si, e2r * c + sr, e2i * c + si, &rl_r,
       &rl_i);
  const float r_parl = sqr(rl_r) + sqr(rl_i);
  return 0.5f * (r_perp + r_parl);
}

__device__ __forceinline__ float4 fr_complex(float cos_theta_i, float4 eta,
                                             float4 k) {
  const float c = clamp(fabsf(cos_theta_i), 0.0f, 1.0f);
  return {fr_complex1(c, eta.x, k.x), fr_complex1(c, eta.y, k.y),
          fr_complex1(c, eta.z, k.z), fr_complex1(c, eta.w, k.w)};
}

// Trowbridge-Reitz

__device__ float tr_d(V3 wm, float ax, float ay) {
  const float tan2 = tan2_theta(wm);
  const float cos4 = sqr(wm.z * wm.z);
  const float e = (sqr(cos_phi(wm) / ax) + sqr(sin_phi(wm) / ay)) * tan2;
  const float d = safe_div(1.0f, kPi * ax * ay * cos4 * sqr(1.0f + e));
  return isfinite(tan2) ? d : 0.0f;
}

__device__ float tr_lambda(V3 w, float ax, float ay) {
  const float tan2 = tan2_theta(w);
  const float alpha2 = sqr(cos_phi(w) * ax) + sqr(sin_phi(w) * ay);
  const float lam = (safe_sqrt(1.0f + alpha2 * tan2) - 1.0f) * 0.5f;
  return isfinite(tan2) ? lam : 0.0f;
}

__device__ __forceinline__ float tr_g1(V3 w, float ax, float ay) {
  return rcp(1.0f + tr_lambda(w, ax, ay));
}

__device__ __forceinline__ float tr_g(V3 wo, V3 wi, float ax, float ay) {
  return rcp(1.0f + tr_lambda(wo, ax, ay) + tr_lambda(wi, ax, ay));
}

__device__ __forceinline__ float tr_d_visible(V3 w, V3 wm, float ax,
                                              float ay) {
  return safe_div(tr_g1(w, ax, ay) * fabsf(dot(w, wm)) * tr_d(wm, ax, ay),
                  fabsf(w.z));
}

__device__ __forceinline__ bool effectively_smooth(float ax, float ay) {
  return maximum(ax, ay) < 1e-3f;
}

__device__ __forceinline__ void disk_concentric(float u0, float u1, float* x,
                                                float* y) {
  const float ox = 2.0f * u0 - 1.0f;
  const float oy = 2.0f * u1 - 1.0f;
  const bool zero = ox == 0.0f && oy == 0.0f;
  const bool cond = fabsf(ox) > fabsf(oy);
  float r = cond ? ox : oy;
  const float theta = cond ? kPiOver4 * safe_div(oy, ox)
                           : kPiOver2 - kPiOver4 * safe_div(ox, oy);
  r = zero ? 0.0f : r;
  *x = r * cosf(theta);
  *y = r * sinf(theta);
}

// a visible normal (Heitz 2018)
__device__ V3 tr_sample_wm(V3 w, float u0, float u1, float ax, float ay) {
  V3 wh = normalize({ax * w.x, ay * w.y, w.z});
  if (wh.z < 0.0f) wh = neg(wh);
  V3 t1 = {1.0f, 0.0f, 0.0f};
  if (wh.z < 0.999f) t1 = normalize(cross({0.0f, 0.0f, 1.0f}, wh));
  const V3 t2 = cross(wh, t1);
  float p0, p1;
  disk_concentric(u0, u1, &p0, &p1);
  const float h = safe_sqrt(1.0f - sqr(p0));
  const float t = (1.0f + wh.z) * 0.5f;
  const float py = (1.0f - t) * h + t * p1;
  const float pz = safe_sqrt(1.0f - sqr(p0) - sqr(py));
  const V3 nh = {p0 * t1.x + py * t2.x + pz * wh.x,
                 p0 * t1.y + py * t2.y + pz * wh.y,
                 p0 * t1.z + py * t2.z + pz * wh.z};
  return normalize({ax * nh.x, ay * nh.y, clamp_min(nh.z, 1e-6f)});
}

// The lobes' f and pdf (bxdfs._diffuse_f_pdf, _conductor_f_pdf,
// _dielectric_f_pdf)

struct Lane {
  float4 albedo, eta, k;
  float ax, ay;
};

__device__ void diffuse_f_pdf(const Lane& p, V3 wo, V3 wi, float4* f,
                              float* pdf) {
  const bool same = wo.z * wi.z > 0.0f;
  *f = same ? make_float4(p.albedo.x * kInvPi, p.albedo.y * kInvPi,
                          p.albedo.z * kInvPi, p.albedo.w * kInvPi)
            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  *pdf = same ? fabsf(wi.z) * kInvPi : 0.0f;
}

// the rough conductor; the smooth one is specular (sample only)
__device__ void conductor_f_pdf(const Lane& p, V3 wo, V3 wi, float4* f,
                                float* pdf) {
  *f = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  *pdf = 0.0f;
  const bool same = wo.z * wi.z > 0.0f;
  const float cos_o = fabsf(wo.z);
  const float cos_i = fabsf(wi.z);
  V3 wm = {wo.x + wi.x, wo.y + wi.y, wo.z + wi.z};
  const bool wm_ok = dot(wm, wm) > 1e-12f;
  if (!(same && wm_ok && !effectively_smooth(p.ax, p.ay) && cos_o > 0.0f &&
        cos_i > 0.0f)) {
    return;
  }
  wm = normalize(wm);
  const float4 F = fr_complex(fabsf(dot(wo, wm)), p.eta, p.k);
  const float d = tr_d(wm, p.ax, p.ay);
  const float g = tr_g(wo, wi, p.ax, p.ay);
  const float s = safe_div(d * g, 4.0f * cos_o * cos_i);
  *f = make_float4(s * F.x, s * F.y, s * F.z, s * F.w);
  *pdf = tr_d_visible(wo, wm, p.ax, p.ay) /
         (4.0f * clamp_min(fabsf(dot(wo, wm)), 1e-8f));
}

// the rough dielectric's reflection and transmission at the hero
// wavelength's eta (radiance mode); the smooth one is specular
__device__ void dielectric_f_pdf(const Lane& p, V3 wo, V3 wi, float4* f,
                                 float* pdf) {
  *f = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  *pdf = 0.0f;
  const float eta_s = p.eta.x;
  const float cos_o = wo.z;
  const float cos_i = wi.z;
  const bool reflectv = cos_i * cos_o > 0.0f;
  const float etap =
      reflectv ? 1.0f : (cos_o > 0.0f ? eta_s : rcp(eta_s));
  V3 wm = {wi.x * etap + wo.x, wi.y * etap + wo.y, wi.z * etap + wo.z};
  const bool wm_ok = dot(wm, wm) > 1e-12f;
  wm = normalize(wm);
  if (wm.z < 0.0f) wm = neg(wm);
  const bool backface =
      dot(wm, wi) * cos_i < 0.0f || dot(wm, wo) * cos_o < 0.0f;
  if (!(wm_ok && !effectively_smooth(p.ax, p.ay) && !backface &&
        cos_o != 0.0f && cos_i != 0.0f)) {
    return;
  }
  const float F = fr_dielectric(dot(wo, wm), eta_s);
  const float d = tr_d(wm, p.ax, p.ay);
  const float g = tr_g(wo, wi, p.ax, p.ay);
  const float pdf_wm = tr_d_visible(wo, wm, p.ax, p.ay);
  const float pr = F;
  const float pt = 1.0f - F;
  float fs, pd;
  if (reflectv) {
    fs = safe_div(d * g * F, fabsf(4.0f * cos_o * cos_i));
    const float dwm_dwi_r =
        rcp(4.0f * clamp_min(fabsf(dot(wo, wm)), 1e-8f));
    pd = pdf_wm * dwm_dwi_r * safe_div(pr, pr + pt);
  } else {
    const float denom = sqr(dot(wi, wm) + dot(wo, wm) / etap);
    fs = safe_div(d * (1.0f - F) * g * fabsf(dot(wi, wm) * dot(wo, wm)),
                  fabsf(cos_i * cos_o) * denom);
    fs = fs / sqr(etap);
    const float dwm_dwi_t = safe_div(fabsf(dot(wi, wm)), denom);
    pd = pdf_wm * dwm_dwi_t * safe_div(pt, pr + pt);
  }
  *f = make_float4(fs, fs, fs, fs);
  *pdf = pd;
}

// The lobe a lane takes: with one present tag (single >= 0) that tag's;
// else its own tag's if present, else none (-1)
__device__ __forceinline__ int lobe_of(int tag, unsigned present,
                                       int single) {
  if (single >= 0) return single;
  return (tag >= 0 && tag < 32 && ((present >> tag) & 1u)) ? tag : -1;
}

__device__ __forceinline__ V3 load3(const float* a, int i) {
  return {a[3 * i], a[3 * i + 1], a[3 * i + 2]};
}

__device__ __forceinline__ Lane load_lane(
    int i, int lobe, const float4* __restrict__ albedo,
    const float* __restrict__ alpha_x, const float* __restrict__ alpha_y,
    const float4* __restrict__ eta, const float4* __restrict__ k) {
  Lane p;
  const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  p.albedo = lobe == kDiffuse ? albedo[i] : z;
  const bool spec = lobe == kConductor || lobe == kDielectric;
  p.ax = spec ? alpha_x[i] : 0.0f;
  p.ay = spec ? alpha_y[i] : 0.0f;
  p.eta = spec ? eta[i] : z;
  p.k = lobe == kConductor ? k[i] : z;
  return p;
}

__global__ void __launch_bounds__(kThreads)
bxdf_eval_kernel(const int* __restrict__ tag,
                 const float4* __restrict__ albedo,
                 const float* __restrict__ alpha_x,
                 const float* __restrict__ alpha_y,
                 const float4* __restrict__ eta, const float4* __restrict__ k,
                 const float* __restrict__ wo_, const float* __restrict__ wi_,
                 float4* __restrict__ f_out, float* __restrict__ pdf_out,
                 int n, unsigned present, int single) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int lobe = lobe_of(tag[i], present, single);
  const Lane p = load_lane(i, lobe, albedo, alpha_x, alpha_y, eta, k);
  const V3 wo = load3(wo_, i);
  const V3 wi = load3(wi_, i);
  float4 f = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float pdf = 0.0f;
  if (lobe == kDiffuse) {
    diffuse_f_pdf(p, wo, wi, &f, &pdf);
  } else if (lobe == kConductor) {
    conductor_f_pdf(p, wo, wi, &f, &pdf);
  } else if (lobe == kDielectric) {
    dielectric_f_pdf(p, wo, wi, &f, &pdf);
  }
  f_out[i] = f;
  pdf_out[i] = pdf;
}

__device__ __forceinline__ V3 mirror(V3 wo) { return {-wo.x, -wo.y, wo.z}; }

struct Sample {
  V3 wi = {0.0f, 0.0f, 0.0f};
  float4 f = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float pdf = 0.0f;
  float eta_scale = 0.0f;
  bool specular = false, transmission = false, dispersed = false;
};

__device__ void diffuse_sample(const Lane& p, V3 wo, float u0, float u1,
                               Sample* s) {
  float dx, dy;
  disk_concentric(u0, u1, &dx, &dy);
  const float dz = sqrtf(clamp_min(1.0f - dx * dx - dy * dy, 0.0f));
  s->wi = {dx, dy, wo.z < 0.0f ? -dz : dz};
  diffuse_f_pdf(p, wo, s->wi, &s->f, &s->pdf);
  s->eta_scale = 1.0f;
}

__device__ void conductor_sample(const Lane& p, V3 wo, float u0, float u1,
                                 Sample* s) {
  s->specular = effectively_smooth(p.ax, p.ay);
  s->eta_scale = 1.0f;
  if (s->specular) {
    s->wi = mirror(wo);
    const float4 F = fr_complex(fabsf(wo.z), p.eta, p.k);
    const float c = fabsf(s->wi.z);
    s->f = make_float4(safe_div(F.x, c), safe_div(F.y, c), safe_div(F.z, c),
                       safe_div(F.w, c));
    s->pdf = 1.0f;
    return;
  }
  s->wi = reflect(wo, tr_sample_wm(wo, u0, u1, p.ax, p.ay));
  conductor_f_pdf(p, wo, s->wi, &s->f, &s->pdf);
}

__device__ void dielectric_sample(const Lane& p, V3 wo, float uc, float u0,
                                  float u1, Sample* s) {
  const float eta_s = p.eta.x;
  s->specular = effectively_smooth(p.ax, p.ay);
  if (s->specular) {
    const float F = fr_dielectric(wo.z, eta_s);
    if (uc < F) {
      s->wi = mirror(wo);
      const float fs = safe_div(F, fabsf(s->wi.z));
      s->f = make_float4(fs, fs, fs, fs);
      s->pdf = F;
    } else {
      s->transmission = true;
      float etap;
      const bool ok = refract(wo, {0.0f, 0.0f, 1.0f}, eta_s, &s->wi, &etap);
      const float fs =
          ok ? safe_div((1.0f - F) / sqr(etap), fabsf(s->wi.z)) : 0.0f;
      s->f = make_float4(fs, fs, fs, fs);
      s->pdf = ok ? 1.0f - F : 1.0f;
    }
  } else {
    const V3 wm = tr_sample_wm(wo, u0, u1, p.ax, p.ay);
    const float F = fr_dielectric(dot(wo, wm), eta_s);
    const bool refl = uc < F;
    bool ok = true;
    float etap;
    if (refl) {
      s->wi = reflect(wo, wm);
    } else {
      ok = refract(wo, wm, eta_s, &s->wi, &etap);
    }
    const bool same_h = wo.z * s->wi.z > 0.0f;
    const bool lobe_ok = refl ? same_h : (!same_h && ok);
    s->transmission = !refl;
    if (lobe_ok) dielectric_f_pdf(p, wo, s->wi, &s->f, &s->pdf);
  }
  s->eta_scale =
      s->transmission ? sqr(wo.z > 0.0f ? eta_s : rcp(eta_s)) : 1.0f;
  const float spread =
      maximum(maximum(p.eta.x, p.eta.y), maximum(p.eta.z, p.eta.w)) -
      minimum(minimum(p.eta.x, p.eta.y), minimum(p.eta.z, p.eta.w));
  s->dispersed = s->transmission && spread > 1e-4f;
}

__global__ void __launch_bounds__(kThreads)
bxdf_sample_kernel(const int* __restrict__ tag,
                   const float4* __restrict__ albedo,
                   const float* __restrict__ alpha_x,
                   const float* __restrict__ alpha_y,
                   const float4* __restrict__ eta,
                   const float4* __restrict__ k,
                   const float* __restrict__ wo_,
                   const float* __restrict__ uc_,
                   const float2* __restrict__ u2_,
                   float* __restrict__ wi_out, float4* __restrict__ f_out,
                   float* __restrict__ pdf_out, uint8_t* __restrict__ valid,
                   uint8_t* __restrict__ specular,
                   uint8_t* __restrict__ transmission,
                   float* __restrict__ eta_scale,
                   uint8_t* __restrict__ dispersed, int n, unsigned present,
                   int single) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int lobe = lobe_of(tag[i], present, single);
  const Lane p = load_lane(i, lobe, albedo, alpha_x, alpha_y, eta, k);
  const V3 wo = load3(wo_, i);
  const float2 u2 = u2_[i];
  Sample s;
  if (lobe == kDiffuse) {
    diffuse_sample(p, wo, u2.x, u2.y, &s);
  } else if (lobe == kConductor) {
    conductor_sample(p, wo, u2.x, u2.y, &s);
  } else if (lobe == kDielectric) {
    dielectric_sample(p, wo, uc_[i], u2.x, u2.y, &s);
  }
  wi_out[3 * i] = s.wi.x;
  wi_out[3 * i + 1] = s.wi.y;
  wi_out[3 * i + 2] = s.wi.z;
  f_out[i] = s.f;
  pdf_out[i] = clamp_min(s.pdf, 0.0f);
  valid[i] = s.pdf > 0.0f;
  specular[i] = s.specular;
  transmission[i] = s.transmission;
  eta_scale[i] = s.eta_scale;
  dispersed[i] = s.dispersed;
}

__host__ __forceinline__ int blocks(int n) {
  return (n + kThreads - 1) / kThreads;
}

}  // namespace

// f (n, 4) and pdf (n,) of (wo, wi) (n, 3). tag (n,) int32; albedo, eta, k
// (n, 4) and alpha_x, alpha_y (n,) float32, each read only where a lane's
// lobe needs it (null where no present tag does); the (n, 4) arrays
// 16-byte aligned. present: the bit set of the present tags; single: the
// one present tag, or -1 for several. Returns cudaGetLastError() after the
// launch.
extern "C" int bxdf_eval_launch(const int* tag, const float* albedo,
                                const float* alpha_x, const float* alpha_y,
                                const float* eta, const float* k,
                                const float* wo, const float* wi, float* f,
                                float* pdf, int n, int present, int single,
                                void* stream) {
  if (n == 0) return 0;
  bxdf_eval_kernel<<<blocks(n), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      tag, reinterpret_cast<const float4*>(albedo), alpha_x, alpha_y,
      reinterpret_cast<const float4*>(eta),
      reinterpret_cast<const float4*>(k), wo, wi,
      reinterpret_cast<float4*>(f), pdf, n, static_cast<unsigned>(present),
      single);
  return static_cast<int>(cudaGetLastError());
}

// A sample of (wo (n, 3), uc (n,), u2 (n, 2), 8-byte aligned): wi (n, 3),
// f (n, 4), pdf (n,) clamped at 0, valid, specular, transmission (n,)
// bool, eta_scale (n,), dispersed (n,) bool. uc is read only by the
// dielectric (null where it is not present); the rest as for
// bxdf_eval_launch.
extern "C" int bxdf_sample_launch(const int* tag, const float* albedo,
                                  const float* alpha_x, const float* alpha_y,
                                  const float* eta, const float* k,
                                  const float* wo, const float* uc,
                                  const float* u2, float* wi, float* f,
                                  float* pdf, uint8_t* valid,
                                  uint8_t* specular, uint8_t* transmission,
                                  float* eta_scale, uint8_t* dispersed,
                                  int n, int present, int single,
                                  void* stream) {
  if (n == 0) return 0;
  bxdf_sample_kernel<<<blocks(n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      tag, reinterpret_cast<const float4*>(albedo), alpha_x, alpha_y,
      reinterpret_cast<const float4*>(eta),
      reinterpret_cast<const float4*>(k), wo, uc,
      reinterpret_cast<const float2*>(u2), wi,
      reinterpret_cast<float4*>(f), pdf, valid, specular, transmission,
      eta_scale, dispersed, n, static_cast<unsigned>(present), single);
  return static_cast<int>(cudaGetLastError());
}
