// Whole-path megakernel for diffuse / area-light scenes on Hopper (sm_90a).
//
// Replaces two TPU kernels with one: pbrt_tpu/ops/megawave.py::
// _wave_kernel_full (megakernel v2, camera rays made in the kernel;
// launched by _run_full, entry trace_full) and ::_wave_kernel (megakernel
// v1, camera rays given; launched by _run, entry trace), both with the body
// _path_loop. A run-time switch picks the mode: with o_in and d_in set the
// camera section is skipped and fw is not written. Semantics and operation
// order follow the plain PyTorch version in
// pbrt_tpu_torch/ops/megawave.py::wave_full_plain, lane for lane: pixel
// decode from the morton|spp index, ZSobol camera dims, gaussian filter
// importance sample (Giles erf^-1), pinhole ray (or the given ray), then
// per depth the closest hit, emission with power-heuristic MIS, next-event
// estimation with an any-hit shadow ray, the diffuse cosine BSDF sample and
// Russian roulette.
//
// What bounds it on this card: about 120 B of I/O per path (index,
// wavelengths, light spectrum in; radiance and filter weight out) against
// thousands of dependent operations and two 32-triangle scans per depth.
// It is latency-bound, and it loses issue slots to lanes whose path has
// ended: paths end after 1 to max_depth bounces (cornell at depth 5: 2.6
// on average), so a warp that traces 32 paths side by side runs about half
// empty.
//
// Design:
// - One thread traces one path at a time, a bounce a pass of a loop, and
//   carries its path's state (lane, depth, o, d, beta, L, prev_pdf) from
//   pass to pass.
// - Persistent warps that regenerate paths. The grid is as many blocks as
//   the card holds at once (no more than the lanes need); each block copies
//   the read-only tables (triangle pool, per-triangle attributes, lights,
//   materials, camera, per-dimension scramble seeds, the Sobol' table) into
//   shared memory once. A thread starts on lane blockIdx * blockDim +
//   threadIdx; when a path ends it writes L (the filter weight is written
//   when the path starts) and goes idle. When at least kRefillIdle lanes of
//   a warp are idle (or all are), they take the next lanes from a global
//   counter, one atomicAdd a warp, and start them (the camera section, or
//   the given ray) while the others bounce on. A lane's result depends on
//   its own inputs alone, so the order lanes run in changes no bit.
// - The Sobol' products without their 32-step loop (zsobol.cuh): dimension
//   1's byte tables sit in shared memory (4 KB). The tables come from the
//   wrapper's per-device upload, not from a copy on every launch.
// - Rows are read by integer index; a warp's uniform reads broadcast. The
//   sampler dimension of a draw follows the lane's own depth, so the seed
//   rows a warp reads may differ lane to lane.
// - One block of 512 threads an SM (no spills): as many warps as 4 blocks
//   of 128, and faster than them.
// Built with -fmad=false so each product and sum rounds like the plain
// version's separate PyTorch ops; hit and roulette decisions then agree.
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

#include "tri_intersect.cuh"
#include "zsobol.cuh"

namespace {

using pbrt_tpu_torch::Hit;
using pbrt_tpu_torch::intersect_pool;
using pbrt_tpu_torch::kTriFloats;
using pbrt_tpu_torch::ZSobol;

constexpr int kThreads = 512;
constexpr int kMinBlocks = 1;
// a warp's idle lanes take new lanes when this many are idle (or all are);
// 1, 4 and 8 measured alike, 16 2% slower, 32 1.4x slower
constexpr int kRefillIdle = 4;
constexpr int kAttrCols = 11;
constexpr int kLightCols = 16;
constexpr int kCamCols = 19;
constexpr int kCamDims = 6;
constexpr int kDimsPerBounce = 11;
constexpr float kInvPi = 0x1.45f306p-2f;   // float32(1 / pi)
constexpr float kPi = 0x1.921fb6p+1f;      // float32(pi)
constexpr float kG7 = 0x1.c0000cp-22f;     // float32(gamma(7))
constexpr unsigned kFull = 0xffffffffu;
// the Sobol' table as the wrapper uploads it (ops/megawave.sobol_table):
// dimension 1's four 256-entry byte tables
constexpr int kSobolTable = 4 * 256;

struct FilterConst {
  float s2, inv_2s2, norm, zx, zy, ex, ey, rx, ry;
};

struct F3 {
  float x, y, z;
};

__device__ __forceinline__ float dot3(F3 a, F3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

__device__ __forceinline__ F3 cross3(F3 a, F3 b) {
  return F3{a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x};
}

__device__ __forceinline__ F3 sub3(F3 a, F3 b) {
  return F3{a.x - b.x, a.y - b.y, a.z - b.z};
}

// normalize via rsqrt (same instruction as torch.rsqrt on the card);
// len = 1 / inv as in the reference
__device__ __forceinline__ F3 normalize3(F3 a, float* len) {
  const float inv = rsqrtf(fmaxf(dot3(a, a), 1e-30f));
  if (len) *len = 1.0f / inv;
  return F3{a.x * inv, a.y * inv, a.z * inv};
}

__device__ __forceinline__ float safe_div(float a, float b) {
  return b != 0.0f ? a / b : 0.0f;
}

__device__ __forceinline__ float power_heuristic(float f, float g) {
  const float f2 = f * f;
  const float g2 = g * g;
  return isinf(f2) ? 1.0f : safe_div(f2, f2 + g2);
}

__device__ __forceinline__ float next_up(float v) {
  if (isinf(v) && v > 0.0f) return v;
  if (v == 0.0f) return __uint_as_float(1u);
  const uint32_t ui = __float_as_uint(v);
  return __uint_as_float(v >= 0.0f ? ui + 1u : ui - 1u);
}

__device__ __forceinline__ float next_down(float v) {
  if (isinf(v) && v < 0.0f) return v;
  if (v == 0.0f) return -__uint_as_float(1u);
  const uint32_t ui = __float_as_uint(v);
  return __uint_as_float(v > 0.0f ? ui - 1u : ui + 1u);
}

// offset_ray_origin_exact: push p past its error bounds along ng, on the
// side of w, and step each coordinate one float further
__device__ __forceinline__ F3 offset_origin(F3 p, F3 pe, F3 ng, F3 w) {
  const float dmag =
      fabsf(ng.x) * pe.x + fabsf(ng.y) * pe.y + fabsf(ng.z) * pe.z;
  const float sgn = dot3(w, ng) < 0.0f ? -1.0f : 1.0f;
  const float pc[3] = {p.x, p.y, p.z};
  const float nc[3] = {ng.x, ng.y, ng.z};
  float out[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float off = dmag * nc[c] * sgn;
    const float po = pc[c] + off;
    out[c] = off > 0.0f ? next_up(po) : (off < 0.0f ? next_down(po) : po);
  }
  return F3{out[0], out[1], out[2]};
}

__device__ __forceinline__ uint32_t compact_bits_2(uint32_t v) {
  v &= 0x55555555u;
  v = (v | (v >> 1)) & 0x33333333u;
  v = (v | (v >> 2)) & 0x0F0F0F0Fu;
  v = (v | (v >> 4)) & 0x00FF00FFu;
  return (v | (v >> 8)) & 0x0000FFFFu;
}

// Giles single-precision erf^-1 (utils/math.erf_inv)
__device__ __forceinline__ float erf_inv(float a) {
  const float x = fminf(fmaxf(a, -0.99999f), 0.99999f);
  const float w = -logf((1.0f - x) * (1.0f + x));
  const float w1 = w - 2.5f;
  float p1 = 2.81022636e-08f;
  p1 = 3.43273939e-07f + p1 * w1;
  p1 = -3.5233877e-06f + p1 * w1;
  p1 = -4.39150654e-06f + p1 * w1;
  p1 = 0.00021858087f + p1 * w1;
  p1 = -0.00125372503f + p1 * w1;
  p1 = -0.00417768164f + p1 * w1;
  p1 = 0.246640727f + p1 * w1;
  p1 = 1.50140941f + p1 * w1;
  const float w2 = sqrtf(fmaxf(w, 1e-6f)) - 3.0f;
  float p2 = -0.000200214257f;
  p2 = 0.000100950558f + p2 * w2;
  p2 = 0.00134934322f + p2 * w2;
  p2 = -0.00367342844f + p2 * w2;
  p2 = 0.00573950773f + p2 * w2;
  p2 = -0.0076224613f + p2 * w2;
  p2 = 0.00943887047f + p2 * w2;
  p2 = 1.00167406f + p2 * w2;
  p2 = 2.83297682f + p2 * w2;
  return (w < 5.0f ? p1 : p2) * x;
}

__device__ __forceinline__ float sigmoid_poly(const float* c, float lam) {
  const float x = (c[0] * lam + c[1]) * lam + c[2];
  if (isinf(x)) return x > 0.0f ? 1.0f : 0.0f;
  return 0.5f + x / (2.0f * sqrtf(1.0f + x * x));
}

static_assert(kThreads % 32 == 0, "whole warps: the refill is warp-wide");

// The block's copies of the read-only tables and the launch's constants.
struct Scene {
  const float* tri;
  const float* attr;
  const float* light;
  const float* mat;
  const float* cam;
  int n_tris, n_real, n_lights, max_depth, rr_start, log2_spp, ls_uniform;
  FilterConst fc;
  ZSobol zs;
};

// One path's state from bounce to bounce; lane < 0: the thread is idle.
struct Path {
  int lane;
  int depth;
  uint32_t mi;
  F3 o, d;
  float beta[4], L[4], lam[4], Le[4];
  float prev_pdf;
};

// Start lane `lane`: its index, wavelengths and light spectrum, and its
// camera ray, made here (pixel decode, filter sample, pinhole; the filter
// weight is written now) or given.
__device__ __forceinline__ void start_path(
    Path& P, int lane, const Scene& sc, const uint32_t* __restrict__ mi_in,
    const float4* __restrict__ lam_in, const float4* __restrict__ le_in,
    const float* __restrict__ o_in, const float* __restrict__ d_in,
    float* __restrict__ fw_out) {
  P.lane = lane;
  P.depth = 0;
  P.mi = mi_in[lane];
  const float4 lam4 = lam_in[lane];
  const float4 le4 = le_in[lane];
  P.lam[0] = lam4.x, P.lam[1] = lam4.y, P.lam[2] = lam4.z, P.lam[3] = lam4.w;
  P.Le[0] = le4.x, P.Le[1] = le4.y, P.Le[2] = le4.z, P.Le[3] = le4.w;
#pragma unroll
  for (int c = 0; c < 4; ++c) P.beta[c] = 1.0f, P.L[c] = 0.0f;
  P.prev_pdf = 1.0f;
  if (o_in != nullptr) {
    // ---- camera ray given (megakernel v1) ----
    P.o = F3{o_in[3 * lane], o_in[3 * lane + 1], o_in[3 * lane + 2]};
    P.d = F3{d_in[3 * lane], d_in[3 * lane + 1], d_in[3 * lane + 2]};
    return;
  }
  // ---- camera ray: pixel decode, filter sample, pinhole ----
  const float* cam = sc.cam;
  const FilterConst& fc = sc.fc;
  const uint32_t pm = P.mi >> sc.log2_spp;
  const float pxf = static_cast<float>(compact_bits_2(pm));
  const float pyf = static_cast<float>(compact_bits_2(pm >> 1));
  float u0, u1;
  sc.zs.d2(P.mi, 0, u0, u1);
  float fx = fc.s2 * erf_inv(fminf(fmaxf((2.0f * u0 - 1.0f) * fc.zx,
                                         -0.999999f), 0.999999f));
  fx = fminf(fmaxf(fx, -fc.rx), fc.rx);
  const float pdf_x = expf(-fx * fx * fc.inv_2s2) * fc.norm / fc.zx;
  float fy = fc.s2 * erf_inv(fminf(fmaxf((2.0f * u1 - 1.0f) * fc.zy,
                                         -0.999999f), 0.999999f));
  fy = fminf(fmaxf(fy, -fc.ry), fc.ry);
  const float pdf_y = expf(-fy * fy * fc.inv_2s2) * fc.norm / fc.zy;
  const float gx = fmaxf(expf(-fx * fx * fc.inv_2s2) - fc.ex, 0.0f);
  const float gy = fmaxf(expf(-fy * fy * fc.inv_2s2) - fc.ey, 0.0f);
  fw_out[lane] = (gx * gy) / fmaxf(pdf_x * pdf_y, 1e-12f);

  const float sx =
      cam[12] + ((pxf + 0.5f + fx) / cam[17]) * (cam[14] - cam[12]);
  const float sy =
      cam[15] - ((pyf + 0.5f + fy) / cam[18]) * (cam[15] - cam[13]);
  const float dcx = sx * cam[16];
  const float dcy = sy * cam[16];
  P.d = normalize3(F3{cam[0] * dcx + cam[1] * dcy + cam[2],
                      cam[4] * dcx + cam[5] * dcy + cam[6],
                      cam[8] * dcx + cam[9] * dcy + cam[10]}, nullptr);
  P.o = F3{cam[3], cam[7], cam[11]};
}

// One depth of the path: the closest hit, emission, next-event estimation,
// the BSDF sample and roulette. Returns false when the path has ended (its
// L is then final).
__device__ __forceinline__ bool bounce(Path& P, const Scene& sc) {
  const int depth = P.depth;
  if (depth >= sc.max_depth) return false;
  const F3 o = P.o, d = P.d;
  const float* lam = P.lam;
  const float* Le = P.Le;
  float* beta = P.beta;
  float* L = P.L;
  // ---- closest hit; a miss ends the path ----
  const Hit h = intersect_pool(sc.tri, sc.n_tris, sc.n_real, o.x, o.y, o.z,
                               d.x, d.y, d.z, 1e30f, false);
  if (h.prim < 0) return false;
  const float* a = sc.attr + h.prim * kAttrCols;
  const F3 p0{a[0], a[1], a[2]};
  const F3 p1{a[3], a[4], a[5]};
  const F3 p2{a[6], a[7], a[8]};
  const int mat = static_cast<int>(a[9]);
  const float lightf = a[10];
  const float b1 = h.b1, b2 = h.b2;
  const float b0 = 1.0f - b1 - b2;
  const F3 p{b0 * p0.x + b1 * p1.x + b2 * p2.x,
             b0 * p0.y + b1 * p1.y + b2 * p2.y,
             b0 * p0.z + b1 * p1.z + b2 * p2.z};
  const F3 pe{kG7 * (fabsf(b0 * p0.x) + fabsf(b1 * p1.x) + fabsf(b2 * p2.x)),
              kG7 * (fabsf(b0 * p0.y) + fabsf(b1 * p1.y) + fabsf(b2 * p2.y)),
              kG7 * (fabsf(b0 * p0.z) + fabsf(b1 * p1.z) + fabsf(b2 * p2.z))};
  const F3 e1v = sub3(p1, p0);
  const F3 e2v = sub3(p2, p0);
  float ng_len;
  const F3 ng = normalize3(cross3(e1v, e2v), &ng_len);
  const float area_hit = 0.5f * ng_len;
  const F3 wo{-d.x, -d.y, -d.z};

  // ---- emission at an emissive hit, MIS against the BSDF pdf ----
  if (lightf >= 0.0f) {
    const float* er = sc.light + static_cast<int>(lightf) * kLightCols;
    const float esc = er[9], epmf = er[10], ets = er[11];
    if (ets > 0.5f || dot3(ng, wo) > 0.0f) {
      const F3 po = sub3(p, o);
      const float dist2_e = fmaxf(dot3(po, po), 1e-12f);
      const float cos_e = fabsf(dot3(ng, wo));
      const float pdf_light = safe_div(dist2_e, cos_e * area_hit) * epmf;
      const float w_emit =
          depth == 0 ? 1.0f : power_heuristic(P.prev_pdf, pdf_light);
#pragma unroll
      for (int c = 0; c < 4; ++c) L[c] = L[c] + beta[c] * Le[c] * esc * w_emit;
    }
  }

  // ---- shading frame: ns = ng, t1 along dpdu = p1 - p0 ----
  const F3 ns = ng;
  const float dn = dot3(e1v, ns);
  F3 t1{e1v.x - dn * ns.x, e1v.y - dn * ns.y, e1v.z - dn * ns.z};
  if (dot3(t1, t1) < 1e-12f) {
    const float sign = ns.z >= 0.0f ? 1.0f : -1.0f;
    const float aa = -1.0f / (sign + ns.z);
    const float bb = ns.x * ns.y * aa;
    t1 = F3{1.0f + sign * ns.x * ns.x * aa, sign * bb, -sign * ns.x};
  }
  t1 = normalize3(t1, nullptr);
  const F3 t2 = cross3(ns, t1);
  const float wo_z = dot3(wo, ns);
  const float* mc = sc.mat + mat * 3;
  float albedo[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) albedo[c] = sigmoid_poly(mc, lam[c]);

  // ---- next-event estimation ----
  const int base = kCamDims + depth * kDimsPerBounce;
  const float u_pick = sc.zs.d1(P.mi, base);
  float ul0, ul1;
  sc.zs.d2(P.mi, base + 1, ul0, ul1);
  const int n_lights = sc.n_lights;
  int li;
  float pmf;
  if (sc.ls_uniform) {
    li = min(max(static_cast<int>(u_pick * static_cast<float>(n_lights)), 0),
             n_lights - 1);
    pmf = 1.0f / static_cast<float>(n_lights);
  } else {
    const float up = u_pick * static_cast<float>(n_lights);
    const int i0 = min(max(static_cast<int>(up), 0), n_lights - 1);
    const float frac = up - static_cast<float>(i0);
    const float* ar = sc.light + i0 * kLightCols;
    const bool take = frac < ar[12];
    li = take ? i0 : static_cast<int>(ar[13]);
    pmf = take ? ar[14] : ar[15];
  }
  const float* lv = sc.light + li * kLightCols;
  const F3 va{lv[0], lv[1], lv[2]};
  const F3 vb{lv[3], lv[4], lv[5]};
  const F3 vc{lv[6], lv[7], lv[8]};
  const float lscale = lv[9], lts = lv[11];
  // uniform point on the light triangle
  const bool cond = ul0 < ul1;
  const float sb0 = cond ? ul0 * 0.5f : ul0 - ul1 * 0.5f;
  const float sb1 = cond ? ul1 - sb0 : ul1 * 0.5f;
  const float sb2 = 1.0f - sb0 - sb1;
  const F3 p_tri{sb0 * va.x + sb1 * vb.x + sb2 * vc.x,
                 sb0 * va.y + sb1 * vb.y + sb2 * vc.y,
                 sb0 * va.z + sb1 * vb.z + sb2 * vc.z};
  float ngl_len;
  const F3 ngl = normalize3(cross3(sub3(vb, va), sub3(vc, va)), &ngl_len);
  const float area_l = 0.5f * ngl_len;
  const F3 d_tri = sub3(p_tri, p);
  const float dist2 = fmaxf(dot3(d_tri, d_tri), 1e-12f);
  const float inv_dist = rsqrtf(dist2);
  const F3 wi{d_tri.x * inv_dist, d_tri.y * inv_dist, d_tri.z * inv_dist};
  const float cos_l = -dot3(ngl, wi);
  const bool l_emit_ok = lts > 0.5f || cos_l > 0.0f;
  const float pdf_l = safe_div(dist2, fabsf(cos_l) * area_l) * pmf;
  const float wi_z = dot3(wi, ns);
  const bool same = wo_z * wi_z > 0.0f;
  const float awi = fabsf(wi_z);
  float f[4], Le_l[4];
  bool any_f = false, any_L = false;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    f[c] = same ? albedo[c] * kInvPi * awi : 0.0f;
    Le_l[c] = l_emit_ok ? Le[c] * lscale : 0.0f;
    any_f = any_f || f[c] > 0.0f;
    any_L = any_L || Le_l[c] > 0.0f;
  }
  if (pdf_l > 0.0f && any_L && any_f) {
    const F3 o_sh = offset_origin(p, pe, ng, wi);
    const F3 ds = sub3(p_tri, o_sh);
    const float dist_sh = sqrtf(fmaxf(dot3(ds, ds), 0.0f));
    const Hit sh = intersect_pool(sc.tri, sc.n_tris, sc.n_real, o_sh.x,
                                  o_sh.y, o_sh.z, wi.x, wi.y, wi.z,
                                  dist_sh * 0.999f, true);
    if (sh.prim < 0) {
      const float pdf_b = same ? awi * kInvPi : 0.0f;
      const float inv_pl = safe_div(power_heuristic(pdf_l, pdf_b), pdf_l);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        L[c] = L[c] + beta[c] * f[c] * Le_l[c] * inv_pl;
    }
  }
  if (depth + 1 >= sc.max_depth) return false;   // nothing after the last NEE

  // ---- BSDF sample: diffuse cosine lobe (concentric disk) ----
  float ub0, ub1;
  sc.zs.d2(P.mi, base + 4, ub0, ub1);
  const float ox = 2.0f * ub0 - 1.0f;
  const float oy = 2.0f * ub1 - 1.0f;
  const bool big_x = fabsf(ox) > fabsf(oy);
  float r = big_x ? ox : oy;
  const float theta = big_x ? (kPi / 4.0f) * safe_div(oy, ox)
                            : (kPi / 2.0f) - (kPi / 4.0f) * safe_div(ox, oy);
  if (ox == 0.0f && oy == 0.0f) r = 0.0f;
  const float wx = r * cosf(theta);
  const float wy = r * sinf(theta);
  float wz = sqrtf(fmaxf(1.0f - wx * wx - wy * wy, 0.0f));
  if (wo_z < 0.0f) wz = -wz;
  const bool same_b = wo_z * wz > 0.0f;
  const float acb = fabsf(wz);
  const float pdf_s = same_b ? acb * kInvPi : 0.0f;
  const float thr = safe_div(acb, pdf_s) * kInvPi;
  float beta_new[4];
  bool any_beta = false;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    beta_new[c] = beta[c] * (same_b ? albedo[c] * thr : 0.0f);
    any_beta = any_beta || beta_new[c] > 0.0f;
  }
  if (!(pdf_s > 0.0f) || !any_beta) return false;
#pragma unroll
  for (int c = 0; c < 4; ++c) beta[c] = beta_new[c];
  P.prev_pdf = pdf_s;

  // ---- Russian roulette ----
  if (depth >= sc.rr_start) {
    const float u_rr = sc.zs.d1(P.mi, base + 6);
    const float bmax = fmaxf(fmaxf(beta[0], beta[1]), fmaxf(beta[2], beta[3]));
    const float q = fmaxf(1.0f - bmax, 0.0f);
    if (bmax < 1.0f) {
      if (u_rr < q) return false;
      const float scale_rr = 1.0f / fmaxf(1.0f - q, 1e-6f);
#pragma unroll
      for (int c = 0; c < 4; ++c) beta[c] = beta[c] * scale_rr;
    }
  }

  const F3 wi_w{wx * t1.x + wy * t2.x + wz * ns.x,
                wx * t1.y + wy * t2.y + wz * ns.y,
                wx * t1.z + wy * t2.z + wz * ns.z};
  P.o = offset_origin(p, pe, ng, wi_w);
  P.d = wi_w;
  P.depth = depth + 1;
  return true;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
megawave_kernel(const float* __restrict__ g_cam, const float* __restrict__ g_tri,
                const float* __restrict__ g_attr,
                const float* __restrict__ g_light,
                const float* __restrict__ g_mat,
                const uint32_t* __restrict__ g_seeds,
                const uint32_t* __restrict__ g_sobol,
                const uint32_t* __restrict__ mi_in,
                const float4* __restrict__ lam_in,
                const float4* __restrict__ le_in,
                const float* __restrict__ o_in, const float* __restrict__ d_in,
                float4* __restrict__ L_out, float* __restrict__ fw_out,
                int* __restrict__ next_lane, int n, int n_tris, int n_real,
                int n_mats, int n_lights, int n_dims, int max_depth,
                int rr_start, int B, int log2_spp, int ls_uniform,
                FilterConst fc) {
  // ---- block-wide copy of the read-only tables into shared memory, once
  // for every path the block traces ----
  extern __shared__ __align__(16) float smem[];
  float* s_tri = smem;   // first, so its rows keep the 16 B alignment
  float* s_attr = s_tri + n_tris * kTriFloats;
  float* s_light = s_attr + n_real * kAttrCols;
  float* s_mat = s_light + n_lights * kLightCols;
  float* s_cam = s_mat + n_mats * 3;
  uint32_t* s_seed = reinterpret_cast<uint32_t*>(s_cam + kCamCols);
  uint32_t* s_sobol = s_seed + n_dims * 3;
  for (int i = threadIdx.x; i < n_tris * kTriFloats; i += blockDim.x)
    s_tri[i] = g_tri[i];
  for (int i = threadIdx.x; i < n_real * kAttrCols; i += blockDim.x)
    s_attr[i] = g_attr[i];
  for (int i = threadIdx.x; i < n_lights * kLightCols; i += blockDim.x)
    s_light[i] = g_light[i];
  for (int i = threadIdx.x; i < n_mats * 3; i += blockDim.x)
    s_mat[i] = g_mat[i];
  if (o_in == nullptr) {
    for (int i = threadIdx.x; i < kCamCols; i += blockDim.x)
      s_cam[i] = g_cam[i];
  }
  for (int i = threadIdx.x; i < n_dims * 3; i += blockDim.x)
    s_seed[i] = g_seeds[i];
  for (int i = threadIdx.x; i < kSobolTable; i += blockDim.x)
    s_sobol[i] = g_sobol[i];
  __syncthreads();
  const Scene sc{s_tri,  s_attr,     s_light,  s_mat,    s_cam,
                 n_tris, n_real,     n_lights, max_depth, rr_start,
                 log2_spp, ls_uniform, fc, ZSobol{32 - B, s_seed, s_sobol}};

  const int n_grid = gridDim.x * blockDim.x;
  const unsigned lane_lt = (1u << (threadIdx.x & 31u)) - 1u;
  Path P;
  P.lane = -1;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  if (first < n) start_path(P, first, sc, mi_in, lam_in, le_in, o_in, d_in,
                            fw_out);
  // the counter hands out the lanes after the grid's first ones; drained:
  // it has none left (the same on a warp's lanes)
  bool drained = n_grid >= n;
  for (;;) {
    if (!drained) {
      const unsigned idle = __ballot_sync(kFull, P.lane < 0);
      const int n_idle = __popc(idle);
      if (n_idle >= kRefillIdle || n_idle == 32) {
        const int leader = __ffs(idle) - 1;
        int base = 0;
        if (static_cast<int>(threadIdx.x & 31u) == leader)
          base = atomicAdd(next_lane, n_idle);
        base = n_grid + __shfl_sync(kFull, base, leader);
        if (P.lane < 0) {
          const int lane = base + __popc(idle & lane_lt);
          if (lane < n) start_path(P, lane, sc, mi_in, lam_in, le_in, o_in,
                                   d_in, fw_out);
        }
        drained = base + n_idle >= n;
      }
    }
    // a warp ends when it has no path under way and none left to take
    if (!__any_sync(kFull, P.lane >= 0)) break;
    if (P.lane >= 0 && !bounce(P, sc)) {
      L_out[P.lane] = make_float4(P.L[0], P.L[1], P.L[2], P.L[3]);
      P.lane = -1;
    }
  }
}

size_t smem_bytes(int n_tris, int n_real, int n_mats, int n_lights,
                  int n_dims) {
  return sizeof(float) * (n_tris * kTriFloats + n_real * kAttrCols +
                          n_lights * kLightCols + n_mats * 3 + kCamCols) +
         sizeof(uint32_t) * (n_dims * 3 + kSobolTable);
}

// The persistent grid: as many blocks as the card holds at once with
// `smem` bytes of shared memory a block, and no more than n lanes need.
// The SM count and the blocks an SM are queried once per (device, smem).
cudaError_t grid_size(int n, size_t smem, int* blocks, int* blocks_per_sm) {
  static std::mutex mu;
  static std::map<std::pair<int, size_t>, std::pair<int, int>> resident;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  int per_sm = 0, sms = 0;
  {
    const std::lock_guard<std::mutex> lock(mu);
    const auto it = resident.find({device, smem});
    if (it != resident.end()) {
      per_sm = it->second.first;
      sms = it->second.second;
    } else {
      if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                        device)) != cudaSuccess ||
          (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &per_sm, megawave_kernel, kThreads, smem)) != cudaSuccess)
        return err;
      if (per_sm < 1) return cudaErrorInvalidConfiguration;
      resident[{device, smem}] = {per_sm, sms};
    }
  }
  *blocks_per_sm = per_sm;
  const int want = (n + kThreads - 1) / kThreads;
  *blocks = want < sms * per_sm ? want : sms * per_sm;
  return cudaSuccess;
}

}  // namespace

// The grid megawave_launch uses for n lanes on a scene of these table
// sizes, on the calling thread's current device: blocks, blocks an SM, and
// threads a block.
extern "C" int megawave_grid(int n, int n_tris, int n_real, int n_mats,
                             int n_lights, int n_dims, int* blocks,
                             int* blocks_per_sm, int* threads) {
  *threads = kThreads;
  return static_cast<int>(
      grid_size(n, smem_bytes(n_tris, n_real, n_mats, n_lights, n_dims),
                blocks, blocks_per_sm));
}

// cam (19,), tri (n_tris*16,), attr (n_real*11,), light (n_lights*16,),
// mat (n_mats*3,) float32; seeds (n_dims*3,) and sobol (1024,) uint32
// (ops/megawave.sobol_table); mi (n,) uint32; lam, le, L (n, 4) float32,
// 16-byte aligned; o, d (n, 3) float32 camera rays, or both null for rays
// made in the kernel from cam; fw (n,) float32, written only when o is
// null (cam may then be null); next_lane: one int32 of scratch, zeroed
// here on the stream (launches that share it run on one stream). Runs on
// the calling thread's current device, which the caller sets to the one
// the tensors live on. Returns the first CUDA error, or cudaGetLastError()
// after the launch.
extern "C" int megawave_launch(
    const float* cam, const float* tri, const float* attr, const float* light,
    const float* mat, const uint32_t* seeds, const uint32_t* sobol,
    const uint32_t* mi, const float* lam, const float* le, const float* o,
    const float* d, float* L, float* fw, int* next_lane, int n, int n_tris,
    int n_real, int n_mats, int n_lights, int n_dims, int max_depth,
    int rr_start, int B, int log2_spp, int ls_uniform, float s2,
    float inv_2s2, float norm, float zx, float zy, float ex, float ey,
    float rx, float ry, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = smem_bytes(n_tris, n_real, n_mats, n_lights, n_dims);
  int blocks = 0, per_sm = 0;
  cudaError_t err;
  if ((err = grid_size(n, smem, &blocks, &per_sm)) != cudaSuccess ||
      (err = cudaMemsetAsync(next_lane, 0, sizeof(int), st)) != cudaSuccess)
    return static_cast<int>(err);
  const FilterConst fc{s2, inv_2s2, norm, zx, zy, ex, ey, rx, ry};
  megawave_kernel<<<blocks, kThreads, smem, st>>>(
      cam, tri, attr, light, mat, seeds, sobol, mi,
      reinterpret_cast<const float4*>(lam), reinterpret_cast<const float4*>(le),
      o, d, reinterpret_cast<float4*>(L), fw, next_lane, n, n_tris, n_real,
      n_mats, n_lights, n_dims, max_depth, rr_start, B, log2_spp, ls_uniform,
      fc);
  return static_cast<int>(cudaGetLastError());
}
