"""BxDFs in the local shading frame (counterpart of pbrt_tpu/bxdfs.py): the
diffuse lobe, the conductor and the dielectric (smooth, and rough through
the Trowbridge-Reitz microfacet functions) and the hair BxDF, the ones the
ported paths use.

Conventions follow the reference: wo, wi in shading space with n = (0, 0,
1), both pointing away from the surface; f holds no cosine; pdfs are
solid angle; spectral values are (N, 4). The dispatchers take the static
set of tags present in the scene (`BSDFParams.tags_present`). On a card,
a tag set within the diffuse lobe, the conductor and the dielectric runs
as one kernel a call (ops/bxdf.py, csrc/bxdf.cu); CPU tensors and the hair
lobe run the plain versions (bsdf_f_plain, bsdf_pdf_plain,
bsdf_sample_plain), which evaluate the lobe of each present tag and
select per lane by tag, as the reference does; a tag outside PORTED
raises. The dielectric is the radiance-mode one (the reference's adjoint
mode serves light subpaths, not ported).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import spans
from .ops import bxdf as bxdf_kernel
from .utils import vecmath as vm
from .utils.math import INV_PI, PI, safe_div, safe_sqrt, sqr

BXDF_DIFFUSE = 0     # the reference's tags
BXDF_CONDUCTOR = 1
BXDF_DIELECTRIC = 2
BXDF_HAIR = 7
PORTED = (BXDF_DIFFUSE, BXDF_CONDUCTOR, BXDF_DIELECTRIC, BXDF_HAIR)


@dataclasses.dataclass
class BSDFParams:
    """Per-lane BSDF parameters after material evaluation. alpha_x,
    alpha_y: the microfacet roughness (after the row's remap); eta, k: the
    real and imaginary IOR at the lane's wavelengths (a dielectric reads
    eta only, its hero wavelength's for the lobe). Hair packs its
    parameters as the reference does: albedo = spectral sigma_a, alpha_x =
    beta_m, alpha_y = beta_n, eta[:, 0] = the fiber's IOR, h = the
    azimuthal offset in [-1, 1] (from the curve hit's v)."""
    tag: torch.Tensor        # (N,) int
    albedo: torch.Tensor     # (N, 4) reflectance at the lane's wavelengths
    alpha_x: torch.Tensor = None   # (N,)
    alpha_y: torch.Tensor = None   # (N,)
    eta: torch.Tensor = None       # (N, 4)
    h: torch.Tensor = None         # (N,)
    tags_present: tuple = (BXDF_DIFFUSE,)
    k: torch.Tensor = None         # (N, 4)


def _check(p: BSDFParams):
    other = [t for t in p.tags_present if t not in PORTED]
    if other:
        raise NotImplementedError(
            f"BxDF tags {other}: only the diffuse, conductor, dielectric and "
            "hair lobes are ported (ROADMAP.md slice 3: coated diffuse with "
            "portalbox, item 14; subsurface with the machines frame, item "
            "15; slice 4 item 26: thin dielectric, diffuse transmission, "
            "coated conductor; item 21: the measured BRDF)")


def fr_dielectric(cos_theta_i, eta):
    """Unpolarized Fresnel reflectance, real eta; a negative cos_theta_i
    (inside the medium) flips eta (reference FrDielectric)."""
    cos_theta_i = torch.clamp(cos_theta_i, -1.0, 1.0)
    eta = torch.where(cos_theta_i < 0, 1.0 / eta, eta)
    cos_theta_i = torch.abs(cos_theta_i)
    sin2_i = 1.0 - sqr(cos_theta_i)
    sin2_t = sin2_i / sqr(eta)
    cos_theta_t = safe_sqrt(1.0 - sin2_t)
    r_parl = safe_div(eta * cos_theta_i - cos_theta_t,
                      eta * cos_theta_i + cos_theta_t)
    r_perp = safe_div(cos_theta_i - eta * cos_theta_t,
                      cos_theta_i + eta * cos_theta_t)
    F = 0.5 * (sqr(r_parl) + sqr(r_perp))
    return torch.where(sin2_t >= 1.0, 1.0, F)


def fr_complex(cos_theta_i, eta, k):
    """Fresnel reflectance for the complex IOR eta - i k (conductors), in
    real pairs (reference FrComplex)."""
    cos_theta_i = torch.clamp(torch.abs(cos_theta_i), 0.0, 1.0)
    cos2 = sqr(cos_theta_i)
    sin2 = 1.0 - cos2
    # eta_c^2 = (eta^2 - k^2) + i 2 eta k; w = sqrt(eta_c^2 - sin2)
    e2r = sqr(eta) - sqr(k)
    e2i = 2.0 * eta * k
    wr = e2r - sin2
    wi = e2i
    mag = torch.sqrt(torch.clamp(sqr(wr) + sqr(wi), min=1e-30))
    sr = torch.sqrt(torch.clamp((mag + wr) / 2.0, min=0.0))
    si = torch.sign(wi) * torch.sqrt(torch.clamp((mag - wr) / 2.0, min=0.0))

    def cdiv(ar, ai, br, bi):
        den = torch.clamp(sqr(br) + sqr(bi), min=1e-30)
        return (ar * br + ai * bi) / den, (ai * br - ar * bi) / den
    # r_perp = (cos - w) / (cos + w)
    rp_r, rp_i = cdiv(cos_theta_i - sr, -si, cos_theta_i + sr, si)
    r_perp = sqr(rp_r) + sqr(rp_i)
    # r_parl = (eta_c^2 cos - w) / (eta_c^2 cos + w)
    rl_r, rl_i = cdiv(e2r * cos_theta_i - sr, e2i * cos_theta_i - si,
                      e2r * cos_theta_i + sr, e2i * cos_theta_i + si)
    r_parl = sqr(rl_r) + sqr(rl_i)
    return 0.5 * (r_perp + r_parl)


# ---------------------------------------------------------------------------
# Trowbridge-Reitz (GGX) microfacet distribution (reference TrowbridgeReitz)

def tr_d(wm, ax, ay):
    tan2 = vm.tan2_theta(wm)
    cos4 = sqr(vm.cos2_theta(wm))
    e = (sqr(vm.cos_phi(wm) / ax) + sqr(vm.sin_phi(wm) / ay)) * tan2
    d = safe_div(torch.ones_like(e), PI * ax * ay * cos4 * sqr(1.0 + e))
    return torch.where(torch.isfinite(tan2), d, 0.0)


def tr_lambda(w, ax, ay):
    tan2 = vm.tan2_theta(w)
    alpha2 = sqr(vm.cos_phi(w) * ax) + sqr(vm.sin_phi(w) * ay)
    lam = (safe_sqrt(1.0 + alpha2 * tan2) - 1.0) / 2.0
    return torch.where(torch.isfinite(tan2), lam, 0.0)


def tr_g1(w, ax, ay):
    return 1.0 / (1.0 + tr_lambda(w, ax, ay))


def tr_g(wo, wi, ax, ay):
    return 1.0 / (1.0 + tr_lambda(wo, ax, ay) + tr_lambda(wi, ax, ay))


def tr_d_visible(w, wm, ax, ay):
    """Visible-normal density of wm seen from w."""
    return safe_div(tr_g1(w, ax, ay) * vm.absdot(w, wm) * tr_d(wm, ax, ay),
                    vm.abs_cos_theta(w))


def tr_sample_wm(w, u, ax, ay):
    """Sample a visible normal (reference Sample_wm; Heitz 2018). w (N, 3),
    u (N, 2), ax, ay (N,)."""
    wh = vm.normalize(torch.stack([ax * w[..., 0], ay * w[..., 1],
                                   w[..., 2]], dim=-1))
    wh = torch.where((wh[..., 2] < 0)[..., None], -wh, wh)
    z_axis = torch.zeros_like(wh)
    z_axis[..., 2] = 1.0
    x_axis = torch.zeros_like(wh)
    x_axis[..., 0] = 1.0
    t1 = torch.where((wh[..., 2] < 0.999)[..., None],
                     vm.normalize(vm.cross(z_axis, wh)), x_axis)
    t2 = vm.cross(wh, t1)
    p0, p1 = sample_uniform_disk_concentric(u[..., 0], u[..., 1])
    h = safe_sqrt(1.0 - sqr(p0))
    t = (1.0 + wh[..., 2]) / 2.0
    py = (1.0 - t) * h + t * p1
    pz = safe_sqrt(1.0 - sqr(p0) - sqr(py))
    nh = p0[..., None] * t1 + py[..., None] * t2 + pz[..., None] * wh
    wm = torch.stack([ax * nh[..., 0], ay * nh[..., 1],
                      torch.clamp(nh[..., 2], min=1e-6)], dim=-1)
    return vm.normalize(wm)


def tr_pdf(w, wm, ax, ay):
    """The reference's tr_pdf, term for term."""
    ad = vm.absdot(w, wm)
    return tr_d_visible(w, wm, ax, ay) / (4.0 * torch.clamp(ad, min=1e-8)) * \
        4.0 * ad / (4.0 * torch.clamp(ad, min=1e-8))


def tr_effectively_smooth(ax, ay):
    return torch.maximum(ax, ay) < 1e-3


def roughness_to_alpha(roughness):
    """The reference's RoughnessToAlpha: sqrt."""
    return torch.sqrt(torch.clamp(roughness, min=0.0))


def sample_uniform_disk_concentric(u0, u1):
    """Concentric disk mapping (reference SampleUniformDiskConcentric)."""
    ox = 2.0 * u0 - 1.0
    oy = 2.0 * u1 - 1.0
    zero = (ox == 0.0) & (oy == 0.0)
    cond = torch.abs(ox) > torch.abs(oy)
    r = torch.where(cond, ox, oy)
    theta = torch.where(cond, (PI / 4.0) * safe_div(oy, ox),
                        (PI / 2.0) - (PI / 4.0) * safe_div(ox, oy))
    r = torch.where(zero, 0.0, r)
    return r * torch.cos(theta), r * torch.sin(theta)


def sample_cosine_hemisphere(u0, u1):
    """Cosine-distributed direction about +z, as components (x, y, z)."""
    dx, dy = sample_uniform_disk_concentric(u0, u1)
    return dx, dy, torch.sqrt(torch.clamp(1.0 - dx * dx - dy * dy, min=0.0))


def _diffuse_f_pdf(p: BSDFParams, wo, wi):
    same = wo[..., 2] * wi[..., 2] > 0.0
    f = torch.where(same[..., None], p.albedo * INV_PI, 0.0)
    pdf = torch.where(same, torch.abs(wi[..., 2]) * INV_PI, 0.0)
    return f, pdf


def _conductor_f_pdf(p: BSDFParams, wo, wi):
    """The rough conductor; the smooth one is specular (bsdf_sample only)."""
    same = vm.same_hemisphere(wo, wi)
    cos_o = vm.abs_cos_theta(wo)
    cos_i = vm.abs_cos_theta(wi)
    wm = wo + wi
    wm_ok = vm.length_squared(wm) > 1e-12
    wm = vm.normalize(wm)
    F = fr_complex(vm.absdot(wo, wm)[..., None], p.eta, p.k)
    d = tr_d(wm, p.alpha_x, p.alpha_y)
    g = tr_g(wo, wi, p.alpha_x, p.alpha_y)
    f = safe_div(d * g, 4.0 * cos_o * cos_i)[..., None] * F
    pdf = tr_d_visible(wo, wm, p.alpha_x, p.alpha_y) / \
        (4.0 * torch.clamp(vm.absdot(wo, wm), min=1e-8))
    smooth = tr_effectively_smooth(p.alpha_x, p.alpha_y)
    valid = same & wm_ok & ~smooth & (cos_o > 0) & (cos_i > 0)
    return torch.where(valid[..., None], f, 0.0), torch.where(valid, pdf, 0.0)


def _dielectric_f_pdf(p: BSDFParams, wo, wi):
    """The rough dielectric's reflection and transmission (reference
    DielectricBxDF::f, radiance mode: transmission carries 1/etap^2), at
    the hero wavelength's eta; the smooth one is specular."""
    eta_s = p.eta[..., 0]
    cos_o = vm.cos_theta(wo)
    cos_i = vm.cos_theta(wi)
    reflectv = cos_i * cos_o > 0
    etap = torch.where(reflectv, 1.0,
                       torch.where(cos_o > 0, eta_s, 1.0 / eta_s))
    wm = wi * etap[..., None] + wo
    wm_ok = vm.length_squared(wm) > 1e-12
    wm = vm.normalize(wm)
    wm = torch.where((vm.cos_theta(wm) < 0)[..., None], -wm, wm)
    # microfacets facing away from either direction
    backface = (vm.dot(wm, wi) * cos_i < 0) | (vm.dot(wm, wo) * cos_o < 0)
    F = fr_dielectric(vm.dot(wo, wm), eta_s)
    d = tr_d(wm, p.alpha_x, p.alpha_y)
    g = tr_g(wo, wi, p.alpha_x, p.alpha_y)
    f_r = safe_div(d * g * F, torch.abs(4.0 * cos_o * cos_i))
    denom = sqr(vm.dot(wi, wm) + vm.dot(wo, wm) / etap)
    f_t = safe_div(d * (1.0 - F) * g
                   * torch.abs(vm.dot(wi, wm) * vm.dot(wo, wm)),
                   torch.abs(cos_i * cos_o) * denom)
    f_t = f_t / sqr(etap)
    f_scalar = torch.where(reflectv, f_r, f_t)
    # the lobe is chosen with probability R / (R + T)
    pdf_wm = tr_d_visible(wo, wm, p.alpha_x, p.alpha_y)
    pr, pt = F, 1.0 - F
    dwm_dwi_r = 1.0 / (4.0 * torch.clamp(vm.absdot(wo, wm), min=1e-8))
    dwm_dwi_t = safe_div(torch.abs(vm.dot(wi, wm)), denom)
    pdf = torch.where(reflectv, pdf_wm * dwm_dwi_r * safe_div(pr, pr + pt),
                      pdf_wm * dwm_dwi_t * safe_div(pt, pr + pt))
    smooth = tr_effectively_smooth(p.alpha_x, p.alpha_y)
    valid = wm_ok & ~smooth & ~backface & (cos_o != 0) & (cos_i != 0)
    f = torch.where(valid[..., None],
                    f_scalar[..., None] * torch.ones_like(p.albedo), 0.0)
    return f, torch.where(valid, pdf, 0.0)


# ---------------------------------------------------------------------------
# Hair BxDF (reference bxdfs.h:921 HairBxDF: Marschner's longitudinal lobes
# with Chiang's azimuthal logistic lobes). Hair shading frame: +x along the
# fiber (dpdu = the curve tangent), (y, z) the normal plane; the cuticle
# tilt alpha is the reference's default 2 degrees.

_P_MAX = 3
_HAIR_ALPHA = np.deg2rad(2.0)
_TWO_PI = 2.0 * np.pi
# sin and cos of alpha, 2 alpha and 4 alpha
_TILT = tuple(float(f(k * _HAIR_ALPHA)) for k in (1, 2, 4)
              for f in (np.sin, np.cos))


def _i0(x):
    """Modified Bessel I0, 10-term series (reference util/math.h I0)."""
    val = torch.zeros_like(x)
    x2i = torch.ones_like(x)
    ifact = 1.0
    i4 = 1.0
    for i in range(10):
        if i > 1:
            ifact *= i
        val = val + x2i / (i4 * ifact * ifact)
        x2i = x2i * x * x
        i4 *= 4.0
    return val


def _log_i0(x):
    log_2pi = float(torch.log(torch.tensor(_TWO_PI, dtype=torch.float32)))
    big = x + 0.5 * (-log_2pi
                     + torch.log(safe_div(1.0, torch.clamp(x, min=1e-6)))
                     + safe_div(1.0, 8.0 * torch.clamp(x, min=1e-6)))
    return torch.where(x > 12.0, big,
                       torch.log(torch.clamp(_i0(x), min=1e-30)))


def _mp(cos_i, cos_o, sin_i, sin_o, v):
    """Longitudinal scattering lobe (reference Mp)."""
    a = cos_i * cos_o / v
    b = sin_i * sin_o / v
    small = torch.exp(_log_i0(a) - b - safe_div(1.0, v) + 0.6931
                      + torch.log(safe_div(1.0, 2.0 * v)))
    big = safe_div(torch.exp(-b) * _i0(a),
                   torch.sinh(safe_div(1.0, v)) * 2.0 * v)
    return torch.where(v <= 0.1, small, big)


def _logistic(x, s):
    e = torch.exp(-torch.abs(x) / s)
    return safe_div(e, s * sqr(1.0 + e))


def _logistic_cdf(x, s):
    return 1.0 / (1.0 + torch.exp(-x / s))


def _trimmed_logistic(x, s, a, b):
    return safe_div(_logistic(x, s),
                    _logistic_cdf(b, s) - _logistic_cdf(a, s))


def _sample_trimmed_logistic(u, s, a, b):
    k = _logistic_cdf(b, s) - _logistic_cdf(a, s)
    x = -s * torch.log(safe_div(1.0, u * k + _logistic_cdf(a, s)) - 1.0)
    return torch.clamp(x, a, b)


def _phi_p(p, gamma_o, gamma_t):
    return 2.0 * p * gamma_t - 2.0 * gamma_o + p * np.pi


def _wrap_phi(dphi):
    """Wrap to [-pi, pi]."""
    return dphi - _TWO_PI * torch.floor((dphi + np.pi) / _TWO_PI)


def _np_lobe(phi, p, s, gamma_o, gamma_t):
    return _trimmed_logistic(_wrap_phi(phi - _phi_p(p, gamma_o, gamma_t)),
                             s, -np.pi, np.pi)


def _hair_vs(beta_m, beta_n):
    """Longitudinal variances of lobes 0-3 and the azimuthal logistic
    scale, from beta_m and beta_n (reference HairBxDF constructor)."""
    v0 = sqr(0.726 * beta_m + 0.812 * sqr(beta_m) + 3.7 * beta_m ** 20)
    vs = [v0, 0.25 * v0, 4.0 * v0, 4.0 * v0]
    s_az = 0.626657069 * (0.265 * beta_n + 1.194 * sqr(beta_n)
                          + 5.372 * beta_n ** 22)
    return vs, torch.clamp(s_az, min=1e-5)


def _hair_tilt(sin_to, cos_to, p):
    """(sin, |cos|) of theta_o turned by the cuticle tilt of lobe p: -2a for
    R, +a for TT, +4a for TRT."""
    s1, c1, s2, c2, s4, c4 = _TILT
    if p == 0:
        so = sin_to * c2 - cos_to * s2
        co = cos_to * c2 + sin_to * s2
    elif p == 1:
        so = sin_to * c1 + cos_to * s1
        co = cos_to * c1 - sin_to * s1
    elif p == 2:
        so = sin_to * c4 + cos_to * s4
        co = cos_to * c4 - sin_to * s4
    else:
        so, co = sin_to, cos_to
    return so, torch.abs(co)


def _hair_geom(p: BSDFParams, wo):
    """theta_o, phi_o, h and the refracted angles of the fiber."""
    sin_to = torch.clamp(wo[..., 0], -1.0, 1.0)
    cos_to = safe_sqrt(1.0 - sqr(sin_to))
    phi_o = torch.atan2(wo[..., 2], wo[..., 1])
    eta = p.eta[..., 0]
    h = torch.clamp(p.h, -1.0, 1.0) if p.h is not None else \
        torch.zeros_like(sin_to)
    gamma_o = torch.asin(h)
    sin_tt = sin_to / eta
    cos_tt = safe_sqrt(1.0 - sqr(sin_tt))
    etap = safe_sqrt(sqr(eta) - sqr(sin_to)) / torch.clamp(cos_to, min=1e-6)
    sin_gt = torch.clamp(h / torch.clamp(etap, min=1e-6), -1.0, 1.0)
    cos_gt = safe_sqrt(1.0 - sqr(sin_gt))
    gamma_t = torch.asin(sin_gt)
    return (sin_to, cos_to, phi_o, eta, h, gamma_o, sin_tt, cos_tt,
            sin_gt, cos_gt, gamma_t)


def _hair_ap(p: BSDFParams, cos_to, cos_tt, cos_gt, eta, h):
    """Attenuations A_0..A_3, (N, 4) each (reference Ap)."""
    T = torch.exp(-p.albedo * (2.0 * cos_gt
                               / torch.clamp(cos_tt, min=1e-6))[..., None])
    cos_g = safe_sqrt(1.0 - sqr(h))
    f = fr_dielectric(cos_to * cos_g, eta)[..., None]
    ap0 = f.expand(T.shape)
    ap1 = sqr(1.0 - f) * T
    ap2 = ap1 * T * f
    ap3 = safe_div(ap2 * f * T, torch.clamp(1.0 - T * f, min=1e-6))
    return [ap0, ap1, ap2, ap3]


def _lobe_weights(ap):
    """Each lobe's attenuation luminance (the mean over the 4 wavelengths)
    and their sum, the lobe-selection weights."""
    ap_lum = [a.mean(dim=-1) for a in ap]
    return ap_lum, torch.clamp(sum(ap_lum), min=1e-9)


def _hair_f_pdf(p: BSDFParams, wo, wi):
    """(f, pdf) of the hair BxDF."""
    (sin_to, cos_to, phi_o, eta, h, gamma_o, sin_tt, cos_tt, sin_gt,
     cos_gt, gamma_t) = _hair_geom(p, wo)
    sin_ti = torch.clamp(wi[..., 0], -1.0, 1.0)
    cos_ti = safe_sqrt(1.0 - sqr(sin_ti))
    phi_i = torch.atan2(wi[..., 2], wi[..., 1])
    phi = phi_i - phi_o
    vs, s_az = _hair_vs(p.alpha_x, p.alpha_y)
    ap = _hair_ap(p, cos_to, cos_tt, cos_gt, eta, h)
    ap_lum, lum_sum = _lobe_weights(ap)
    f = torch.zeros_like(p.albedo)
    pdf = torch.zeros_like(sin_to)
    for lobe in range(_P_MAX):
        so, co = _hair_tilt(sin_to, cos_to, lobe)
        mp = _mp(cos_ti, co, sin_ti, so, vs[lobe])
        np_l = _np_lobe(phi, lobe, s_az, gamma_o, gamma_t)
        f = f + mp[..., None] * ap[lobe] * np_l[..., None]
        pdf = pdf + mp * (ap_lum[lobe] / lum_sum) * np_l
    mp3 = _mp(cos_ti, cos_to, sin_ti, sin_to, vs[3])
    f = f + mp3[..., None] * ap[3] / _TWO_PI
    pdf = pdf + mp3 * (ap_lum[3] / lum_sum) / _TWO_PI
    abs_ci = torch.clamp(torch.abs(wi[..., 2]), min=1e-6)
    return f / abs_ci[..., None], pdf


def _hair_sample(p: BSDFParams, wo, uc, u2):
    """Sample wi from the hair BxDF (reference HairBxDF::Sample_f): the
    lobe by its attenuation luminance with uc, theta from the lobe's Mp
    with uc remapped and u2[0], phi from its logistic with u2[1]. Returns
    (wi, f, pdf)."""
    (sin_to, cos_to, phi_o, eta, h, gamma_o, sin_tt, cos_tt, sin_gt,
     cos_gt, gamma_t) = _hair_geom(p, wo)
    vs, s_az = _hair_vs(p.alpha_x, p.alpha_y)
    ap = _hair_ap(p, cos_to, cos_tt, cos_gt, eta, h)
    ap_lum, lum_sum = _lobe_weights(ap)
    c0 = ap_lum[0] / lum_sum
    c1 = c0 + ap_lum[1] / lum_sum
    c2 = c1 + ap_lum[2] / lum_sum
    lobe = torch.where(uc < c0, 0, torch.where(uc < c1, 1,
                                               torch.where(uc < c2, 2, 3)))
    lo = torch.where(lobe == 0, 0.0, torch.where(
        lobe == 1, c0, torch.where(lobe == 2, c1, c2)))
    hi = torch.where(lobe == 0, c0, torch.where(
        lobe == 1, c1, torch.where(lobe == 2, c2, 1.0)))
    u0 = torch.clamp(safe_div(uc - lo, torch.clamp(hi - lo, min=1e-9)), 1e-5,
                     1.0 - 1e-5)
    so_t = torch.zeros_like(sin_to)
    co_t = torch.zeros_like(cos_to)
    v_sel = torch.zeros_like(sin_to)
    for lb in range(4):
        so, co = _hair_tilt(sin_to, cos_to, lb)
        m = lobe == lb
        so_t = torch.where(m, so, so_t)
        co_t = torch.where(m, co, co_t)
        v_sel = torch.where(m, vs[lb], v_sel)
    # Mp sample: cos theta = 1 + v log(u + (1 - u) e^{-2/v})
    cos_theta = 1.0 + v_sel * torch.log(
        u0 + (1.0 - u0) * torch.exp(-2.0 / torch.clamp(v_sel, min=1e-6)))
    sin_theta = safe_sqrt(1.0 - sqr(cos_theta))
    u1 = torch.clamp(u2[..., 0], 1e-5, 1.0 - 1e-5)
    cos_phi_m = torch.cos(_TWO_PI * u1)
    sin_ti = -cos_theta * so_t + sin_theta * cos_phi_m * co_t
    cos_ti = safe_sqrt(1.0 - sqr(sin_ti))
    u_phi = torch.clamp(u2[..., 1], 1e-5, 1.0 - 1e-5)
    dphi_log = _sample_trimmed_logistic(u_phi, s_az, -np.pi, np.pi)
    phi_i = torch.zeros_like(sin_to)
    for lb in range(4):
        m = lobe == lb
        if lb < _P_MAX:
            phi_i = torch.where(m, phi_o + _phi_p(lb, gamma_o, gamma_t)
                                + dphi_log, phi_i)
        else:
            phi_i = torch.where(m, phi_o + _TWO_PI * u_phi, phi_i)
    wi = torch.stack([sin_ti, cos_ti * torch.cos(phi_i),
                      cos_ti * torch.sin(phi_i)], dim=-1)
    f, pdf = _hair_f_pdf(p, wo, wi)
    return wi, f, pdf


# ---------------------------------------------------------------------------
# Dispatch over the tags present

_F_PDF_FNS = {BXDF_DIFFUSE: _diffuse_f_pdf,
              BXDF_CONDUCTOR: _conductor_f_pdf,
              BXDF_DIELECTRIC: _dielectric_f_pdf, BXDF_HAIR: _hair_f_pdf}


def _select(p: BSDFParams, per_tag):
    """Per lane, the value of its own tag's lobe from {tag: value} (a lane
    of no present tag keeps 0, as in the reference)."""
    if len(per_tag) == 1:
        return next(iter(per_tag.values()))
    out = None
    for t, v in per_tag.items():
        m = p.tag == t
        m = m[..., None] if v.dim() > m.dim() else m
        out = torch.where(m, v, torch.zeros_like(v) if out is None else out)
    return out


@spans.span("bsdf.eval")
def bsdf_f(p: BSDFParams, wo, wi):
    """f(wo, wi) of the non-specular lobes, (N, 4): the kernel where
    bxdf_kernel.takes the scene's tag set on wo's device, else
    bsdf_f_plain."""
    if bxdf_kernel.takes(p.tags_present, wo.device):
        return bxdf_kernel.f_pdf(p, wo, wi)[0]
    return bsdf_f_plain(p, wo, wi)


@spans.span("bsdf.eval")
def bsdf_pdf(p: BSDFParams, wo, wi):
    """Solid-angle pdf of sampling wi, (N,): the kernel or bsdf_pdf_plain,
    as bsdf_f."""
    if bxdf_kernel.takes(p.tags_present, wo.device):
        return bxdf_kernel.f_pdf(p, wo, wi)[1]
    return bsdf_pdf_plain(p, wo, wi)


def bsdf_f_plain(p: BSDFParams, wo, wi):
    """Plain version of bsdf_f: every present tag's lobe over all lanes."""
    _check(p)
    bxdf_kernel.counter.plain += 1
    return _select(p, {t: _F_PDF_FNS[t](p, wo, wi)[0]
                       for t in p.tags_present})


def bsdf_pdf_plain(p: BSDFParams, wo, wi):
    """Plain version of bsdf_pdf."""
    _check(p)
    bxdf_kernel.counter.plain += 1
    return _select(p, {t: _F_PDF_FNS[t](p, wo, wi)[1]
                       for t in p.tags_present})


def _mirror(wo):
    return torch.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], dim=-1)


def _conductor_sample(p: BSDFParams, wo, u2, smooth):
    """(wi, f, pdf): the mirror direction where the lobe is smooth, else a
    visible normal's reflection."""
    wi_s = _mirror(wo)
    F_s = fr_complex(vm.abs_cos_theta(wo)[..., None], p.eta, p.k)
    f_s = safe_div(F_s, vm.abs_cos_theta(wi_s)[..., None])
    wi_r = vm.reflect(wo, tr_sample_wm(wo, u2, p.alpha_x, p.alpha_y))
    f_r, pdf_r = _conductor_f_pdf(p, wo, wi_r)
    return (torch.where(smooth[..., None], wi_s, wi_r),
            torch.where(smooth[..., None], f_s, f_r),
            torch.where(smooth, 1.0, pdf_r))


def _dielectric_sample(p: BSDFParams, wo, uc, u2, smooth):
    """(wi, f, pdf, transmission, eta_scale, dispersed) of the dielectric
    (reference DielectricBxDF::Sample_f): reflection with probability F
    (uc < F), else refraction; smooth about n, rough about a visible
    normal. A transmission through a spectral eta disperses: the path
    follows the hero wavelength."""
    eta_s = p.eta[..., 0]
    # smooth
    F_s = fr_dielectric(vm.cos_theta(wo), eta_s)
    refl_s = uc < F_s
    wi_sr = _mirror(wo)
    n = torch.zeros_like(wo)
    n[..., 2] = 1.0
    ok_t, wi_st, etap_s = vm.refract(wo, n, eta_s)
    wi_s = torch.where(refl_s[..., None], wi_sr, wi_st)
    f_s = torch.where(refl_s, safe_div(F_s, vm.abs_cos_theta(wi_sr)),
                      torch.where(ok_t, safe_div((1.0 - F_s) / sqr(etap_s),
                                                 vm.abs_cos_theta(wi_st)),
                                  0.0))
    pdf_s = torch.where(refl_s, F_s, torch.where(ok_t, 1.0 - F_s, 1.0))
    # rough
    wm = tr_sample_wm(wo, u2, p.alpha_x, p.alpha_y)
    F_r = fr_dielectric(vm.dot(wo, wm), eta_s)
    refl_r = uc < F_r
    ok_rt, wi_rt, _eta = vm.refract(wo, wm, eta_s)
    wi_r = torch.where(refl_r[..., None], vm.reflect(wo, wm), wi_rt)
    # a reflection must stay in wo's hemisphere, a transmission cross it
    same_h = vm.same_hemisphere(wo, wi_r)
    lobe_ok = torch.where(refl_r, same_h, ~same_h & ok_rt)
    f_r, pdf_r = _dielectric_f_pdf(p, wo, wi_r)
    pdf_r = torch.where(lobe_ok, pdf_r, 0.0)
    f_r = torch.where(lobe_ok[..., None], f_r, 0.0)
    trans = torch.where(smooth, ~refl_s, ~refl_r)
    eta_scale = torch.where(trans, sqr(torch.where(
        vm.cos_theta(wo) > 0, eta_s, 1.0 / eta_s)), 1.0)
    dispersed = trans & (p.eta.amax(dim=-1) - p.eta.amin(dim=-1) > 1e-4)
    return (torch.where(smooth[..., None], wi_s, wi_r),
            torch.where(smooth[..., None],
                        f_s[..., None] * torch.ones_like(p.albedo), f_r),
            torch.where(smooth, pdf_s, pdf_r), trans, eta_scale, dispersed)


def bsdf_sample(p: BSDFParams, wo, uc, u2):
    """Sample wi with uc (N,) and u2 (N, 2). Returns dict(wi, f, pdf,
    valid, specular, transmission, eta_scale, dispersed): eta_scale the
    squared relative IOR of a refraction, which the integrator's roulette
    divides out (reference etaScale); dispersed a transmission through a
    spectral eta. Hair and the dielectric pick their lobe with uc; the
    diffuse lobe and the conductor leave it unused, so it may be None when
    neither is present. The kernel or bsdf_sample_plain, as bsdf_f."""
    if bxdf_kernel.takes(p.tags_present, wo.device):
        return bxdf_kernel.sample(p, wo, uc, u2)
    return bsdf_sample_plain(p, wo, uc, u2)


def bsdf_sample_plain(p: BSDFParams, wo, uc, u2):
    """Plain version of bsdf_sample: every present tag's sample over all
    lanes, the dielectric's smooth and rough branches both."""
    _check(p)
    bxdf_kernel.counter.plain += 1
    false = torch.zeros_like(wo[..., 0], dtype=torch.bool)
    one = torch.ones_like(wo[..., 0])
    smooth = None
    if BXDF_CONDUCTOR in p.tags_present or BXDF_DIELECTRIC in p.tags_present:
        smooth = tr_effectively_smooth(p.alpha_x, p.alpha_y)
    # tag -> (wi, f, pdf, specular, transmission, eta_scale, dispersed)
    out = {}
    if BXDF_DIFFUSE in p.tags_present:
        w = torch.stack(sample_cosine_hemisphere(u2[:, 0], u2[:, 1]), dim=-1)
        wi = torch.where((wo[..., 2] < 0)[..., None],
                         torch.cat([w[..., :2], -w[..., 2:]], dim=-1), w)
        out[BXDF_DIFFUSE] = (wi, *_diffuse_f_pdf(p, wo, wi), false, false,
                             one, false)
    if BXDF_CONDUCTOR in p.tags_present:
        out[BXDF_CONDUCTOR] = (*_conductor_sample(p, wo, u2, smooth), smooth,
                               false, one, false)
    if BXDF_DIELECTRIC in p.tags_present:
        wi, f, pdf, trans, eta_scale, disp = _dielectric_sample(p, wo, uc, u2,
                                                                smooth)
        out[BXDF_DIELECTRIC] = (wi, f, pdf, smooth, trans, eta_scale, disp)
    if BXDF_HAIR in p.tags_present:
        out[BXDF_HAIR] = (*_hair_sample(p, wo, uc, u2), false, false, one,
                          false)
    wi, f, pdf, spec, trans, eta_scale, disp = (
        _select(p, {t: v[i] for t, v in out.items()}) for i in range(7))
    return dict(wi=wi, f=f, pdf=torch.clamp(pdf, min=0.0), valid=pdf > 0,
                specular=spec, transmission=trans, eta_scale=eta_scale,
                dispersed=disp)
