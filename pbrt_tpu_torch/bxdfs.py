"""BxDFs in the local shading frame (counterpart of pbrt_tpu/bxdfs.py): the
diffuse lobe and the hair BxDF, the ones the ported paths use.

Conventions follow the reference: wo, wi in shading space with n = (0, 0,
1), both pointing away from the surface; f holds no cosine; pdfs are
solid angle; spectral values are (N, 4). The dispatchers take the static
set of tags present in the scene (`BSDFParams.tags_present`), evaluate the
lobe of each present tag and select per lane by tag, as the reference
does; a tag other than BXDF_DIFFUSE and BXDF_HAIR raises.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .utils.math import INV_PI, PI, safe_div, safe_sqrt, sqr

BXDF_DIFFUSE = 0     # the reference's tags
BXDF_HAIR = 7
PORTED = (BXDF_DIFFUSE, BXDF_HAIR)


@dataclasses.dataclass
class BSDFParams:
    """Per-lane BSDF parameters after material evaluation. Hair packs its
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


def _check(p: BSDFParams):
    other = [t for t in p.tags_present if t not in PORTED]
    if other:
        raise NotImplementedError(
            f"BxDF tags {other}: only the diffuse and hair lobes are ported "
            "(ROADMAP.md slice 3: conductor and dielectric with envlit, the "
            "rough dielectric with killeroo/plytex, coated diffuse and the "
            "BSSRDF with the machines frame; slice 4 item 21: the measured "
            "BRDF)")


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

_F_PDF_FNS = {BXDF_DIFFUSE: _diffuse_f_pdf, BXDF_HAIR: _hair_f_pdf}


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


def bsdf_f(p: BSDFParams, wo, wi):
    """f(wo, wi), (N, 4)."""
    _check(p)
    return _select(p, {t: _F_PDF_FNS[t](p, wo, wi)[0]
                       for t in p.tags_present})


def bsdf_pdf(p: BSDFParams, wo, wi):
    """Solid-angle pdf of sampling wi, (N,)."""
    _check(p)
    return _select(p, {t: _F_PDF_FNS[t](p, wo, wi)[1]
                       for t in p.tags_present})


def bsdf_sample(p: BSDFParams, wo, uc, u2):
    """Sample wi with uc (N,) and u2 (N, 2). Returns dict(wi, f, pdf,
    valid, specular). Hair picks its lobe with uc; the diffuse lobe leaves
    it unused, so it may be None when hair is not present."""
    _check(p)
    wi, f, pdf = {}, {}, {}
    if BXDF_DIFFUSE in p.tags_present:
        w = torch.stack(sample_cosine_hemisphere(u2[:, 0], u2[:, 1]), dim=-1)
        wi[BXDF_DIFFUSE] = torch.where(
            (wo[..., 2] < 0)[..., None],
            torch.cat([w[..., :2], -w[..., 2:]], dim=-1), w)
        f[BXDF_DIFFUSE], pdf[BXDF_DIFFUSE] = _diffuse_f_pdf(
            p, wo, wi[BXDF_DIFFUSE])
    if BXDF_HAIR in p.tags_present:
        wi[BXDF_HAIR], f[BXDF_HAIR], pdf[BXDF_HAIR] = _hair_sample(p, wo, uc,
                                                                   u2)
    pdf = _select(p, pdf)
    return dict(wi=_select(p, wi), f=_select(p, f),
                pdf=torch.clamp(pdf, min=0.0), valid=pdf > 0,
                specular=torch.zeros_like(pdf, dtype=torch.bool))
