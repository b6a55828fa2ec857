"""BxDFs in the local shading frame (counterpart of pbrt_tpu_torch/bxdfs.py),
cut to what the benchmark's cells reach: the diffuse lobe, the conductor
and the dielectric (smooth, and rough through the Trowbridge-Reitz
microfacet functions). The hair BxDF is not copied.

Conventions follow the reference: wo, wi in shading space with n = (0, 0,
1), both pointing away from the surface; f holds no cosine; pdfs are
solid angle; spectral values are (N, 4). The dispatchers take the static
set of tags present in the scene (`BSDFParams.tags_present`), evaluate the
lobe of each present tag and select per lane by tag, as the reference
does; a tag outside PORTED raises. The dielectric is the radiance-mode
one (the reference's adjoint mode serves light subpaths, not ported).
"""
from __future__ import annotations

import dataclasses

import torch

from .utils import vecmath as vm
from .utils.math import INV_PI, PI, safe_div, safe_sqrt, sqr

BXDF_DIFFUSE = 0     # the reference's tags
BXDF_CONDUCTOR = 1
BXDF_DIELECTRIC = 2
PORTED = (BXDF_DIFFUSE, BXDF_CONDUCTOR, BXDF_DIELECTRIC)


@dataclasses.dataclass
class BSDFParams:
    """Per-lane BSDF parameters after material evaluation. alpha_x,
    alpha_y: the microfacet roughness (after the row's remap); eta, k: the
    real and imaginary IOR at the lane's wavelengths (a dielectric reads
    eta only, its hero wavelength's for the lobe); h: unused here (the
    hair BxDF's azimuthal offset)."""
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
            f"BxDF tags {other}: only the diffuse, conductor and dielectric "
            "lobes are in the benchmark's reference")


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
# Dispatch over the tags present

_F_PDF_FNS = {BXDF_DIFFUSE: _diffuse_f_pdf,
              BXDF_CONDUCTOR: _conductor_f_pdf,
              BXDF_DIELECTRIC: _dielectric_f_pdf}


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
    """f(wo, wi) of the non-specular lobes, (N, 4)."""
    _check(p)
    return _select(p, {t: _F_PDF_FNS[t](p, wo, wi)[0]
                       for t in p.tags_present})


def bsdf_pdf(p: BSDFParams, wo, wi):
    """Solid-angle pdf of sampling wi, (N,)."""
    _check(p)
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
    neither is present."""
    _check(p)
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
    wi, f, pdf, spec, trans, eta_scale, disp = (
        _select(p, {t: v[i] for t, v in out.items()}) for i in range(7))
    return dict(wi=wi, f=f, pdf=torch.clamp(pdf, min=0.0), valid=pdf > 0,
                specular=spec, transmission=trans, eta_scale=eta_scale,
                dispersed=disp)
