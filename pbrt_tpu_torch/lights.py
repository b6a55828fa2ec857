"""Lights (counterpart of pbrt_tpu/lights.py): area triangles, the analytic
sphere emitter, the uniform infinite light and the image infinite light
(an equal-area octahedral environment map, sampled through an alias table
over its texels).

The packed light pool keeps the reference layout, (L, 24):
[tag, p(3), dir(3), spec_idx, scale, tri, two_sided, cfs, cfe, is_delta,
pmf, tri_verts(9)], each area light's triangle inlined, so the two
builders can be compared array for array; a sphere light keeps its centre
in p, its radius in cfs and its quadric row in tri. Emission spectra are
rows of the scene's dense spectrum pool, scaled per light.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import spans
from .utils import color as pcolor
from .utils import sampling as usamp
from .utils import spectrum as spc
from .utils import vecmath as vm
from .utils.math import INV_4PI, PI, safe_div, safe_sqrt, sqr

LIGHT_NONE = -1       # the reference's tags
LIGHT_AREA_TRI = 3
LIGHT_UNIFORM_INFINITE = 4
LIGHT_IMAGE_INFINITE = 5
LIGHT_AREA_SPHERE = 6
PACKED_COLS = 24
# a wave evaluates the whole spectrum pool once when it holds at most
# this many spectra (reference SPEC_CACHE_MAX)
SPEC_CACHE_MAX = 64


def compute_light_power(tag, scale, spectrum: spc.Spectrum, area=None,
                        two_sided=False, scene_radius=1.0) -> float:
    """Emitted power, the light sampler's weight (reference
    compute_light_power; a sphere light is a one-sided area emitter of
    area 4 pi r^2, as the reference's add_sphere weighs it)."""
    lum = scale * spectrum.to_photometric()
    if tag in (LIGHT_AREA_TRI, LIGHT_AREA_SPHERE):
        return (2 if two_sided else 1) * np.pi * area * lum
    if tag == LIGHT_UNIFORM_INFINITE:
        return 4 * np.pi * np.pi * scene_radius ** 2 * lum
    raise NotImplementedError(
        f"light tag {tag}: only area triangles and spheres and the uniform "
        "and image infinite lights are ported (ROADMAP.md slice 3 item 25, the "
        "analytic lights)")


def pack_light_pool(rows, p0, p1, p2, pmf) -> np.ndarray:
    """Light row dicts (tag, p, dir, spec_idx, scale, tri, two_sided, cfs,
    cfe, is_delta) -> the (L, 24) float32 pool, each area light's triangle
    inlined. An empty list gives the reference's one-row dummy pool."""
    if not rows:
        out = np.zeros((1, PACKED_COLS), np.float32)
        out[0, 0] = LIGHT_NONE
        out[0, 11] = out[0, 12] = 1.0
        return out
    out = np.zeros((len(rows), PACKED_COLS), np.float32)
    for i, r in enumerate(rows):
        out[i, 0] = r["tag"]
        out[i, 1:4] = r["p"]
        out[i, 4:7] = r["dir"]
        out[i, 7] = r["spec_idx"]
        out[i, 8] = r["scale"]
        out[i, 9] = r["tri"]
        out[i, 10] = float(r["two_sided"])
        out[i, 11] = r["cfs"]
        out[i, 12] = r["cfe"]
        out[i, 13] = float(r["is_delta"])
        out[i, 14] = pmf[i]
        if r["tag"] == LIGHT_AREA_TRI:
            t = min(max(int(r["tri"]), 0), len(p0) - 1)
            out[i, 15:24] = np.concatenate([p0[t], p1[t], p2[t]])
    return out


def eval_light_spectrum(spectra_pool: torch.Tensor, spec_idx: torch.Tensor,
                        scale: torch.Tensor, lam: torch.Tensor):
    """Linear interpolation of pool spectra at lam. spectra_pool (S, 471),
    spec_idx (N,) int, scale (N,), lam (N, 4) -> (N, 4)."""
    x = torch.clamp(lam - spc.LAMBDA_MIN, 0.0, spc.N_CIE - 1.000001)
    i0 = torch.clamp(torch.floor(x).to(torch.int64), 0, spc.N_CIE - 2)
    frac = x - i0.to(torch.float32)
    flat = spectra_pool.reshape(-1)
    base = spec_idx.to(torch.int64)[..., None] * spc.N_CIE + i0
    v0 = flat[base]
    v1 = flat[base + 1]
    return scale[..., None] * (v0 * (1 - frac) + v1 * frac)


def eval_all_spectra(spectra_pool: torch.Tensor, lam: torch.Tensor):
    """Every pool spectrum at lam, once per wave: (S, 471), (N, 4) ->
    (N, 4, S)."""
    x = torch.clamp(lam - spc.LAMBDA_MIN, 0.0, spc.N_CIE - 1.000001)
    i0 = torch.clamp(torch.floor(x).to(torch.int64), 0, spc.N_CIE - 2)
    frac = x - i0.to(torch.float32)
    pool_t = spectra_pool.T
    return pool_t[i0] * (1 - frac)[..., None] + \
        pool_t[i0 + 1] * frac[..., None]


def light_spectrum(spectra_pool, spec_idx, scale, lam, spec_cache=None):
    """scale * spectrum spec_idx at lam, (N, 4); from the per-wave cache
    when there is one."""
    if spec_cache is None:
        return eval_light_spectrum(spectra_pool, spec_idx, scale, lam)
    idx = spec_idx.to(torch.int64)[:, None, None].expand(-1, 4, 1)
    return scale[..., None] * spec_cache.gather(-1, idx)[..., 0]


def sample_uniform_triangle(u0, u1):
    """Low-distortion triangle warp: barycentrics (b0, b1, b2)."""
    cond = u0 < u1
    b0 = torch.where(cond, u0 * 0.5, u0 - u1 * 0.5)
    b1 = torch.where(cond, u1 - b0, u1 * 0.5)
    return b0, b1, 1.0 - b0 - b1


def _sample_uniform_sphere(u):
    z = 1.0 - 2.0 * u[..., 0]
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * PI * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


@spans.span("light.sample_li")
def sample_li(lights_packed, light_idx, p_ref, u2, lam, spectra_pool,
              scene_radius, tags_present, spec_cache=None, env=None):
    """Sample an incident direction from light light_idx (N,) toward p_ref
    (N, 3) with u2 (N, 2) (reference sample_li, the area-triangle, sphere,
    uniform and image infinite branches; env: the scene's EnvLight).
    Returns dict(wi, L (N, 4), pdf (solid angle), p_light, is_delta,
    valid)."""
    row = lights_packed[light_idx.to(torch.int64)]
    tag = row[:, 0].round().to(torch.int32)
    Lspec = light_spectrum(spectra_pool, row[:, 7].round(), row[:, 8], lam,
                           spec_cache)
    branches = {}
    if LIGHT_AREA_TRI in tags_present:
        a, b, c = row[:, 15:18], row[:, 18:21], row[:, 21:24]
        b0, b1, b2 = sample_uniform_triangle(u2[:, 0], u2[:, 1])
        p_tri = b0[:, None] * a + b1[:, None] * b + b2[:, None] * c
        ng = vm.cross(b - a, c - a)
        area = 0.5 * vm.length(ng)
        ng = vm.normalize(ng)
        d_tri = p_tri - p_ref
        dist2 = torch.clamp(vm.length_squared(d_tri), min=1e-12)
        wi = d_tri / torch.sqrt(dist2)[:, None]
        cos_l = vm.dot(ng, -wi)
        emit_ok = (row[:, 10] > 0.5) | (cos_l > 0)
        branches[LIGHT_AREA_TRI] = (
            wi, torch.where(emit_ok[:, None], Lspec, 0.0),
            safe_div(dist2, torch.abs(cos_l) * area), p_tri)
    if LIGHT_AREA_SPHERE in tags_present:
        branches[LIGHT_AREA_SPHERE] = _sample_sphere(row, p_ref, u2, Lspec)
    if LIGHT_UNIFORM_INFINITE in tags_present:
        wi = _sample_uniform_sphere(u2)
        branches[LIGHT_UNIFORM_INFINITE] = (
            wi, Lspec, torch.full_like(u2[:, 0], INV_4PI),
            p_ref + wi * (2.0 * scene_radius))
    if LIGHT_IMAGE_INFINITE in tags_present and env is not None:
        branches[LIGHT_IMAGE_INFINITE] = env_sample_li(env, p_ref, u2, lam,
                                                       scene_radius)
    wi = torch.zeros_like(p_ref)
    L = torch.zeros_like(lam)
    pdf = torch.zeros_like(u2[:, 0])
    p_light = torch.zeros_like(p_ref)
    for t, (bwi, bL, bpdf, bp) in branches.items():
        if len(branches) == 1:
            wi, L, pdf, p_light = bwi, bL, bpdf, bp
            break
        m = tag == t
        wi = torch.where(m[:, None], bwi, wi)
        L = torch.where(m[:, None], bL, L)
        pdf = torch.where(m, bpdf, pdf)
        p_light = torch.where(m[:, None], bp, p_light)
    valid = (pdf > 0) & (L > 0).any(dim=-1)
    return dict(wi=wi, L=L, pdf=pdf, p_light=p_light,
                is_delta=row[:, 13] > 0.5, valid=valid)


def pdf_li_area_tri(p_ref, wi, p_hit, p0, p1, p2):
    """Solid-angle pdf sample_li would give direction wi from p_ref, hitting
    the light's triangle (p0, p1, p2) at p_hit."""
    ng = vm.cross(p1 - p0, p2 - p0)
    area = 0.5 * vm.length(ng)
    ng = vm.normalize(ng)
    dist2 = torch.clamp(vm.length_squared(p_hit - p_ref), min=1e-12)
    cos_l = torch.abs(vm.dot(ng, -wi))
    return safe_div(dist2, cos_l * area)


def _sample_sphere(row, p_ref, u2, Lspec):
    """The sphere light's branch of sample_li (reference Sphere::Sample
    from a reference point): a direction uniform in the cone the sphere
    subtends, the nearer intersection along it, the cone's solid-angle
    pdf (0 from inside the sphere)."""
    rad = row[:, 11]
    dvec = row[:, 1:4] - p_ref
    dc2 = torch.clamp(vm.length_squared(dvec), min=1e-12)
    dc = torch.sqrt(dc2)
    w_axis = dvec / dc[:, None]
    sin2_max = torch.clamp(sqr(rad) / dc2, 0.0, 1.0)
    cos_max = safe_sqrt(1.0 - sin2_max)
    cos_t = 1.0 - u2[:, 0] * (1.0 - cos_max)
    sin_t = safe_sqrt(1.0 - sqr(cos_t))
    phi = 2.0 * PI * u2[:, 1]
    t1, t2 = vm.coordinate_system(w_axis)
    wi = (sin_t * torch.cos(phi))[:, None] * t1 + \
        (sin_t * torch.sin(phi))[:, None] * t2 + cos_t[:, None] * w_axis
    ds = dc * cos_t - safe_sqrt(torch.clamp(sqr(rad) - dc2 * sqr(sin_t),
                                            min=0.0))
    pdf = safe_div(torch.ones_like(cos_max), 2.0 * PI * (1.0 - cos_max))
    pdf = torch.where(dc <= rad, 0.0, pdf)
    return wi, Lspec, pdf, p_ref + wi * ds[:, None]


def pdf_li_sphere(row, p_ref):
    """The cone pdf sample_li gives a direction from p_ref that hits the
    sphere light of rows (N, 24) (reference pdf_li_sphere), for MIS at an
    emitter hit."""
    rad = row[:, 11]
    dc2 = torch.clamp(vm.length_squared(row[:, 1:4] - p_ref), min=1e-12)
    sin2_max = torch.clamp(sqr(rad) / dc2, 0.0, 1.0)
    cos_max = safe_sqrt(1.0 - sin2_max)
    pdf = safe_div(torch.ones_like(cos_max), 2.0 * PI * (1.0 - cos_max))
    return torch.where(dc2 <= sqr(rad), 0.0, pdf)


def area_light_radiance(row, ng, wo, lam, spectra_pool, spec_cache=None):
    """L emitted by area-light rows (N, 24) toward wo (reference
    DiffuseAreaLight::L)."""
    Lspec = light_spectrum(spectra_pool, row[:, 7].round(), row[:, 8], lam,
                           spec_cache)
    front = vm.dot(ng, wo) > 0
    return torch.where(((row[:, 10] > 0.5) | front)[:, None], Lspec, 0.0)


def infinite_light_radiance(lights_packed, inf_indices, lam, spectra_pool,
                            spec_cache=None):
    """Sum of Le of the uniform infinite lights (host indices) for escaped
    rays, (N, 4)."""
    total = torch.zeros_like(lam)
    n = lam.shape[0]
    for i in inf_indices:
        row = lights_packed[int(i)]
        total = total + light_spectrum(
            spectra_pool, row[7].round().expand(n), row[8].expand(n), lam,
            spec_cache)
    return total


# ---------------------------------------------------------------------------
# Image infinite light (reference ImageInfiniteLight): an equal-area
# octahedral radiance map whose texels hold sigmoid coefficients and a
# scale, modulating the color space's illuminant. Directions are sampled
# through an alias table over the texels by luminance: every texel covers
# the solid angle 4 pi / (W H), so a texel's pdf is pmf W H / (4 pi).

@dataclasses.dataclass
class EnvLight:
    """Device tables of an image infinite light."""
    texels: torch.Tensor      # (H*W, 4): [c0, c1, c2, scale]
    alias_rows: torch.Tensor  # (H*W, 4): [q, alias, pmf_self, pmf_alias]
    pmf: torch.Tensor         # (H*W,)
    illum: torch.Tensor       # (471,) the illuminant modulating the texels
    scale: float              # the light's scale (a float32 value)
    width: int
    height: int
    light_index: int          # its row in the light pool


def make_env_light(image_rgb, colorspace, scale=1.0, light_index=0,
                   device="cpu") -> EnvLight:
    """image_rgb (H, W, 3) linear RGB in the equal-area octahedral layout
    (utils/image_env.equalarea_from_latlong makes it from a lat-long map)
    -> the light's tables on device; host numpy as in the reference."""
    img = np.asarray(image_rgb, np.float32)
    h, w = img.shape[:2]
    flat = img.reshape(-1, 3)
    m = np.maximum(flat.max(axis=-1), 1e-9)
    tex_scale = np.where(flat.max(axis=-1) > 1.0, 2.0 * m, 1.0).astype(
        np.float32)
    coeffs = colorspace.to_spectrum_coeffs(flat / tex_scale[:, None])
    texels = np.concatenate([coeffs, tex_scale[:, None]], 1)
    lum = 0.2126 * flat[:, 0] + 0.7152 * flat[:, 1] + 0.0722 * flat[:, 2]
    lum = np.maximum(lum, 1e-9 * lum.max() if lum.max() > 0 else 1e-9)
    at = usamp.AliasTable.build(lum)
    alias_rows = np.concatenate([
        at.q[:, None], at.alias[:, None].astype(np.float32), at.pmf[:, None],
        at.pmf[at.alias][:, None]], 1)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                               device=device)
    return EnvLight(texels=t(texels), alias_rows=t(alias_rows), pmf=t(at.pmf),
                    illum=t(colorspace.illuminant_dense),
                    scale=float(np.float32(scale)), width=w, height=h,
                    light_index=light_index)


def _env_texel_radiance(env: EnvLight, texel_idx, lam):
    """Spectral radiance of texels texel_idx (N,) at lam (N, 4)."""
    rows = env.texels[texel_idx.to(torch.int64)]
    return pcolor.sigmoid_polynomial(
        rows[:, 0:1], rows[:, 1:2], rows[:, 2:3], lam) * rows[:, 3:4] * \
        spc.eval_dense(env.illum, lam) * env.scale


def env_radiance(env: EnvLight, d, lam):
    """Le of escaped rays d (N, 3): bilinear over the equal-area texels,
    the coefficients and scale interpolated, edges clamped (reference
    env_radiance)."""
    uv = vm.equal_area_sphere_to_square(d)
    ux = uv[:, 0] * env.width - 0.5
    uy = uv[:, 1] * env.height - 0.5
    x0 = torch.floor(ux)
    y0 = torch.floor(uy)
    fx = (ux - x0)[:, None]
    fy = (uy - y0)[:, None]
    xs = torch.clamp(torch.stack([x0, x0 + 1], -1), 0, env.width - 1)
    ys = torch.clamp(torch.stack([y0, y0 + 1], -1), 0, env.height - 1)
    idx = (ys[:, :, None] * env.width + xs[:, None, :]).to(torch.int64)
    rows = env.texels[idx]                       # (N, 2, 2, 4)
    c = (rows[:, 0, 0] * (1 - fx) * (1 - fy) + rows[:, 0, 1] * fx * (1 - fy)
         + rows[:, 1, 0] * (1 - fx) * fy + rows[:, 1, 1] * fx * fy)
    return pcolor.sigmoid_polynomial(
        c[:, 0:1], c[:, 1:2], c[:, 2:3], lam) * c[:, 3:4] * \
        spc.eval_dense(env.illum, lam) * env.scale


def env_sample_li(env: EnvLight, p_ref, u2, lam, scene_radius):
    """A direction toward the map: a texel from the alias table with
    u2[:, 0] (its remainder jitters x inside the texel), y jittered with
    u2[:, 1]. Returns (wi, L, solid-angle pdf, p_light)."""
    n = env.width * env.height
    up = u2[:, 0] * n
    i = torch.clamp(up.to(torch.int32), 0, n - 1)
    frac = up - i.to(torch.float32)
    rows = env.alias_rows[i.to(torch.int64)]
    take = frac < rows[:, 0]
    texel = torch.where(take, i, rows[:, 1].to(torch.int32))
    pmf = torch.where(take, rows[:, 2], rows[:, 3])
    u_in = torch.where(
        take, frac / torch.clamp(rows[:, 0], min=1e-9),
        (frac - rows[:, 0]) / torch.clamp(1.0 - rows[:, 0], min=1e-9))
    tx = (texel % env.width).to(torch.float32)
    ty = torch.div(texel, env.width, rounding_mode="floor").to(torch.float32)
    uv = torch.stack([(tx + torch.clamp(u_in, 0, 0.9999)) / env.width,
                      (ty + u2[:, 1]) / env.height], -1)
    wi = vm.equal_area_square_to_sphere(uv)
    pdf = pmf * float(np.float32(n / (4.0 * np.pi)))
    return (wi, _env_texel_radiance(env, texel, lam), pdf,
            p_ref + wi * (2.0 * scene_radius))


def env_pdf_li(env: EnvLight, d):
    """Solid-angle pdf of env_sample_li choosing direction d (N, 3), for
    MIS."""
    uv = vm.equal_area_sphere_to_square(d)
    x = torch.clamp((uv[:, 0] * env.width).to(torch.int64), 0, env.width - 1)
    y = torch.clamp((uv[:, 1] * env.height).to(torch.int64), 0,
                    env.height - 1)
    return env.pmf[y * env.width + x] * float(
        np.float32(env.width * env.height / (4.0 * np.pi)))
