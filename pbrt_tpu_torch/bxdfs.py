"""BxDFs in the local shading frame (counterpart of pbrt_tpu/bxdfs.py): the
diffuse lobe, the only one the ported slices use.

Conventions follow the reference: wo, wi in shading space with n = (0, 0,
1), both pointing away from the surface; f holds no cosine; pdfs are
solid angle; spectral values are (N, 4). The dispatchers take the static
set of tags present in the scene (`BSDFParams.tags_present`) and raise for
any tag but BXDF_DIFFUSE.
"""
from __future__ import annotations

import dataclasses

import torch

from .utils.math import INV_PI, PI, safe_div

BXDF_DIFFUSE = 0     # the reference's tag


@dataclasses.dataclass
class BSDFParams:
    """Per-lane BSDF parameters after material evaluation."""
    tag: torch.Tensor        # (N,) int
    albedo: torch.Tensor     # (N, 4) reflectance at the lane's wavelengths
    tags_present: tuple = (BXDF_DIFFUSE,)


def _check(p: BSDFParams):
    other = [t for t in p.tags_present if t != BXDF_DIFFUSE]
    if other:
        raise NotImplementedError(
            f"BxDF tags {other}: only the diffuse lobe is ported (ROADMAP.md "
            "slice 3: conductor and dielectric with envlit, the rough "
            "dielectric with killeroo/plytex, coated diffuse and the BSSRDF "
            "with the machines frame)")


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


def bsdf_f(p: BSDFParams, wo, wi):
    """f(wo, wi), (N, 4)."""
    _check(p)
    return _diffuse_f_pdf(p, wo, wi)[0]


def bsdf_pdf(p: BSDFParams, wo, wi):
    """Solid-angle pdf of sampling wi, (N,)."""
    _check(p)
    return _diffuse_f_pdf(p, wo, wi)[1]


def bsdf_sample(p: BSDFParams, wo, u2):
    """Sample wi from the lobe with u2 (N, 2). Returns dict(wi, f, pdf,
    valid, specular). The diffuse lobe draws no uc (the reference's
    one-dimensional lobe choice)."""
    _check(p)
    wi = torch.stack(sample_cosine_hemisphere(u2[:, 0], u2[:, 1]), dim=-1)
    wi = torch.where((wo[..., 2] < 0)[..., None],
                     torch.cat([wi[..., :2], -wi[..., 2:]], dim=-1), wi)
    f, pdf = _diffuse_f_pdf(p, wo, wi)
    return dict(wi=wi, f=f, pdf=torch.clamp(pdf, min=0.0), valid=pdf > 0,
                specular=torch.zeros_like(pdf, dtype=torch.bool))
