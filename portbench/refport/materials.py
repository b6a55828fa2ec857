"""Materials (counterpart of pbrt_tpu/materials.py): the material pool, the
diffuse material (its albedo packed as sigmoid-polynomial coefficients),
the conductor and the dielectric (eta and k spectra as rows of the scene's
spectrum pool); the hair material is not copied.

The pool keeps the reference's packed row layout, (M, 22):
[tag, albedo_coeffs(3), trans_coeffs(3), ur, vr, eta_const,
eta_spec_idx, k_spec_idx, albedo_tex, remap, rough_tex, bump_tex,
bump_scale, normal_tex, mix_other, mix_amount, coat_alpha, coat_eta],
so the two builders can be compared array for array. Diffuse, conductor
and dielectric materials are here, the diffuse reflectance also as
a texture (the albedo_tex column: a row of the scene's texture pool);
Mix resolution and bump or normal mapping are the identity on such a
pool.
"""
from __future__ import annotations

import numpy as np
import torch

from . import bxdfs
from . import lights as lgt
from . import textures as tex_mod
from .utils import color as pcolor
from .utils.color import sigmoid_polynomial

PACKED_COLS = 22


class MaterialBuilder:
    """Host-side accumulation of materials into pool rows."""

    def __init__(self, cs: pcolor.RGBColorSpace):
        self.cs = cs
        self.rows = []   # dicts of the packed columns

    def _add(self, **kw) -> int:
        row = dict(
            bxdf_tag=bxdfs.BXDF_DIFFUSE, albedo_coeffs=np.zeros(3, np.float32),
            trans_coeffs=np.zeros(3, np.float32), uroughness=0.0,
            vroughness=0.0, eta_const=1.5, eta_spec_idx=-1, k_spec_idx=-1,
            albedo_tex=-1, remap_roughness=True, rough_tex=-1, bump_tex=-1,
            bump_scale=1.0, normal_tex=-1, mix_other=-1, mix_amount=0.5,
            coat_alpha=0.0, coat_eta=1.5)
        row.update(kw)
        self.rows.append(row)
        return len(self.rows) - 1

    def add_diffuse(self, reflectance=(0.5, 0.5, 0.5), albedo_tex=-1) -> int:
        """Diffuse; albedo_tex: a texture-pool row that gives the
        reflectance instead (-1: the constant reflectance)."""
        return self._add(albedo_coeffs=self.cs.to_spectrum_coeffs(
            np.asarray(reflectance)), albedo_tex=albedo_tex)

    def add_conductor(self, eta_spec_idx=-1, k_spec_idx=-1, roughness=0.0,
                      uroughness=None, vroughness=None, remap=True) -> int:
        """Conductor (reference "conductor"): eta and k as spectrum-pool
        rows; uroughness and vroughness default to roughness; remap: the
        roughness is turned into alpha (sqrt) at shading."""
        return self._add(
            bxdf_tag=bxdfs.BXDF_CONDUCTOR, eta_spec_idx=eta_spec_idx,
            k_spec_idx=k_spec_idx,
            uroughness=roughness if uroughness is None else uroughness,
            vroughness=roughness if vroughness is None else vroughness,
            remap_roughness=remap)

    def add_dielectric(self, eta=1.5, roughness=0.0, uroughness=None,
                       vroughness=None, remap=True, eta_spec_idx=-1) -> int:
        """Dielectric (reference "dielectric" / "glass"): a constant eta,
        or a spectral one as a spectrum-pool row (dispersion)."""
        return self._add(
            bxdf_tag=bxdfs.BXDF_DIELECTRIC, eta_const=eta,
            eta_spec_idx=eta_spec_idx,
            uroughness=roughness if uroughness is None else uroughness,
            vroughness=roughness if vroughness is None else vroughness,
            remap_roughness=remap)

    def has_textures(self) -> bool:
        """A material reads its reflectance from a texture."""
        return any(r["albedo_tex"] >= 0 for r in self.rows)

    def tags(self) -> tuple:
        """The sorted set of BxDF tags in the pool."""
        return tuple(sorted({int(r["bxdf_tag"]) for r in self.rows})) or \
            (bxdfs.BXDF_DIFFUSE,)

    def packed(self) -> np.ndarray:
        """(M, 22) float32 pool rows (a default diffuse row if empty)."""
        if not self.rows:
            self.add_diffuse()

        def col(k):
            return np.stack([np.asarray(r[k]) for r in self.rows]) \
                .astype(np.float32).reshape(len(self.rows), -1)

        return np.concatenate([col(k) for k in (
            "bxdf_tag", "albedo_coeffs", "trans_coeffs", "uroughness",
            "vroughness", "eta_const", "eta_spec_idx", "k_spec_idx",
            "albedo_tex", "remap_roughness", "rough_tex", "bump_tex",
            "bump_scale", "normal_tex", "mix_other", "mix_amount",
            "coat_alpha", "coat_eta")], axis=1)

    def coeffs(self) -> np.ndarray:
        """(M, 3) float32 sigmoid coefficients (the pool's [:, 1:4])."""
        return self.packed()[:, 1:4]


def get_bsdf_params(pool: torch.Tensor, mat_idx, lam,
                    tags_present=(bxdfs.BXDF_DIFFUSE,),
                    uv=None, spectra_pool=None, spec_cache=None,
                    textures=None, footprint=None) -> bxdfs.BSDFParams:
    """Material rows (M, 22) at mat_idx (N,) and wavelengths (N, 4) ->
    per-lane BSDF parameters. tags_present: the pool's tag set
    (MaterialBuilder.tags); uv (N, 2): the hit's uv; spectra_pool (S, 471) and its per-wave
    cache (lights.eval_all_spectra): where a conductor or dielectric row
    names eta or k spectra. textures: the scene's texture pool when a row
    reads one (its albedo_tex column), evaluated at uv with the ray cone's
    uv footprint (N,) (textures.eval_texture). A diffuse-only pool reads
    the albedo alone."""
    rows = pool[mat_idx.to(torch.int64)]
    tag = rows[:, 0].round().to(torch.int32)
    albedo = sigmoid_polynomial(rows[:, 1:2], rows[:, 2:3], rows[:, 3:4], lam)
    if textures is not None:
        tex_idx = rows[:, 12].round().to(torch.int32)
        tc, tscale = tex_mod.eval_texture(textures, tex_idx, uv, footprint)
        tex_albedo = sigmoid_polynomial(tc[:, 0:1], tc[:, 1:2], tc[:, 2:3],
                                        lam) * tscale[:, None]
        albedo = torch.where((tex_idx >= 0)[:, None], tex_albedo, albedo)
    alpha_x = alpha_y = eta = k = h = None
    if set(tags_present) - {bxdfs.BXDF_DIFFUSE}:
        ur, vr = rows[:, 7], rows[:, 8]
        remap = rows[:, 13] > 0.5
        alpha_x = torch.where(remap, bxdfs.roughness_to_alpha(ur), ur)
        alpha_y = torch.where(remap, bxdfs.roughness_to_alpha(vr), vr)
        ones = torch.ones_like(lam)
        eta = rows[:, 9:10] * ones
        k = ones
        if bxdfs.BXDF_CONDUCTOR in tags_present or \
                bxdfs.BXDF_DIELECTRIC in tags_present:
            eidx = rows[:, 10].round()
            kidx = rows[:, 11].round()
            one = torch.ones_like(ur)
            eta = torch.where((eidx >= 0)[:, None], lgt.light_spectrum(
                spectra_pool, torch.clamp(eidx, min=0), one, lam, spec_cache),
                eta)
            k = torch.where((kidx >= 0)[:, None], lgt.light_spectrum(
                spectra_pool, torch.clamp(kidx, min=0), one, lam, spec_cache),
                k)
    return bxdfs.BSDFParams(tag=tag, albedo=albedo, alpha_x=alpha_x,
                            alpha_y=alpha_y, eta=eta, k=k, h=h,
                            tags_present=tuple(tags_present))
