"""Materials (counterpart of pbrt_tpu/materials.py): the material pool and
the diffuse material, its albedo packed as sigmoid-polynomial
coefficients.

The pool keeps the reference's packed row layout, (M, 22):
[tag, albedo_coeffs(3), trans_coeffs(3), ur, vr, eta_const,
eta_spec_idx, k_spec_idx, albedo_tex, remap, rough_tex, bump_tex,
bump_scale, normal_tex, mix_other, mix_amount, coat_alpha, coat_eta],
so the two builders can be compared array for array. Only the diffuse
material without textures is ported: `get_bsdf_params` reads the tag and
the albedo coefficients; Mix resolution and bump or normal mapping are the
identity on such a pool.
"""
from __future__ import annotations

import numpy as np
import torch

from . import bxdfs
from .utils import color as pcolor

PACKED_COLS = 22


class MaterialBuilder:
    """Host-side accumulation of materials into pool rows."""

    def __init__(self, cs: pcolor.RGBColorSpace):
        self.cs = cs
        self.rows = []   # dicts of the packed columns

    def add_diffuse(self, reflectance=(0.5, 0.5, 0.5)) -> int:
        self.rows.append(dict(
            bxdf_tag=bxdfs.BXDF_DIFFUSE,
            albedo_coeffs=self.cs.to_spectrum_coeffs(np.asarray(reflectance)),
            trans_coeffs=np.zeros(3, np.float32), uroughness=0.0,
            vroughness=0.0, eta_const=1.5, eta_spec_idx=-1, k_spec_idx=-1,
            albedo_tex=-1, remap_roughness=True, rough_tex=-1, bump_tex=-1,
            bump_scale=1.0, normal_tex=-1, mix_other=-1, mix_amount=0.5,
            coat_alpha=0.0, coat_eta=1.5))
        return len(self.rows) - 1

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


def sigmoid_polynomial(c0, c1, c2, lam):
    """Reflectance at wavelengths lam (nm) of the sigmoid polynomial with
    coefficients c0, c1, c2, broadcast together (reference
    RGBSigmoidPolynomial)."""
    x = (c0 * lam + c1) * lam + c2
    s = 0.5 + x / (2.0 * torch.sqrt(1.0 + x * x))
    return torch.where(torch.isinf(x), torch.where(x > 0, 1.0, 0.0), s)


def get_bsdf_params(pool: torch.Tensor, mat_idx, lam,
                    tags_present=(bxdfs.BXDF_DIFFUSE,)) -> bxdfs.BSDFParams:
    """Material rows (M, 22) at mat_idx (N,) and wavelengths (N, 4) ->
    per-lane BSDF parameters."""
    rows = pool[mat_idx.to(torch.int64)]
    return bxdfs.BSDFParams(tag=rows[:, 0].round().to(torch.int32),
                            albedo=sigmoid_polynomial(
                                rows[:, 1:2], rows[:, 2:3], rows[:, 3:4],
                                lam),
                            tags_present=tuple(tags_present))
