"""Lights (counterpart of pbrt_tpu/lights.py): area-triangle lights.

The packed light row keeps the reference layout, (L, 24):
[tag, p(3), dir(3), spec_idx, scale, tri, two_sided, cfs, cfe, is_delta,
pmf, tri_verts(9)], so the two builders can be compared array for array.
"""
from __future__ import annotations

import numpy as np
import torch

from .utils import spectrum as spc

LIGHT_AREA_TRI = 3   # the reference's tag
PACKED_COLS = 24


def compute_light_power(tag, scale, spectrum: spc.Spectrum, area,
                        two_sided=False) -> float:
    """Emitted power of an area triangle (reference compute_light_power)."""
    if tag != LIGHT_AREA_TRI:
        raise NotImplementedError(
            f"light tag {tag}: only area triangles are ported (ROADMAP.md, "
            "slice 3)")
    lum = scale * spectrum.to_photometric()
    return (2 if two_sided else 1) * np.pi * area * lum


def pack_area_lights(rows, p0, p1, p2, pmf) -> np.ndarray:
    """Light row dicts (tag, spec_idx, scale, tri, two_sided) -> the
    (L, 24) float32 packed pool with each light's triangle inlined."""
    out = np.zeros((len(rows), PACKED_COLS), np.float32)
    for i, r in enumerate(rows):
        t = int(r["tri"])
        out[i, 0] = r["tag"]
        out[i, 7] = r["spec_idx"]
        out[i, 8] = r["scale"]
        out[i, 9] = t
        out[i, 10] = float(r["two_sided"])
        out[i, 11] = 1.0   # cfs, cfe: unused by area lights
        out[i, 12] = 1.0
        out[i, 14] = pmf[i]
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
