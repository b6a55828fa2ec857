"""Sampling helpers (counterpart of pbrt_tpu/utils/sampling.py): the alias
table behind the power light sampler (host numpy) and the Henyey-Greenstein
phase function (tensors)."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .math import INV_4PI, PI, safe_sqrt, sqr
from .vecmath import coordinate_system


@dataclasses.dataclass(frozen=True)
class AliasTable:
    q: np.ndarray       # (n,) float32 acceptance thresholds
    alias: np.ndarray   # (n,) int32
    pmf: np.ndarray     # (n,) float32

    @staticmethod
    def build(weights) -> "AliasTable":
        """Vose's alias construction in float64, the reference's pop order."""
        w = np.asarray(weights, np.float64)
        n = len(w)
        total = w.sum()
        if total == 0:
            w = np.ones(n)
            total = n
        pmf = w / total
        scaled = pmf * n
        q = np.ones(n)
        alias = np.arange(n)
        small = [i for i in range(n) if scaled[i] < 1.0]
        large = [i for i in range(n) if scaled[i] >= 1.0]
        while small and large:
            s = small.pop()
            big = large.pop()
            q[s] = scaled[s]
            alias[s] = big
            scaled[big] = (scaled[big] + scaled[s]) - 1.0
            (small if scaled[big] < 1.0 else large).append(big)
        return AliasTable(q=q.astype(np.float32), alias=alias.astype(np.int32),
                          pmf=pmf.astype(np.float32))


def henyey_greenstein(cos_theta, g):
    """The Henyey-Greenstein phase function (reference media.h
    HGPhaseFunction), g clamped to [-0.99, 0.99]."""
    g = torch.clamp(g, -0.99, 0.99)
    denom = 1.0 + sqr(g) + 2.0 * g * cos_theta
    return INV_4PI * (1.0 - sqr(g)) / (denom * safe_sqrt(denom))


def sample_henyey_greenstein(u, g, wo):
    """A direction about wo (N, 3) from u (N, 2) with the Henyey-Greenstein
    lobe of asymmetry g (N,), uniform where |g| < 1e-3. Returns (wi,
    pdf)."""
    g = torch.clamp(g, -0.99, 0.99)
    g_nz = torch.where(torch.abs(g) < 1e-3,
                       torch.where(g < 0, -1e-3, 1e-3), g)
    s = (1.0 - sqr(g_nz)) / (1.0 + g_nz - 2.0 * g_nz * u[..., 0])
    cos_hg = -(1.0 + sqr(g_nz) - sqr(s)) / (2.0 * g_nz)
    cos_iso = 1.0 - 2.0 * u[..., 0]
    cos_theta = torch.where(torch.abs(g) < 1e-3, cos_iso, cos_hg)
    sin_theta = safe_sqrt(1.0 - sqr(cos_theta))
    phi = 2.0 * PI * u[..., 1]
    t1, t2 = coordinate_system(wo)
    wi = (sin_theta * torch.cos(phi))[..., None] * t1 + \
        (sin_theta * torch.sin(phi))[..., None] * t2 + \
        cos_theta[..., None] * wo
    return wi, henyey_greenstein(cos_theta, g)
