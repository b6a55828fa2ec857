"""Participating media (counterpart of pbrt_tpu/media.py): the homogeneous
and the uniform-grid medium, and the scene's majorant super-grid.

Media live in a descriptor pool (M, 24) and one flat density array, in the
reference's layouts:
[0] tag, [1:4] sigma_a coefficients, [4] sigma_a scale, [5:8] sigma_s
coefficients, [8] sigma_s scale, [9] g, [10] the scalar majorant, [11] the
grid's offset in the density array, [12:15] nx, ny, nz, [15:18] the box's
low corner, [18:21] its high corner, [21] the density scale, [22] the Le
scale, [23] the spectral peak of sigma_t (density 1).
A medium is an axis-aligned world box. Free flights are delta-tracked by a
3D DDA over one majorant super-grid that covers every medium box; each cell
holds a scalar majorant, at least sigma_t's largest value over the
wavelengths, the media and the cell (the grid media dilated by a voxel, for
the trilinear lookup's support), so the majorant cancels from the
estimator's ratios (integrators/volpath.py). The builder is host numpy and
its tables are the reference's, array for array. The RGB-grid and cloud
media are not ported (ROADMAP.md item 13); the pool has no emissive medium.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .utils import color as pcolor

MEDIUM_HOMOGENEOUS = 0
MEDIUM_GRID = 1
MED_COLS = 24


@dataclasses.dataclass
class MediumPool:
    """Device tables: desc (M, 24), grid (G,) the densities, maj_grid
    (mz*my*mx,) the super-grid's majorants, maj_lo and maj_hi (3,) its
    box; host: maj_res (mx, my, mz), max_majorant."""
    desc: torch.Tensor
    grid: torch.Tensor
    maj_grid: torch.Tensor
    maj_lo: torch.Tensor
    maj_hi: torch.Tensor
    maj_res: tuple = (1, 1, 1)
    max_majorant: float = 0.0


class MediumBuilder:
    """Host-side medium pool (reference MediumBuilder: add_homogeneous,
    add_grid, build)."""

    def __init__(self, colorspace=None):
        self.cs = colorspace or pcolor.srgb()
        self.rows = []
        self.grid = [np.zeros(1, np.float32)]
        self.grid_size = 1
        self._densities = {}   # medium index -> its (nz, ny, nx) densities

    def _sigma_coeffs(self, rgb, scale):
        """An rgb coefficient's sigmoid fit, its scale, and the fitted
        spectrum's peak (the majorant bounds the fit, not the rgb)."""
        rgb = np.asarray(rgb, np.float64) * scale
        m = max(float(np.max(rgb)), 1e-9)
        s = 2.0 * m if m > 1.0 else 1.0
        c = np.asarray(self.cs.to_spectrum_coeffs(np.clip(rgb / s, 0, 1)),
                       np.float32)
        return c, np.float32(s), pcolor.sigmoid_poly_max_value(c) * float(s)

    def _row(self, tag, sigma_a, sigma_s, g, scale, bounds_lo, bounds_hi):
        ca, sa, max_a = self._sigma_coeffs(sigma_a, scale)
        cs_, ss, max_s = self._sigma_coeffs(sigma_s, scale)
        row = np.zeros(MED_COLS, np.float32)
        row[0] = tag
        row[1:4] = ca
        row[4] = sa
        row[5:8] = cs_
        row[8] = ss
        row[9] = g
        row[15:18] = np.asarray(bounds_lo, np.float32)
        row[18:21] = np.asarray(bounds_hi, np.float32)
        row[21] = 1.0
        row[23] = max_a + max_s
        return row, max_a + max_s

    def add_homogeneous(self, sigma_a=(1.0,) * 3, sigma_s=(1.0,) * 3,
                        g=0.0, scale=1.0, bounds_lo=(-1e5,) * 3,
                        bounds_hi=(1e5,) * 3) -> int:
        """A homogeneous medium inside its world box (a scene-wide fog: a
        box around the scene)."""
        row, peak = self._row(MEDIUM_HOMOGENEOUS, sigma_a, sigma_s, g, scale,
                              bounds_lo, bounds_hi)
        row[10] = peak
        self.rows.append(row)
        return len(self.rows) - 1

    def add_grid(self, density, bounds_lo, bounds_hi, sigma_a=(1.0,) * 3,
                 sigma_s=(1.0,) * 3, g=0.0, scale=1.0) -> int:
        """A grid medium: density (nz, ny, nx), trilinear over the box."""
        density = np.asarray(density, np.float32)
        nz, ny, nx = density.shape
        row, peak = self._row(MEDIUM_GRID, sigma_a, sigma_s, g, scale,
                              bounds_lo, bounds_hi)
        row[10] = peak * float(density.max())
        row[11] = self.grid_size
        row[12:15] = (nx, ny, nz)
        self.grid.append(density.reshape(-1))
        self.grid_size += density.size
        self._densities[len(self.rows)] = density
        self.rows.append(row)
        return len(self.rows) - 1

    def build(self, device, maj_res=None) -> MediumPool:
        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                   device=device)
        if not self.rows:
            one = np.ones(3, np.float32)
            return MediumPool(desc=t(np.zeros((1, MED_COLS))),
                              grid=t(np.zeros(1)), maj_grid=t(np.zeros(1)),
                              maj_lo=t(-one), maj_hi=t(one))
        desc = np.stack(self.rows)
        maj, lo, hi, res = self.majorant_supergrid(desc, maj_res)
        return MediumPool(desc=t(desc), grid=t(np.concatenate(self.grid)),
                          maj_grid=t(maj.reshape(-1)), maj_lo=t(lo),
                          maj_hi=t(hi), maj_res=res,
                          max_majorant=float(desc[:, 10].max()))

    def majorant_supergrid(self, desc, maj_res=None):
        """The scene's scalar majorant grid (reference
        _build_majorant_supergrid): a cell holds the largest sigma_t peak
        times density of the media over it, a grid medium's densities
        dilated by one voxel and resampled nearest-voxel to at least twice
        the super-grid's resolution inside its box, so that every cell the
        box overlaps gets a sample. Returns (maj (mz, my, mx), lo, hi,
        (mx, my, mz))."""
        lo = desc[:, 15:18].min(axis=0).astype(np.float32)
        hi = desc[:, 18:21].max(axis=0).astype(np.float32)
        ext = np.maximum(hi - lo, 1e-6)
        if maj_res is None:
            n = 64 if self._densities else 8
            longest = float(ext.max())
            res = tuple(max(1, int(round(n * float(e) / longest)))
                        for e in ext)
        else:
            res = tuple(maj_res)
        mx, my, mz = res
        maj = np.zeros((mz, my, mx), np.float32)
        cell = ext / np.asarray([mx, my, mz], np.float32)
        for i, row in enumerate(desc):
            blo, bhi = row[15:18], row[18:21]
            c0 = np.clip(np.floor((blo - lo) / cell).astype(int), 0,
                         [mx - 1, my - 1, mz - 1])
            c1 = np.clip(np.ceil((bhi - lo) / cell).astype(int), 1,
                         [mx, my, mz])
            peak = float(row[23]) * float(row[21])
            if i not in self._densities:
                box = maj[c0[2]:c1[2], c0[1]:c1[1], c0[0]:c1[0]]
                box[...] = np.maximum(box, peak)
                continue
            dens = self._densities[i]
            dil = dens
            for ax in range(3):
                pads = [(0, 0)] * 3
                pads[ax] = (1, 1)
                ap = np.pad(dil, pads, mode="edge")
                out = dil
                for off in (0, 2):
                    sl = [slice(None)] * 3
                    sl[ax] = slice(off, off + dil.shape[ax])
                    out = np.maximum(out, ap[tuple(sl)])
                dil = out
            nz, ny, nx = dens.shape
            bext = np.maximum(bhi - blo, 1e-9)
            span = np.maximum(c1 - c0, 1)
            f = [max(n, 2 * int(s)) for n, s in zip((nz, ny, nx),
                                                    (span[2], span[1],
                                                     span[0]))]
            iz, iy, ix = (np.minimum((np.arange(fk) + 0.5) * nk / fk,
                                     nk - 1).astype(int)
                          for fk, nk in zip(f, (nz, ny, nx)))
            fine = dil[np.ix_(iz, iy, ix)]
            wz, wy, wx = (blo[k] + (np.arange(f[2 - k]) + 0.5) / f[2 - k]
                          * bext[k] for k in (2, 1, 0))
            sz = np.clip(((wz - lo[2]) / cell[2]).astype(int), 0, mz - 1)
            sy = np.clip(((wy - lo[1]) / cell[1]).astype(int), 0, my - 1)
            sx = np.clip(((wx - lo[0]) / cell[0]).astype(int), 0, mx - 1)
            flat = ((sz[:, None, None] * my + sy[None, :, None]) * mx
                    + sx[None, None, :])
            np.maximum.at(maj.reshape(-1), flat.reshape(-1),
                          (fine * peak).reshape(-1))
        return maj, lo, hi, res


def medium_row(pool: MediumPool, med_idx):
    """Descriptor rows (N, 24) of medium indices (N,) (-1 reads row 0)."""
    return pool.desc[torch.clamp(med_idx, min=0).to(torch.int64)]


def density_at(pool: MediumPool, row, p):
    """Trilinear density of each row's grid at world points p (N, 3), 0
    outside the box, times the density scale; 1 for a homogeneous row."""
    lo, hi, n = row[:, 15:18], row[:, 18:21], row[:, 12:15]
    g = (p - lo) / torch.clamp(hi - lo, min=1e-9) * n - 0.5
    g0 = torch.floor(g)
    frac = g - g0
    top = torch.clamp(n - 1.0, min=0.0)

    def corner(k):
        return torch.stack([torch.minimum(torch.clamp(g0[:, k] + o, min=0.0),
                                          top[:, k]) for o in (0, 1)], -1)
    xs, ys, zs = corner(0), corner(1), corner(2)
    nx = n[:, 0]
    nxy = n[:, 0] * n[:, 1]
    idx = (row[:, 11, None, None, None] + zs[:, :, None, None]
           * nxy[:, None, None, None] + ys[:, None, :, None]
           * nx[:, None, None, None] + xs[:, None, None, :])
    # a lane whose point is not finite (no event there) reads voxel 0
    idx = torch.clamp(torch.nan_to_num(idx, nan=0.0), 0,
                      pool.grid.shape[0] - 1)
    d = pool.grid[idx.to(torch.int64)]                    # (N, 2, 2, 2)
    fx, fy, fz = frac[:, 0], frac[:, 1], frac[:, 2]
    dx0 = d[:, :, :, 0] * (1 - fx)[:, None, None] + \
        d[:, :, :, 1] * fx[:, None, None]
    dy0 = dx0[:, :, 0] * (1 - fy)[:, None] + dx0[:, :, 1] * fy[:, None]
    dens = dy0[:, 0] * (1 - fz) + dy0[:, 1] * fz
    inside = ((p >= lo) & (p <= hi)).all(dim=-1)
    dens = torch.where(inside, dens, 0.0) * row[:, 21]
    return torch.where(row[:, 0].round() == MEDIUM_HOMOGENEOUS, 1.0, dens)


def sigma_at(pool: MediumPool, row, p, lam):
    """(sigma_a, sigma_s), each (N, 4), at world points p and wavelengths
    lam (N, 4)."""
    dens = density_at(pool, row, p)[:, None]

    def spectrum(c0):
        return pcolor.sigmoid_polynomial(
            row[:, c0:c0 + 1], row[:, c0 + 1:c0 + 2], row[:, c0 + 2:c0 + 3],
            lam) * row[:, c0 + 3:c0 + 4] * dens
    return spectrum(1), spectrum(5)


def le_at(pool: MediumPool, row, p, lam):
    """Volumetric emission (N, 4): zero, as no ported medium emits (the
    reference's comes from the RGB grid's Le voxels)."""
    return torch.zeros_like(lam)


def majorant(row):
    """The rows' scalar majorants (N,)."""
    return row[:, 10]


def hg_g(row):
    """The rows' Henyey-Greenstein asymmetry (N,)."""
    return row[:, 9]
