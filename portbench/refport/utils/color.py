"""Color spaces and RGB -> spectrum conversion (counterpart of
pbrt_tpu/utils/color.py), the subset the ported paths use.

RGB reflectances become Jakob-Hanika sigmoid polynomials through the same
precomputed coefficient table the reference reads (rgb2spec_srgb.npz).
Host side is numpy; ``sigmoid_polynomial``, ``linear_to_srgb`` and
``srgb_to_linear`` work on tensors.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import DATA_DIR
from . import spectrum as spc


def _xyz_from_xy(x, y):
    return np.array([x / y, 1.0, (1.0 - x - y) / y], np.float64)


def rgb_to_xyz_matrix(r_xy, g_xy, b_xy, w_xy):
    R = _xyz_from_xy(*r_xy)
    G = _xyz_from_xy(*g_xy)
    B = _xyz_from_xy(*b_xy)
    W = _xyz_from_xy(*w_xy)
    M = np.stack([R, G, B], axis=1)
    return M * np.linalg.solve(M, W)[None, :]


class RGBToSpectrumTable:
    """res^3 sigmoid-coefficient table sliced by the largest component."""

    def __init__(self, coeffs: np.ndarray):
        self.coeffs = np.asarray(coeffs, np.float32)  # (3, res, res, res, 3)
        self.res = self.coeffs.shape[1]

    @staticmethod
    @functools.lru_cache(maxsize=4)
    def load(name: str) -> "RGBToSpectrumTable":
        return RGBToSpectrumTable(
            np.load(DATA_DIR / f"rgb2spec_{name}.npz")["coeffs"])

    def lookup(self, rgb) -> np.ndarray:
        """rgb (..., 3) in [0, 1] -> coefficients (..., 3), trilinear."""
        rgb = np.asarray(rgb, np.float32)
        shape = rgb.shape[:-1]
        rgb = rgb.reshape(-1, 3)
        n = np.arange(len(rgb))
        maxc = np.argmax(rgb, axis=-1)
        z = rgb[n, maxc]
        x = rgb[n, (maxc + 1) % 3] / np.maximum(z, 1e-9)
        y = rgb[n, (maxc + 2) % 3] / np.maximum(z, 1e-9)
        res = self.res
        xf = np.clip(x, 0, 1) * (res - 1)
        yf = np.clip(y, 0, 1) * (res - 1)
        zf = np.clip(z, 0, 1) * (res - 1)
        xi = np.minimum(xf.astype(np.int32), res - 2)
        yi = np.minimum(yf.astype(np.int32), res - 2)
        zi = np.minimum(zf.astype(np.int32), res - 2)
        dx, dy, dz = xf - xi, yf - yi, zf - zi
        c = np.zeros((len(rgb), 3), np.float32)
        for ddz, wz in ((0, 1 - dz), (1, dz)):
            for ddy, wy in ((0, 1 - dy), (1, dy)):
                for ddx, wx in ((0, 1 - dx), (1, dx)):
                    c += (wz * wy * wx)[:, None] * \
                        self.coeffs[maxc, zi + ddz, yi + ddy, xi + ddx]
        # black: the constant-zero spectrum
        out = np.where((z == 0.0)[:, None],
                       np.array([0, 0, -1e8], np.float32), c)
        return out.reshape(*shape, 3)


class RGBColorSpace:
    """Primaries + whitepoint + illuminant + spectrum table."""

    def __init__(self, name, r, g, b, illuminant: spc.Spectrum):
        self.name = name
        self.illuminant = illuminant
        W = illuminant.to_xyz()
        self.w_xy = (W[0] / W.sum(), W[1] / W.sum())
        self.xyz_from_rgb = rgb_to_xyz_matrix(r, g, b, self.w_xy)
        self.rgb_from_xyz = np.linalg.inv(self.xyz_from_rgb)

    @functools.cached_property
    def spectrum_table(self) -> RGBToSpectrumTable:
        return RGBToSpectrumTable.load(self.name)

    def to_spectrum_coeffs(self, rgb) -> np.ndarray:
        return self.spectrum_table.lookup(np.asarray(rgb, np.float32))

    @functools.cached_property
    def illuminant_dense(self) -> np.ndarray:
        """The illuminant baked to the 471-entry 1-nm float32 table."""
        return self.illuminant.to_dense()


@functools.lru_cache(maxsize=1)
def srgb() -> RGBColorSpace:
    return RGBColorSpace("srgb", (0.64, 0.33), (0.30, 0.60), (0.15, 0.06),
                         spc.d65_spectrum())


class RGBAlbedoSpectrum(spc.Spectrum):
    """Reflectance in [0, 1] as a sigmoid polynomial."""

    def __init__(self, rgb, cs: RGBColorSpace = None):
        cs = cs or srgb()
        self.coeffs = np.asarray(cs.to_spectrum_coeffs(np.asarray(rgb)),
                                 np.float64)

    def __call__(self, lam):
        lam = np.asarray(lam, np.float64)
        x = (self.coeffs[0] * lam + self.coeffs[1]) * lam + self.coeffs[2]
        return 0.5 + x / (2.0 * np.sqrt(1.0 + x * x))


class RGBUnboundedSpectrum(spc.Spectrum):
    """RGB with components above one: scaled to max 0.5, scale folded back."""

    def __init__(self, rgb, cs: RGBColorSpace = None):
        rgb = np.asarray(rgb, np.float64)
        self.scale = 2.0 * max(float(rgb.max()), 1e-9)
        self.albedo = RGBAlbedoSpectrum(rgb / self.scale, cs)

    def __call__(self, lam):
        return self.scale * self.albedo(lam)


class RGBIlluminantSpectrum(spc.Spectrum):
    """Emission: an RGB-shaped modulation of the color space's illuminant."""

    def __init__(self, rgb, cs: RGBColorSpace = None):
        cs = cs or srgb()
        self.unbounded = RGBUnboundedSpectrum(rgb, cs)
        self.illum = cs.illuminant

    def __call__(self, lam):
        return self.unbounded(lam) * self.illum(lam)


def sigmoid_polynomial(c0, c1, c2, lam):
    """Reflectance at wavelengths lam (nm) of the sigmoid polynomial with
    coefficients c0, c1, c2, broadcast together (reference
    RGBSigmoidPolynomial)."""
    x = (c0 * lam + c1) * lam + c2
    s = 0.5 + x / (2.0 * torch.sqrt(1.0 + x * x))
    return torch.where(torch.isinf(x), torch.where(x > 0, 1.0, 0.0), s)


def linear_to_srgb(x: torch.Tensor) -> torch.Tensor:
    x = torch.clamp(x, 0.0, 1.0)
    return torch.where(x <= 0.0031308, 12.92 * x,
                       1.055 * torch.pow(x, 1.0 / 2.4) - 0.055)


def srgb_to_linear(x: torch.Tensor) -> torch.Tensor:
    """The sRGB decoding curve (pbrt-v4 SRGBToLinear)."""
    x = torch.clamp(x, 0.0, 1.0)
    return torch.where(x <= 0.04045, x / 12.92,
                       torch.pow((x + 0.055) / 1.055, 2.4))


def sigmoid_poly_max_value(coeffs) -> float:
    """Largest value over [360, 830] nm of the sigmoid polynomial with
    coefficients (3,) (reference sigmoid_poly_max_value): the ends and the
    polynomial's extremum where it lies inside, in float32."""
    c = torch.as_tensor(np.asarray(coeffs, np.float32))
    c0, c1, c2 = c[0], c[1], c[2]

    def at(lam):
        return sigmoid_polynomial(c0, c1, c2, lam)
    result = torch.maximum(at(torch.tensor(360.0)), at(torch.tensor(830.0)))
    lam_ext = -c1 / (2.0 * torch.where(c0 == 0, 1.0, c0))
    if c0 != 0 and 360.0 < lam_ext < 830.0:
        result = torch.maximum(result, at(lam_ext))
    return float(result)
