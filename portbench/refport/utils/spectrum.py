"""Spectra (counterpart of pbrt_tpu/utils/spectrum.py), the subset the
ported paths use.

Host side (numpy, float64): the CIE tables, the dense / piecewise-linear
spectrum classes and the named-spectrum table (metals, glasses, standard
illuminants, read from pbrt_tpu/data/named_spectra.npz). Tensor side:
visible-wavelength sampling, dense-table lookups and the analytic CIE 1931
fits the default sensor evaluates.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from . import DATA_DIR

LAMBDA_MIN = 360.0
LAMBDA_MAX = 830.0
N_SPECTRUM_SAMPLES = 4
N_CIE = 471
CIE_Y_INTEGRAL = 106.856895

_DENSE_LAMBDA = np.arange(LAMBDA_MIN, LAMBDA_MAX + 1.0, 1.0, dtype=np.float64)


@functools.lru_cache(maxsize=1)
def cie_tables() -> np.ndarray:
    """(3, 471) float32 CIE 1931 X/Y/Z curves over [360, 830] nm."""
    d = np.load(DATA_DIR / "cie_xyz.npz")
    return np.stack([d["CIE_X"], d["CIE_Y"], d["CIE_Z"]]).astype(np.float32)


# ---------------------------------------------------------------------------
# Host-side spectra (scene construction)

class Spectrum:
    """Host spectrum: callable on wavelengths (nm, numpy) -> values."""

    def __call__(self, lam):
        raise NotImplementedError

    def to_dense(self) -> np.ndarray:
        """Bake to the standard 471-entry 1-nm float32 table."""
        return np.asarray(self(_DENSE_LAMBDA), np.float32)

    def inner_product(self, other: "Spectrum") -> float:
        return float(np.sum(self(_DENSE_LAMBDA) * other(_DENSE_LAMBDA)))

    def to_xyz(self) -> np.ndarray:
        t = cie_tables().astype(np.float64)
        v = self(_DENSE_LAMBDA)
        return np.array([np.sum(t[0] * v), np.sum(t[1] * v),
                         np.sum(t[2] * v)]) / CIE_Y_INTEGRAL

    def to_photometric(self) -> float:
        """Luminance: 683 * integral(Y * s)."""
        t = cie_tables().astype(np.float64)
        return float(683.0 * np.sum(t[1] * self(_DENSE_LAMBDA))
                     / CIE_Y_INTEGRAL)


class ConstantSpectrum(Spectrum):
    def __init__(self, c: float):
        self.c = float(c)

    def __call__(self, lam):
        return np.full_like(np.asarray(lam, np.float64), self.c)


class DenselySampledSpectrum(Spectrum):
    def __init__(self, values, lambda_min=LAMBDA_MIN):
        self.values = np.asarray(values, np.float64)
        self.lambda_min = float(lambda_min)

    def __call__(self, lam):
        lam = np.asarray(lam, np.float64)
        i = np.clip((lam - self.lambda_min).astype(np.int64), 0,
                    len(self.values) - 1)
        out = self.values[i]
        out[(lam < self.lambda_min)
            | (lam > self.lambda_min + len(self.values) - 1)] = 0.0
        return out


class PiecewiseLinearSpectrum(Spectrum):
    def __init__(self, lambdas, values):
        self.lambdas = np.asarray(lambdas, np.float64)
        self.values = np.asarray(values, np.float64)

    @staticmethod
    def from_interleaved(data, normalize=False):
        """[lam0, v0, lam1, v1, ...], clamp-extended to cover [360, 830];
        `normalize` scales to the CIE Y integral like the reference's
        illuminants."""
        data = np.asarray(data, np.float64)
        lam, v = data[0::2].copy(), data[1::2].copy()
        if lam[0] > LAMBDA_MIN:
            lam = np.concatenate([[LAMBDA_MIN - 1], lam])
            v = np.concatenate([[v[0]], v])
        if lam[-1] < LAMBDA_MAX:
            lam = np.concatenate([lam, [LAMBDA_MAX + 1]])
            v = np.concatenate([v, [v[-1]]])
        s = PiecewiseLinearSpectrum(lam, v)
        if normalize:
            cie_y = DenselySampledSpectrum(cie_tables()[1].astype(np.float64))
            s.values *= CIE_Y_INTEGRAL / s.inner_product(cie_y)
        return s

    def __call__(self, lam):
        return np.interp(np.asarray(lam, np.float64), self.lambdas,
                         self.values, left=0.0, right=0.0)


@functools.lru_cache(maxsize=1)
def named_spectra_raw() -> dict:
    """The named-spectrum table: key -> interleaved [lambda, value, ...]."""
    with np.load(DATA_DIR / "named_spectra.npz") as d:
        return {k: d[k] for k in d.files}


# pbrt's spectrum names -> the table's keys (reference _NAME_MAP)
_NAME_MAP = {
    "glass-BK7": "GlassBK7_eta", "glass-BAF10": "GlassBAF10_eta",
    "glass-FK51A": "GlassFK51A_eta", "glass-LASF9": "GlassLASF9_eta",
    "glass-F5": "GlassSF5_eta", "glass-F10": "GlassSF10_eta",
    "glass-F11": "GlassSF11_eta",
    "metal-Ag-eta": "Ag_eta", "metal-Ag-k": "Ag_k",
    "metal-Al-eta": "Al_eta", "metal-Al-k": "Al_k",
    "metal-Au-eta": "Au_eta", "metal-Au-k": "Au_k",
    "metal-Cu-eta": "Cu_eta", "metal-Cu-k": "Cu_k",
    "metal-CuZn-eta": "CuZn_eta", "metal-CuZn-k": "CuZn_k",
    "metal-MgO-eta": "MgO_eta", "metal-MgO-k": "MgO_k",
    "metal-TiO2-eta": "TiO2_eta", "metal-TiO2-k": "TiO2_k",
    "stdillum-A": "CIE_Illum_A", "stdillum-D50": "CIE_Illum_D5000",
    "stdillum-D65": "CIE_Illum_D6500",
    "illum-acesD60": "ACES_Illum_D60",
}
for _i in range(1, 13):
    _NAME_MAP[f"stdillum-F{_i}"] = f"CIE_Illum_F{_i}"


@functools.lru_cache(maxsize=128)
def get_named_spectrum(name: str):
    """A named spectrum (reference GetNamedSpectrum), or None for an unknown
    name; the illuminants ("stdillum-*", "illum-*") are normalized to the
    CIE Y integral."""
    raw = named_spectra_raw()
    key = _NAME_MAP.get(name)
    if key is None and name in raw:
        key = name
    if key is None or key not in raw:
        return None
    normalize = name.startswith("stdillum") or name.startswith("illum")
    return PiecewiseLinearSpectrum.from_interleaved(raw[key],
                                                    normalize=normalize)


def d65_spectrum() -> Spectrum:
    """CIE standard illuminant D65, the reference's "stdillum-D65"."""
    return get_named_spectrum("stdillum-D65")


# ---------------------------------------------------------------------------
# Tensor side

@dataclasses.dataclass
class SampledWavelengths:
    """4 wavelengths per lane and their pdfs, each (..., 4)."""
    lam: torch.Tensor
    pdf: torch.Tensor


def visible_wavelengths_pdf(lam: torch.Tensor) -> torch.Tensor:
    x = 0.0072 * (lam - 538.0)
    pdf = 0.0039398042 / (torch.cosh(x) ** 2)
    return torch.where((lam >= LAMBDA_MIN) & (lam <= LAMBDA_MAX), pdf, 0.0)


def sample_visible_wavelengths(u: torch.Tensor) -> SampledWavelengths:
    """Importance-sample 4 wavelengths ~ CIE visibility from one uniform
    (reference SampledWavelengths::SampleVisible)."""
    i = torch.arange(N_SPECTRUM_SAMPLES, dtype=torch.float32,
                     device=u.device)
    up = u[..., None] + i / N_SPECTRUM_SAMPLES
    up = torch.where(up > 1.0, up - 1.0, up)
    lam = 538.0 - 138.888889 * torch.atanh(0.85691062 - 1.82750197 * up)
    return SampledWavelengths(lam=lam, pdf=visible_wavelengths_pdf(lam))


def eval_dense(table: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """A dense 1-nm table over [LAMBDA_MIN, LAMBDA_MAX], (471,), linearly
    interpolated at lam (..., 4); 0 outside the range."""
    x = torch.clamp(lam - LAMBDA_MIN, 0.0, N_CIE - 1.000001)
    i0 = torch.clamp(torch.floor(x).to(torch.int64), 0, N_CIE - 2)
    frac = x - i0.to(torch.float32)
    out = table[i0] * (1.0 - frac) + table[i0 + 1] * frac
    return torch.where((lam >= LAMBDA_MIN) & (lam <= LAMBDA_MAX), out, 0.0)


def safe_div_spectrum(a, b):
    return torch.where(b != 0.0, a / torch.where(b == 0.0, 1.0, b), 0.0)


def _asym_gauss(x, mu, t1, t2):
    t = (x - mu) * torch.where(x < mu, t1, t2)
    return torch.exp(-0.5 * t * t)


def eval_cie_xyz_analytic(lam: torch.Tensor):
    """Analytic multi-lobe Gaussian fits of the CIE 1931 curves (Wyman,
    Sloan & Shirley 2013), the default sensor's response."""
    X = (0.362 * _asym_gauss(lam, 442.0, 0.0624, 0.0374)
         + 1.056 * _asym_gauss(lam, 599.8, 0.0264, 0.0323)
         - 0.065 * _asym_gauss(lam, 501.1, 0.0490, 0.0382))
    Y = (0.821 * _asym_gauss(lam, 568.8, 0.0213, 0.0247)
         + 0.286 * _asym_gauss(lam, 530.9, 0.0613, 0.0322))
    Z = (1.217 * _asym_gauss(lam, 437.0, 0.0845, 0.0278)
         + 0.681 * _asym_gauss(lam, 459.0, 0.0385, 0.0725))
    inside = (lam >= LAMBDA_MIN) & (lam <= LAMBDA_MAX)
    return (torch.where(inside, X, 0.0), torch.where(inside, Y, 0.0),
            torch.where(inside, Z, 0.0))
