"""Materials (counterpart of pbrt_tpu/materials.py): diffuse only, its
albedo packed as sigmoid-polynomial coefficients."""
from __future__ import annotations

import numpy as np

from .utils import color as pcolor


class MaterialBuilder:
    """Host-side accumulation of diffuse materials."""

    def __init__(self, cs: pcolor.RGBColorSpace):
        self.cs = cs
        self.rows = []   # (3,) albedo coefficients per material

    def add_diffuse(self, reflectance=(0.5, 0.5, 0.5)) -> int:
        self.rows.append(self.cs.to_spectrum_coeffs(np.asarray(reflectance)))
        return len(self.rows) - 1

    def coeffs(self) -> np.ndarray:
        """(M, 3) float32 sigmoid coefficients (the reference pool's
        packed[:, 1:4])."""
        return np.stack(self.rows).astype(np.float32)
