"""Sobol' sampling and Owen scrambling (counterpart of
pbrt_tpu/utils/lowdiscrepancy.py).

u32 values are int64 tensors in [0, 2^32) (see utils/rng.py). Bit-exact
with the reference.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import DATA_DIR
from .rng import MASK32, mul32, reverse_bits_32

N_SOBOL_DIMENSIONS = 1024
SOBOL_MATRIX_SIZE = 52
ONE_MINUS_EPSILON = float(np.nextafter(np.float32(1.0), np.float32(0.0)))


@functools.lru_cache(maxsize=1)
def sobol_matrices() -> np.ndarray:
    """(1024, 52) uint32 generator matrices (columns MSB-first)."""
    d = np.load(DATA_DIR / "sobolmatrices.npz")
    return d["SobolMatrices32"].reshape(N_SOBOL_DIMENSIONS, SOBOL_MATRIX_SIZE)


@functools.lru_cache(maxsize=16)
def _byte_tables(dimension: int) -> np.ndarray:
    """(4, 256) int64: table[k][b] = xor of the columns 8k+i whose bit i is
    set in b, so the 32-step matrix product becomes four lookups."""
    cols = sobol_matrices()[dimension][:32].astype(np.int64)
    out = np.zeros((4, 256), np.int64)
    for k in range(4):
        for b in range(256):
            v = 0
            for i in range(8):
                if (b >> i) & 1:
                    v ^= int(cols[8 * k + i])
            out[k, b] = v
    return out


@functools.lru_cache(maxsize=64)
def _byte_tables_on(dimension: int, device: torch.device) -> torch.Tensor:
    """_byte_tables(dimension) on device, uploaded once."""
    return torch.as_tensor(_byte_tables(dimension), device=device)


def sobol_sample_u32(a: torch.Tensor, dimension: int) -> torch.Tensor:
    """Raw 32-bit Sobol' value of index a (reference sobol_sample_u32)."""
    t = _byte_tables_on(int(dimension), a.device)
    return (t[0][a & 255] ^ t[1][(a >> 8) & 255] ^ t[2][(a >> 16) & 255]
            ^ t[3][(a >> 24) & 255])


def fast_owen_scramble(v, seed):
    """Laine-Karras hash Owen scramble (reference fast_owen_scramble)."""
    v = reverse_bits_32(v)
    v = v ^ mul32(v, 0x3D20ADEA)
    v = (v + seed) & MASK32
    v = mul32(v, (seed >> 16) | 1)
    v = v ^ mul32(v, 0x05526C56)
    v = v ^ mul32(v, 0x53A22864)
    return reverse_bits_32(v)


def u32_to_sample(v: torch.Tensor) -> torch.Tensor:
    """u32 -> float32 in [0, 1): round-to-nearest conversion, * 2^-32,
    clamped below one (reference u32_to_sample)."""
    f = v.to(torch.float32) * (2.0 ** -32)
    return torch.clamp(f, max=ONE_MINUS_EPSILON)
