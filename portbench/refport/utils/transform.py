"""4x4 transforms on the host (counterpart of pbrt_tpu/utils/transform.py):
look-at, translate, scale, rotate, matrices and their composition.

A Transform is a pair (m, m_inv) of float32 matrices, built in float64 and
stored in float32 as the reference stores them, and applied to (..., 3)
numpy arrays in float32, so the parser produces the reference's vertices
bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Transform:
    m: np.ndarray       # (4, 4) float32
    m_inv: np.ndarray   # (4, 4) float32

    def __matmul__(self, other: "Transform") -> "Transform":
        return Transform(m=self.m @ other.m, m_inv=other.m_inv @ self.m_inv)

    def inverse(self) -> "Transform":
        return Transform(m=self.m_inv, m_inv=self.m)

    def apply_point(self, p) -> np.ndarray:
        m = np.asarray(self.m, np.float32)
        p = np.asarray(p, np.float32)
        x = p @ m[:3, :3].T + m[:3, 3]
        w = p @ m[3, :3] + m[3, 3]
        return x / np.where(w[..., None] == 0, 1.0, w[..., None])

    def apply_vector(self, v) -> np.ndarray:
        return np.asarray(v, np.float32) @ \
            np.asarray(self.m, np.float32)[:3, :3].T

    def apply_normal(self, n) -> np.ndarray:
        """Normals transform by the inverse transpose."""
        return np.asarray(n, np.float32) @ \
            np.asarray(self.m_inv, np.float32)[:3, :3]

    def swaps_handedness(self) -> bool:
        return bool(np.linalg.det(np.asarray(self.m)[:3, :3]) < 0)


def identity() -> Transform:
    return Transform(m=np.eye(4, dtype=np.float32),
                     m_inv=np.eye(4, dtype=np.float32))


def from_matrix(m) -> Transform:
    m = np.asarray(m, np.float64).reshape(4, 4)
    return Transform(m=m.astype(np.float32),
                     m_inv=np.linalg.inv(m).astype(np.float32))


def translate(delta) -> Transform:
    d = np.asarray(delta, np.float64)
    m = np.eye(4)
    m[:3, 3] = d
    mi = np.eye(4)
    mi[:3, 3] = -d
    return Transform(m=m.astype(np.float32), m_inv=mi.astype(np.float32))


def scale(sx, sy=None, sz=None) -> Transform:
    if sy is None:
        sy = sz = sx
    m = np.diag([sx, sy, sz, 1.0])
    mi = np.diag([1.0 / sx, 1.0 / sy, 1.0 / sz, 1.0])
    return Transform(m=m.astype(np.float32), m_inv=mi.astype(np.float32))


def rotate(deg, axis) -> Transform:
    """Rotation by `deg` degrees about an arbitrary axis (reference
    transform.cpp Rotate)."""
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    s, c = np.sin(np.radians(deg)), np.cos(np.radians(deg))
    m = np.eye(4)
    m[0, 0] = a[0] * a[0] + (1 - a[0] * a[0]) * c
    m[0, 1] = a[0] * a[1] * (1 - c) - a[2] * s
    m[0, 2] = a[0] * a[2] * (1 - c) + a[1] * s
    m[1, 0] = a[0] * a[1] * (1 - c) + a[2] * s
    m[1, 1] = a[1] * a[1] + (1 - a[1] * a[1]) * c
    m[1, 2] = a[1] * a[2] * (1 - c) - a[0] * s
    m[2, 0] = a[0] * a[2] * (1 - c) - a[1] * s
    m[2, 1] = a[1] * a[2] * (1 - c) + a[0] * s
    m[2, 2] = a[2] * a[2] + (1 - a[2] * a[2]) * c
    return Transform(m=m.astype(np.float32), m_inv=m.T.astype(np.float32))


def look_at(eye, look, up) -> Transform:
    """Camera-to-world transform (reference transform.cpp LookAt)."""
    eye = np.asarray(eye, np.float64)
    look = np.asarray(look, np.float64)
    up = np.asarray(up, np.float64)
    dir_ = look - eye
    dir_ = dir_ / np.linalg.norm(dir_)
    right = np.cross(up / np.linalg.norm(up), dir_)
    nr = np.linalg.norm(right)
    if nr < 1e-10:
        raise ValueError("LookAt: up vector parallel to viewing direction")
    right /= nr
    new_up = np.cross(dir_, right)
    c2w = np.eye(4)
    c2w[:3, 0] = right
    c2w[:3, 1] = new_up
    c2w[:3, 2] = dir_
    c2w[:3, 3] = eye
    return Transform(m=c2w.astype(np.float32),
                     m_inv=np.linalg.inv(c2w).astype(np.float32))
