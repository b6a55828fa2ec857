"""4x4 transforms on the host in float64 (counterpart of
pbrt_tpu/utils/transform.py): the look-at camera transform and inverses."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Transform:
    m: np.ndarray       # (4, 4) float64
    m_inv: np.ndarray   # (4, 4) float64

    def inverse(self) -> "Transform":
        return Transform(m=self.m_inv, m_inv=self.m)


def identity() -> Transform:
    return Transform(m=np.eye(4), m_inv=np.eye(4))


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
    return Transform(m=c2w, m_inv=np.linalg.inv(c2w))
