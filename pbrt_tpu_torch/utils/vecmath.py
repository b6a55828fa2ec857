"""Vector helpers on (..., 3) tensors (counterpart of
pbrt_tpu/utils/vecmath.py), the subset the general path wave uses."""
from __future__ import annotations

import torch


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + \
        a[..., 2] * b[..., 2]


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]],
                       dim=-1)


def length_squared(v):
    return dot(v, v)


def length(v):
    return torch.sqrt(length_squared(v))


def normalize(v):
    return v / torch.clamp(length(v), min=1e-20)[..., None]


def coordinate_system(v):
    """Branchless orthonormal basis (Duff et al. 2017): (t, b) such that
    (t, b, v) is an orthonormal frame."""
    z = v[..., 2]
    sign = torch.where(z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + z)
    b = v[..., 0] * v[..., 1] * a
    t1 = torch.stack([1.0 + sign * (v[..., 0] * v[..., 0]) * a, sign * b,
                      -sign * v[..., 0]], dim=-1)
    t2 = torch.stack([b, sign + (v[..., 1] * v[..., 1]) * a, -v[..., 1]],
                     dim=-1)
    return t1, t2
