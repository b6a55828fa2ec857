"""Vector helpers on (..., 3) tensors (counterpart of
pbrt_tpu/utils/vecmath.py), the subset the ported paths use."""
from __future__ import annotations

import torch

from .math import PI


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


def absdot(a, b):
    return torch.abs(dot(a, b))


def reflect(wo, n):
    """Mirror reflection of wo about n (reference Reflect)."""
    return -wo + 2.0 * dot(wo, n)[..., None] * n


def refract(wi, n, eta):
    """Snell refraction (reference Refract): wi points away from the
    surface, n to the side of wi (flipped with eta when wi is below it).
    Returns (valid (not total internal reflection), wt, the eta used)."""
    cos_i = dot(n, wi)
    flip = cos_i < 0.0
    eta = torch.where(flip, 1.0 / eta, eta)
    cos_i = torch.abs(cos_i)
    n = torch.where(flip[..., None], -n, n)
    sin2_i = torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    sin2_t = sin2_i / (eta * eta)
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    wt = -wi / eta[..., None] + (cos_i / eta - cos_t)[..., None] * n
    return sin2_t < 1.0, wt, eta


# local shading-frame trigonometry, n = (0, 0, 1)

def cos_theta(w):
    return w[..., 2]


def cos2_theta(w):
    return w[..., 2] * w[..., 2]


def abs_cos_theta(w):
    return torch.abs(w[..., 2])


def sin2_theta(w):
    return torch.clamp(1.0 - cos2_theta(w), min=0.0)


def sin_theta(w):
    return torch.sqrt(sin2_theta(w))


def tan2_theta(w):
    return sin2_theta(w) / cos2_theta(w)


def cos_phi(w):
    s = sin_theta(w)
    return torch.where(s == 0.0, 1.0, torch.clamp(
        w[..., 0] / torch.clamp(s, min=1e-20), -1.0, 1.0))


def sin_phi(w):
    s = sin_theta(w)
    return torch.where(s == 0.0, 0.0, torch.clamp(
        w[..., 1] / torch.clamp(s, min=1e-20), -1.0, 1.0))


def same_hemisphere(w, wp):
    return w[..., 2] * wp[..., 2] > 0.0


# equal-area octahedral sphere <-> square maps (Clarberg 2008; reference
# vecmath EqualAreaSphereToSquare / EqualAreaSquareToSphere), the image
# infinite light's parameterisation

def equal_area_sphere_to_square(d):
    """Unit directions (..., 3) -> [0, 1]^2 (..., 2)."""
    x, y, z = torch.abs(d[..., 0]), torch.abs(d[..., 1]), torch.abs(d[..., 2])
    r = torch.sqrt(torch.clamp(1.0 - z, min=0.0))
    a = torch.maximum(x, y)
    b = torch.minimum(x, y)
    b = torch.where(a == 0.0, 0.0, b / torch.clamp(a, min=1e-20))
    phi = torch.atan(b) * (2.0 / PI)
    phi = torch.where(x < y, 1.0 - phi, phi)
    v = phi * r
    u = r - v
    south = d[..., 2] < 0.0
    u, v = torch.where(south, 1.0 - v, u), torch.where(south, 1.0 - u, v)
    u = u * torch.where(d[..., 0] >= 0.0, 1.0, -1.0)
    v = v * torch.where(d[..., 1] >= 0.0, 1.0, -1.0)
    return torch.stack([0.5 * (u + 1.0), 0.5 * (v + 1.0)], dim=-1)


def equal_area_square_to_sphere(p):
    """[0, 1]^2 (..., 2) -> unit directions (..., 3), the inverse map."""
    u = 2.0 * p[..., 0] - 1.0
    v = 2.0 * p[..., 1] - 1.0
    up = torch.abs(u)
    vp = torch.abs(v)
    sd = 1.0 - (up + vp)
    r = 1.0 - torch.abs(sd)
    phi = torch.where(r == 0.0, 1.0,
                      (vp - up) / torch.clamp(r, min=1e-20) + 1.0) * PI / 4.0
    z = (1.0 - r * r) * torch.sign(sd)
    cos_phi_v = torch.cos(phi) * torch.sign(u)
    sin_phi_v = torch.sin(phi) * torch.sign(v)
    scale = r * torch.sqrt(torch.clamp(2.0 - r * r, min=0.0))
    return torch.stack([cos_phi_v * scale, sin_phi_v * scale, z], dim=-1)
