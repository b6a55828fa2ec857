"""Analytic ray-shape tests in plain tensor code (counterpart of
pbrt_tpu/ops/intersect.py): the sphere, disk and cylinder quadrics in their
object space, and the bilinear patch. The reference runs them as
vectorised array code over a small pool, with no kernel of its own, and so
does the port."""
from __future__ import annotations

import math

import torch

from ..utils import vecmath as vm
from ..utils.math import quadratic, safe_div, sqr

_TWO_PI = 2 * math.pi


def _phi(p):
    """The azimuth of object-space points p in [0, 2 pi)."""
    phi = torch.atan2(p[..., 1], p[..., 0])
    return torch.where(phi < 0, phi + _TWO_PI, phi)


def _nearer(has, clip, t0, t1):
    """The nearer of the two roots that passes clip(t) -> (ok, t, p, phi).
    Returns dict(hit, t, p, phi) of it (the far root's values on a miss)."""
    ok0, t0v, p0v, phi0 = clip(t0)
    ok1, t1v, p1v, phi1 = clip(t1)
    return dict(hit=has & (ok0 | ok1), t=torch.where(ok0, t0v, t1v),
                p=torch.where(ok0[..., None], p0v, p1v),
                phi=torch.where(ok0, phi0, phi1))


def ray_sphere(o, d, t_max, radius, z_min=None, z_max=None, phi_max=None):
    """Ray / sphere in the sphere's object space (centre at the origin;
    reference Sphere::BasicIntersect): the quadratic in t with the
    discriminant in the reference's order, each root's point refined onto
    the sphere, z and phi clipping where given. Returns dict(hit, t (inf on
    a miss), p (object space), phi)."""
    a = vm.dot(d, d)
    b = 2.0 * vm.dot(o, d)
    c = vm.dot(o, o) - sqr(radius)
    has, t0, t1 = quadratic(a, b, c)

    def clip(t):
        p = o + t[..., None] * d
        p = p * (radius / torch.clamp(vm.length(p), min=1e-20))[..., None]
        phi = _phi(p)
        ok = (t > 1e-7) & (t < t_max)
        if z_min is not None:
            ok = ok & (p[..., 2] >= z_min) & (p[..., 2] <= z_max)
        if phi_max is not None:
            ok = ok & (phi <= phi_max)
        return ok, t, p, phi

    r = _nearer(has, clip, t0, t1)
    r["t"] = torch.where(r["hit"], r["t"], torch.inf)
    return r


def ray_disk(o, d, t_max, radius, height=0.0, inner_radius=0.0,
             phi_max=None):
    """Ray / disk in its object space: the annulus inner_radius <= r <=
    radius in the plane z = height (reference Disk::BasicIntersect).
    Returns dict(hit, t, p, phi)."""
    dz = d[..., 2]
    t = safe_div(height - o[..., 2], dz)
    p = o + t[..., None] * d
    r2 = sqr(p[..., 0]) + sqr(p[..., 1])
    phi = _phi(p)
    hit = (torch.abs(dz) > 1e-12) & (t > 1e-7) & (t < t_max) & \
        (r2 <= sqr(radius)) & (r2 >= sqr(inner_radius))
    if phi_max is not None:
        hit = hit & (phi <= phi_max)
    return dict(hit=hit, t=t, p=p, phi=phi)


def ray_cylinder(o, d, t_max, radius, z_min, z_max, phi_max=None):
    """Ray / cylinder x^2 + y^2 = r^2, z in [z_min, z_max], in its object
    space (reference Cylinder::BasicIntersect), each root's point refined
    onto the cylinder. Returns dict(hit, t, p, phi)."""
    a = sqr(d[..., 0]) + sqr(d[..., 1])
    b = 2.0 * (d[..., 0] * o[..., 0] + d[..., 1] * o[..., 1])
    c = sqr(o[..., 0]) + sqr(o[..., 1]) - sqr(radius)
    has, t0, t1 = quadratic(a, b, c)

    def clip(t):
        p = o + t[..., None] * d
        hit_rad = torch.sqrt(torch.clamp(sqr(p[..., 0]) + sqr(p[..., 1]),
                                         min=1e-20))
        s = radius / hit_rad
        p = torch.stack([p[..., 0] * s, p[..., 1] * s, p[..., 2]], dim=-1)
        phi = _phi(p)
        ok = (t > 1e-7) & (t < t_max) & (p[..., 2] >= z_min) & \
            (p[..., 2] <= z_max)
        if phi_max is not None:
            ok = ok & (phi <= phi_max)
        return ok, t, p, phi

    return _nearer(has, clip, t0, t1)


def ray_bilinear_patch(o, d, t_max, p00, p10, p01, p11):
    """Reshetov's ray / bilinear-patch intersection ("Cool Patches", Ray
    Tracing Gems ch. 8; the reference renderer's IntersectBilinearPatch).

    o, d (..., 3); t_max (...); corners broadcastable to (..., 3), with
    point(u, v) = lerp(v; lerp(u; p00, p10), lerp(u; p01, p11)). Both
    roots of the quadratic in u are tried and the nearer valid one kept.
    Returns dict(hit, t (inf on a miss), u, v)."""
    a = vm.dot(vm.cross(p10 - p00, p01 - p11), d)
    c = vm.dot(vm.cross(p00 - o, d), p01 - p00)
    b = vm.dot(vm.cross(p10 - o, d), p11 - p10) - (a + c)

    # robust quadratic (linear when the patch is a parallelogram: a ~ 0)
    disc = b * b - 4.0 * a * c
    has_roots = disc >= 0.0
    sd = torch.sqrt(torch.clamp(disc, min=0.0))
    qq = -0.5 * (b + torch.where(b < 0, -sd, sd))
    lin = torch.abs(a) < 1e-12 * torch.clamp(torch.abs(b), min=1.0)
    ra = qq / torch.where(torch.abs(a) < 1e-30, 1e-30, a)
    rb = c / torch.where(torch.abs(qq) < 1e-30, 1e-30, qq)
    u_lin = -c / torch.where(torch.abs(b) < 1e-30, 1e-30, b)
    u1 = torch.where(lin, u_lin, torch.minimum(ra, rb))
    u2 = torch.where(lin, torch.inf, torch.maximum(ra, rb))

    mag = sum(torch.abs(x).amax(dim=-1) for x in (o, d, p00, p10, p01, p11))
    eps = 1.79e-6 * mag   # gamma(30) ~ 30 * 2^-23 / (1 - 30 * 2^-24)

    def eval_at(u):
        uu = u[..., None]
        uo = (1 - uu) * p00 + uu * p10
        ud = ((1 - uu) * p01 + uu * p11) - uo
        deltao = uo - o
        perp = vm.cross(d, ud)
        p2 = vm.dot(perp, perp)
        # det([deltao | d | perp]) and det([deltao | ud | perp])
        v_num = vm.dot(deltao, vm.cross(d, perp))
        t_num = vm.dot(deltao, vm.cross(ud, perp))
        in_u = (u >= 0.0) & (u <= 1.0) & has_roots
        ok = in_u & (t_num > p2 * eps) & (v_num >= 0.0) & (v_num <= p2)
        p2s = torch.where(p2 <= 0, 1.0, p2)
        return ok & (p2 > 0), t_num / p2s, v_num / p2s

    ok1, t1, v1 = eval_at(u1)
    ok2, t2, v2 = eval_at(u2)
    ok1 = ok1 & (t1 < t_max)
    ok2 = ok2 & (t2 < t_max)
    pick2 = ok2 & (~ok1 | (t2 < t1))
    hit = ok1 | ok2
    t = torch.where(pick2, t2, t1)
    return dict(hit=hit, t=torch.where(hit, t, torch.inf),
                u=torch.where(pick2, u2, u1), v=torch.where(pick2, v2, v1))
