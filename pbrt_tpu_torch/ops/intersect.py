"""Analytic ray-shape tests in plain tensor code (counterpart of
pbrt_tpu/ops/intersect.py): the bilinear patch. The reference runs it as
vectorised array code over a small patch pool, with no kernel of its own,
and so does the port."""
from __future__ import annotations

import torch

from ..utils import vecmath as vm


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
