"""Reconstruction filters and filter importance sampling (counterpart of
pbrt_tpu/filters.py): the gaussian filter of the main path. The box filter
exists as a value only, so the megakernel's eligibility test can refuse
it."""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .utils.math import erf_inv

FILTER_BOX = 0        # the reference's kind codes
FILTER_GAUSSIAN = 2


@dataclasses.dataclass(frozen=True)
class Filter:
    kind: int
    radius: tuple
    sigma: float = 0.5


def make_filter(kind="gaussian", xradius=None, yradius=None,
                sigma=0.5) -> Filter:
    default_r = {"box": 0.5, "gaussian": 1.5}
    if kind not in default_r:
        raise NotImplementedError(
            f"filter {kind!r}: not ported (ROADMAP.md, slice 4: the other "
            "filters)")
    r = default_r[kind]
    return Filter(kind=FILTER_BOX if kind == "box" else FILTER_GAUSSIAN,
                  radius=(r if xradius is None else xradius,
                          r if yradius is None else yradius),
                  sigma=sigma)


def gaussian_constants(f: Filter) -> dict:
    """Host constants of the truncated-gaussian inverse-CDF sampler, rounded
    to float32 exactly as the reference megakernel bakes them."""
    rx, ry = (float(r) for r in f.radius)
    s2 = np.float32(f.sigma * math.sqrt(2.0))
    g = 2 * f.sigma ** 2
    # r / s2 is a float32 quotient (numpy scalar promotion), as in the
    # reference kernel
    return dict(
        s2=float(s2),
        inv_2s2=float(np.float32(1.0 / (2.0 * f.sigma * f.sigma))),
        norm=float(np.float32(1.0 / (f.sigma * math.sqrt(2.0 * math.pi)))),
        zx=float(np.float32(math.erf(np.float32(rx) / float(s2)))),
        zy=float(np.float32(math.erf(np.float32(ry) / float(s2)))),
        ex=float(np.float32(math.exp(-rx * rx / g))),
        ey=float(np.float32(math.exp(-ry * ry / g))),
        rx=float(np.float32(rx)), ry=float(np.float32(ry)))


def sample(f: Filter, u: torch.Tensor):
    """Importance-sample an offset from the pixel center. u: (N, 2) ->
    (offset (N, 2), weight (N,)) with weight = f(p) / pdf(p)."""
    if f.kind != FILTER_GAUSSIAN:
        raise NotImplementedError(
            "filter sampling: only gaussian is ported (ROADMAP.md, slice 4)")
    c = gaussian_constants(f)

    def axis(uu, r, z, e):
        x = c["s2"] * erf_inv(
            torch.clamp((2.0 * uu - 1.0) * z, -0.999999, 0.999999))
        x = torch.clamp(x, -r, r)
        pdf = torch.exp(-x * x * c["inv_2s2"]) * c["norm"] / z
        g = torch.clamp(torch.exp(-x * x * c["inv_2s2"]) - e, min=0.0)
        return x, pdf, g

    x, pdf_x, gx = axis(u[..., 0], c["rx"], c["zx"], c["ex"])
    y, pdf_y, gy = axis(u[..., 1], c["ry"], c["zy"], c["ey"])
    w = (gx * gy) / torch.clamp(pdf_x * pdf_y, min=1e-12)
    return torch.stack([x, y], dim=-1), w
