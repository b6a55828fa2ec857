"""Scalar math on tensors (counterpart of pbrt_tpu/utils/math.py), the
subset the ported paths use."""
from __future__ import annotations

import numpy as np
import torch

MACHINE_EPSILON = float(np.finfo(np.float32).eps * 0.5)
# the reference's float32 constants, as Python floats holding those values
PI = float(np.float32(np.pi))
INV_PI = float(np.float32(1.0 / np.pi))
INV_4PI = float(np.float32(1.0 / (4 * np.pi)))
_TINY = float(np.nextafter(np.float32(0), np.float32(1)))

# Giles (2012) single-precision erf^-1 polynomial coefficients
_ERFINV_P1 = (3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
              0.00021858087, -0.00125372503, -0.00417768164,
              0.246640727, 1.50140941)
_ERFINV_P2 = (0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
              -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def sqr(x):
    return x * x


def safe_sqrt(x):
    """sqrt(max(x, 0))."""
    return torch.sqrt(torch.clamp(x, min=0.0))


def safe_div(a, b):
    """a / b, 0 where b == 0."""
    return torch.where(b != 0.0, a / torch.where(b == 0.0, 1.0, b), 0.0)


def power_heuristic(nf, f_pdf, ng, g_pdf):
    """MIS power heuristic, beta = 2."""
    f = nf * f_pdf
    g = ng * g_pdf
    w = safe_div(f * f, f * f + g * g)
    return torch.where(torch.isinf(f * f), 1.0, w)


def gamma_bound(n: int) -> float:
    """(n eps) / (1 - n eps) float rounding bound, as float32."""
    ne = np.float32(n * MACHINE_EPSILON)
    return float(ne / (np.float32(1.0) - ne))


def erf_inv(a: torch.Tensor) -> torch.Tensor:
    """Inverse error function, the Giles polynomial (reference
    utils/math.erf_inv; the megakernel runs the same polynomial)."""
    x = torch.clamp(a.to(torch.float32), -0.99999, 0.99999)
    w = -torch.log((1.0 - x) * (1.0 + x))
    w1 = w - 2.5
    p1 = torch.full_like(x, 2.81022636e-08)
    for c in _ERFINV_P1:
        p1 = c + p1 * w1
    w2 = torch.sqrt(torch.clamp(w, min=1e-6)) - 3.0
    p2 = torch.full_like(x, -0.000200214257)
    for c in _ERFINV_P2:
        p2 = c + p2 * w2
    return torch.where(w < 5.0, p1, p2) * x


def next_float_up(v: torch.Tensor) -> torch.Tensor:
    """Next float32 towards +inf, keeping +inf and stepping -0.0 to the
    smallest denormal (reference util/float.h NextFloatUp)."""
    ui = v.view(torch.int32)
    out = torch.where(v >= 0, ui + 1, ui - 1).view(torch.float32)
    out = torch.where(v == 0.0, _TINY, out)
    return torch.where(torch.isinf(v) & (v > 0), v, out)


def next_float_down(v: torch.Tensor) -> torch.Tensor:
    """Next float32 towards -inf (reference NextFloatDown)."""
    ui = v.view(torch.int32)
    out = torch.where(v > 0, ui - 1, ui + 1).view(torch.float32)
    out = torch.where(v == 0.0, -_TINY, out)
    return torch.where(torch.isinf(v) & (v < 0), v, out)


def quadratic(a, b, c):
    """Roots of a t^2 + b t + c = 0 (reference utils/math.quadratic): q =
    -(b + sign(b) sqrt(disc)) / 2, t0 = q / a, t1 = c / q, ordered; b t + c
    = 0 where a == 0. Returns (has_solution, t0, t1), t0 <= t1."""
    disc = b * b - 4.0 * a * c
    has = (disc >= 0.0) & (a != 0.0)
    root = safe_sqrt(disc)
    q = -0.5 * (b + torch.where(b < 0.0, -root, root))
    t0 = safe_div(q, a)
    t1 = safe_div(c, q)
    lo = torch.minimum(t0, t1)
    hi = torch.maximum(t0, t1)
    lin_ok = (a == 0.0) & (b != 0.0)
    lin_t = safe_div(-c, b)
    return (has | lin_ok, torch.where(lin_ok, lin_t, lo),
            torch.where(lin_ok, lin_t, hi))
