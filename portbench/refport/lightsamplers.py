"""Light samplers (counterpart of pbrt_tpu_torch/lightsamplers.py, copied
whole but for its span): uniform, power (alias table), the many-light BVH
(lightsampler_bvh.py) and the exhaustive sampler. The alias rows keep the
reference layout [q, alias, pmf_self, pmf_alias]."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import device as dev_mod
from . import lightsampler_bvh as lbvh
from .utils.sampling import AliasTable

LS_UNIFORM = 0   # the reference's kind codes
LS_POWER = 1
LS_BVH = lbvh.LS_BVH
LS_EXHAUSTIVE = 3


@dataclasses.dataclass(frozen=True)
class LightSampler:
    kind: int
    n_lights: int
    rows: np.ndarray = None       # (L, 4) float32 alias rows (power only)
    pmf_table: np.ndarray = None  # (L,) float32


@dataclasses.dataclass(frozen=True)
class ExhaustiveLightSampler:
    """Position-aware sampler that weighs every bounded light by its
    Conty-Kulla importance at each shading point (reference
    ExhaustiveLightSampler): a dense (lanes, L) importance matrix and an
    inverse-CDF pick."""
    cols: torch.Tensor     # (L, 12) lo(3) hi(3) axis(3) cos_o cos_e phi
    is_inf: torch.Tensor   # (L,) float32, 1 for an infinite light
    n_lights: int = 0
    p_infinite: float = 0.0
    kind: int = LS_EXHAUSTIVE


def make_light_sampler(kind: str, light_powers, light_bounds=None,
                       device="cuda"):
    """kind: uniform | power | bvh | exhaustive (reference
    make_light_sampler, the same fall-through: bvh or exhaustive without
    bounds or power, and any unknown name, give the uniform sampler).
    light_bounds: the dict of per-light LightBounds arrays
    (SceneBuilder._light_bounds). The position-aware samplers' tables go
    to device."""
    powers = np.asarray(light_powers, np.float64)
    n = len(powers)
    positional = n > 0 and light_bounds is not None and powers.sum() > 0
    if kind == "bvh" and positional:
        return lbvh.build_bvh_light_sampler(**light_bounds, device=device)
    if kind == "exhaustive" and positional:
        lb = light_bounds
        cols = np.concatenate([
            np.asarray(lb["bounds_lo"], np.float32),
            np.asarray(lb["bounds_hi"], np.float32),
            np.asarray(lb["axis_w"], np.float32),
            np.asarray(lb["cos_theta_o"], np.float32)[:, None],
            np.asarray(lb["cos_theta_e"], np.float32)[:, None],
            np.asarray(lb["power"], np.float32)[:, None]], axis=1)
        is_inf = np.asarray(lb["is_infinite"], bool)
        n_inf, n_bounded = int(is_inf.sum()), int((~is_inf).sum())
        p_inf = n_inf / (n_inf + (1 if n_bounded else 0)) \
            if (n_inf or n_bounded) else 0.0
        device = dev_mod.resolve(device)
        return ExhaustiveLightSampler(
            cols=torch.as_tensor(cols, device=device),
            is_inf=torch.as_tensor(is_inf.astype(np.float32), device=device),
            n_lights=n, p_infinite=float(p_inf))
    if kind == "power" and n > 0 and powers.sum() > 0:
        at = AliasTable.build(powers)
        rows = np.stack([at.q, at.alias.astype(np.float32), at.pmf,
                         at.pmf[at.alias]], axis=1)
        return LightSampler(kind=LS_POWER, n_lights=n, rows=rows,
                            pmf_table=at.pmf)
    pmf = np.full(max(n, 1), 1.0 / max(n, 1), np.float32)
    return LightSampler(kind=LS_UNIFORM, n_lights=n, pmf_table=pmf)


def positional(ls) -> bool:
    """The sampler's pick depends on the shading point (bvh, exhaustive)."""
    return ls.kind in (LS_BVH, LS_EXHAUSTIVE)


def sample_light(ls, u, rows=None, p=None, n_ref=None):
    """Pick a light with u (N,) (reference sample_light). rows: the power
    sampler's (L, 4) alias rows as a tensor on u's device; p (N, 3): the
    shading points of the position-aware samplers; n_ref: their normals
    (the exhaustive sampler's optional bound; the reference's callers pass
    None). Returns (light index (N,) int64, pmf (N,))."""
    if ls.kind == LS_BVH:
        li, pmf, _u = lbvh.sample_bvh_light(ls, p, None, u)
        return li, pmf
    if ls.kind == LS_EXHAUSTIVE:
        return _sample_exhaustive(ls, u, p, n_ref)
    n = ls.n_lights
    if n == 0:
        return torch.full_like(u, -1, dtype=torch.int64), torch.zeros_like(u)
    if ls.kind == LS_POWER:
        up = u * n
        i = torch.clamp(up.to(torch.int32), 0, n - 1).to(torch.int64)
        frac = up - i.to(torch.float32)
        r = rows[i]
        take = frac < r[:, 0]
        return (torch.where(take, i, r[:, 1].round().to(torch.int64)),
                torch.where(take, r[:, 2], r[:, 3]))
    idx = torch.clamp((u * n).to(torch.int32), 0, n - 1).to(torch.int64)
    return idx, torch.full_like(u, float(np.float32(1.0 / n)))


def light_pmf(ls, light_idx, p=None, n_ref=None):
    """The pmf of picking light_idx (N,) (reference light_pmf), from the
    shading points p (N, 3) for the position-aware samplers."""
    if ls.kind == LS_BVH:
        return lbvh.pmf_bvh_light(ls, p, None, light_idx)
    idx = torch.clamp(light_idx.to(torch.int64), 0, max(ls.n_lights - 1, 0))
    if ls.kind == LS_EXHAUSTIVE:
        pmf_all = _exhaustive_pmf_matrix(ls, p, n_ref)
        return torch.gather(pmf_all, 1, idx[:, None])[:, 0]
    if ls.n_lights == 0:
        return torch.zeros(light_idx.shape, device=light_idx.device)
    return torch.as_tensor(ls.pmf_table, device=light_idx.device)[idx]


def _exhaustive_pmf_matrix(ls: ExhaustiveLightSampler, p, n_ref):
    """Each light's pick probability (N, L): the infinite lights uniform
    under p_infinite, the bounded ones in proportion to their importance."""
    imp = lbvh._child_importance(ls.cols[None, :, :], p[:, None, :],
                                 None if n_ref is None else n_ref[:, None, :])
    imp = imp * (1.0 - ls.is_inf)[None, :]
    tot = imp.sum(dim=1, keepdim=True)
    pmf_bounded = torch.where(tot > 0, imp / torch.clamp(tot, min=1e-30),
                              0.0)
    n_inf = torch.clamp(ls.is_inf.sum(), min=1.0)
    pmf_inf = ls.is_inf[None, :] * (ls.p_infinite / n_inf)
    return (1.0 - ls.p_infinite) * pmf_bounded + pmf_inf


def _sample_exhaustive(ls: ExhaustiveLightSampler, u, p, n_ref):
    """Inverse-CDF pick over the dense pmf (reference _sample_exhaustive).
    Returns (light index (N,) int64, pmf (N,))."""
    pmf_all = _exhaustive_pmf_matrix(ls, p, n_ref)
    cdf = torch.cumsum(pmf_all, dim=1)
    total = cdf[:, -1:]
    target = torch.clamp(u[:, None], 0.0, 1.0 - 1e-7) * total
    idx = (cdf < target).to(torch.int64).sum(dim=1)
    idx = torch.clamp(idx, 0, ls.n_lights - 1)
    pmf = torch.gather(pmf_all, 1, idx[:, None])[:, 0]
    return idx, torch.where(total[:, 0] > 0, pmf, 0.0)
