"""Light samplers (counterpart of pbrt_tpu_torch/lightsamplers.py), cut to
what the benchmark's cells reach: uniform and power (alias table). The
alias rows keep the reference layout [q, alias, pmf_self, pmf_alias].
The light-BVH and exhaustive samplers are not copied: a scene that asks
for them is refused."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .utils.sampling import AliasTable

LS_UNIFORM = 0   # the reference's kind codes
LS_POWER = 1


@dataclasses.dataclass(frozen=True)
class LightSampler:
    kind: int
    n_lights: int
    rows: np.ndarray = None       # (L, 4) float32 alias rows (power only)
    pmf_table: np.ndarray = None  # (L,) float32


def make_light_sampler(kind: str, light_powers, device="cuda"):
    """kind: uniform | power (reference make_light_sampler, the same
    fall-through: power without power, and any unknown name, give the
    uniform sampler); bvh and exhaustive are refused."""
    if kind in ("bvh", "exhaustive"):
        raise NotImplementedError(
            f"the {kind!r} light sampler is not in the benchmark's reference")
    powers = np.asarray(light_powers, np.float64)
    n = len(powers)
    if kind == "power" and n > 0 and powers.sum() > 0:
        at = AliasTable.build(powers)
        rows = np.stack([at.q, at.alias.astype(np.float32), at.pmf,
                         at.pmf[at.alias]], axis=1)
        return LightSampler(kind=LS_POWER, n_lights=n, rows=rows,
                            pmf_table=at.pmf)
    pmf = np.full(max(n, 1), 1.0 / max(n, 1), np.float32)
    return LightSampler(kind=LS_UNIFORM, n_lights=n, pmf_table=pmf)


def sample_light(ls, u, rows=None, p=None, n_ref=None):
    """Pick a light with u (N,) (reference sample_light). rows: the power
    sampler's (L, 4) alias rows as a tensor on u's device; p, n_ref: the
    shading points and normals, which neither sampler reads. Returns
    (light index (N,) int64, pmf (N,))."""
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
    """The pmf of picking light_idx (N,) (reference light_pmf)."""
    idx = torch.clamp(light_idx.to(torch.int64), 0, max(ls.n_lights - 1, 0))
    if ls.n_lights == 0:
        return torch.zeros(light_idx.shape, device=light_idx.device)
    return torch.as_tensor(ls.pmf_table, device=light_idx.device)[idx]
