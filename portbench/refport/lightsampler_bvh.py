"""Many-light BVH sampler, copied whole from
pbrt_tpu_torch/lightsampler_bvh.py (pbrt-v4 BVHLightSampler, Conty & Kulla
2018).

Host: the reference's binary BVH over each light's LightBounds (box,
orientation cone, power), built in numpy, its tables bit for bit the
reference's. Device: the stochastic top-down walk. Each level gathers one
node row holding both children's summaries and picks a child with
probability proportional to its importance from the shading point; the
pmf is the product of the choices. The pmf of a given light (for MIS)
walks the same tree along the light's bit trail, so a sample and its pmf
agree. Infinite lights stay outside the tree and are picked first with
probability n_inf / (n_inf + 1).
"""
from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from . import device as dev_mod
from .utils import vecmath as vm

# a node row: child 0 [lo(3) hi(3) w(3) cos_o cos_e phi idx_or_light leaf]
# (14 columns), then child 1 the same
_C = 14
LS_BVH = 2   # the reference's kind code


@dataclasses.dataclass(frozen=True)
class BVHLightSampler:
    nodes: torch.Tensor        # (M, 28) float32 two-child rows, root row 0
    bit_trail: torch.Tensor    # (L,) int32 path bits of each light
    trail_len: torch.Tensor    # (L,) int32 tree depth of each light
    outside: torch.Tensor      # (L,) bool: the light is outside the tree
    pmf_outside: torch.Tensor  # (L,) float32 pmf of the outside lights
    n_lights: int = 0
    max_depth: int = 0
    p_outside: float = 0.0
    kind: int = LS_BVH


def build_bvh_light_sampler(bounds_lo, bounds_hi, axis_w, cos_theta_o,
                            cos_theta_e, power, is_infinite,
                            device="cuda") -> BVHLightSampler:
    """Each argument: the (L,) or (L, 3) numpy array of one LightBounds
    field (reference build_bvh_light_sampler, the same recursive median
    split, post-order rows and root swap). The tables go to device."""
    device = dev_mod.resolve(device)
    L = len(power)
    power = np.asarray(power, np.float64)
    is_infinite = np.asarray(is_infinite, bool)
    tree_ids = np.nonzero(~is_infinite & (power > 0))[0]
    out_ids = np.nonzero(is_infinite & (power > 0))[0]
    n_out = len(out_ids)
    p_outside = n_out / (n_out + (1 if len(tree_ids) else 0)) \
        if (n_out or len(tree_ids)) else 0.0
    pmf_out = np.zeros(L, np.float64)
    if n_out:
        pmf_out[out_ids] = p_outside / n_out

    nodes = []
    bit_trail = np.zeros(L, np.int64)
    trail_len = np.zeros(L, np.int64)

    def light_cols(i):
        return np.concatenate([
            bounds_lo[i], bounds_hi[i], axis_w[i],
            [cos_theta_o[i], cos_theta_e[i], power[i], float(i), 1.0]])

    def subtree_cols(ids, child_index):
        lo = bounds_lo[ids].min(0)
        hi = bounds_hi[ids].max(0)
        # the reference's cone: the mean axis and the widest angle
        w = axis_w[ids].mean(0)
        n = np.linalg.norm(w)
        w = w / n if n > 1e-9 else np.array([0, 0, 1.0])
        co = float(np.min(cos_theta_o[ids])) if n > 1e-9 else -1.0
        ce = float(np.max(cos_theta_e[ids]))
        return np.concatenate([lo, hi, w, [
            min(co, 0.0) if len(ids) > 8 else co, ce, power[ids].sum(),
            float(child_index), 0.0]])

    max_depth = 0
    if len(tree_ids) > 1:
        old = sys.getrecursionlimit()
        sys.setrecursionlimit(10000)
        try:
            # post-order: a child's row exists before its parent names it
            def build(ids, depth, trail):
                if len(ids) == 1:
                    i = ids[0]
                    bit_trail[i] = trail
                    trail_len[i] = depth
                    return light_cols(i)
                c = 0.5 * (bounds_lo[ids] + bounds_hi[ids])
                dim = int(np.argmax(c.max(0) - c.min(0)))
                order = np.argsort(c[:, dim], kind="stable")
                mid = len(ids) // 2
                lid, rid = ids[order[:mid]], ids[order[mid:]]
                col_l = build(lid, depth + 1, trail)
                col_r = build(rid, depth + 1, trail | (1 << depth))
                idx = len(nodes)
                nodes.append(np.concatenate([col_l, col_r]))
                return subtree_cols(ids, idx)

            build(tree_ids, 0, 0)
        finally:
            sys.setrecursionlimit(old)
        max_depth = int(trail_len[tree_ids].max())
    elif len(tree_ids) == 1:
        i = tree_ids[0]
        nodes.append(np.concatenate([light_cols(i), light_cols(i)]))
        bit_trail[i] = 0
        trail_len[i] = 1
        max_depth = 1

    node_arr = (np.stack(nodes) if nodes else
                np.zeros((1, 2 * _C))).astype(np.float32)
    root = len(nodes) - 1 if nodes else 0
    if len(nodes) > 1:
        # the root to row 0, where the walk starts
        perm = np.arange(len(nodes))
        perm[[0, root]] = perm[[root, 0]]
        remap = np.empty(len(nodes), np.int64)
        remap[perm] = np.arange(len(nodes))
        node_arr = node_arr[perm]
        for col, leaf_col in ((12, 13), (_C + 12, _C + 13)):
            interior = node_arr[:, leaf_col] < 0.5
            node_arr[interior, col] = remap[
                node_arr[interior, col].astype(np.int64)].astype(np.float32)

    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    return BVHLightSampler(
        nodes=t(node_arr, torch.float32),
        bit_trail=t(bit_trail.astype(np.int32), torch.int32),
        trail_len=t(trail_len.astype(np.int32), torch.int32),
        outside=t(is_infinite, torch.bool),
        pmf_outside=t(pmf_out.astype(np.float32), torch.float32),
        n_lights=L, max_depth=max_depth, p_outside=float(p_outside))


def _acos(x):
    return torch.acos(torch.clamp(x, -1.0, 1.0))


def _child_importance(cols, p, n_ref=None):
    """Conty-Kulla importance of the child summaries cols (..., 14) from
    the shading points p (..., 3) (reference _child_importance, pbrt-v4
    CompactLightBounds::Importance). n_ref: the receivers' normals, for
    the incident-cosine bound, or None."""
    lo, hi, w = cols[..., 0:3], cols[..., 3:6], cols[..., 6:9]
    cos_o, cos_e, phi = cols[..., 9], cols[..., 10], cols[..., 11]
    center = 0.5 * (lo + hi)
    d = center - p
    dist2 = torch.clamp(vm.length_squared(d), min=1e-12)
    half_diag2 = 0.25 * vm.length_squared(hi - lo)
    dist2 = torch.maximum(dist2, half_diag2)
    wi = d / torch.sqrt(dist2)[..., None]
    cos_theta_w = vm.dot(w, -wi)
    # the half-angle the bounds subtend
    sin2_u = torch.clamp(half_diag2 / dist2, 0.0, 1.0)
    cos_u = torch.sqrt(1.0 - sin2_u)
    theta_u = _acos(cos_u)
    theta_p = torch.clamp(_acos(cos_theta_w) - _acos(cos_o) - theta_u,
                          min=0.0)
    cos_theta_p = torch.cos(theta_p)
    visible = theta_p < _acos(cos_e)
    imp = phi * torch.clamp(cos_theta_p, min=0.0) / dist2
    if n_ref is not None:
        theta_r = _acos(torch.abs(vm.dot(n_ref, wi)))
        cos_bound = torch.cos(torch.clamp(theta_r - theta_u, min=0.0))
        imp = imp * torch.clamp(cos_bound, min=0.05)
    return torch.where(visible & (phi > 0), torch.clamp(imp, min=0.0), 0.0)


def _child_probability(rows, p, n_ref):
    """p0, the probability of child 0 of node rows (N, 28): its share of
    the two importances, 0.5 where both are 0."""
    imp0 = _child_importance(rows[:, :_C], p, n_ref)
    imp1 = _child_importance(rows[:, _C:], p, n_ref)
    tot = imp0 + imp1
    return torch.where(tot > 0, imp0 / torch.clamp(tot, min=1e-12), 0.5)


def sample_bvh_light(ls: BVHLightSampler, p, n_ref, u):
    """Pick a light for the shading points p (N, 3) with u (N,) (reference
    sample_bvh_light). Returns (light index (N,) int64, pmf (N,),
    u remapped (N,))."""
    N = u.shape[0]
    dev = u.device
    # the outside (infinite) lights, picked uniformly by rank
    use_out = u < ls.p_outside
    has_pmf = ls.pmf_outside > 0
    n_out_total = torch.clamp(has_pmf.sum(), min=1)
    u_out = torch.clamp(u / max(ls.p_outside, 1e-9), 0.0, 1.0 - 1e-7)
    out_rows = torch.cumsum(has_pmf.to(torch.int32), 0).to(torch.int32) - 1
    target = (u_out * n_out_total.to(torch.float32)).to(torch.int32)
    idx_out = torch.searchsorted(out_rows, target, side="left")
    pmf_out = ls.p_outside / n_out_total.to(torch.float32)

    uu = torch.clamp((u - ls.p_outside) / max(1 - ls.p_outside, 1e-9), 0.0,
                     1.0 - 1e-7)
    cur = torch.zeros((N,), dtype=torch.int64, device=dev)
    pmf = torch.full((N,), 1.0 - ls.p_outside, dtype=p.dtype, device=dev)
    light = torch.zeros_like(cur)
    done = torch.zeros((N,), dtype=torch.bool, device=dev)
    for _ in range(ls.max_depth + 1 if ls.max_depth > 0 else 0):
        rows = ls.nodes[cur]
        p0 = _child_probability(rows, p, n_ref)
        go0 = uu < p0
        pc = torch.where(go0, p0, 1 - p0)
        uu_new = torch.clamp(torch.where(
            go0, uu / torch.clamp(p0, min=1e-9),
            (uu - p0) / torch.clamp(1 - p0, min=1e-9)), 0.0, 1.0 - 1e-7)
        child = torch.where(go0[:, None], rows[:, :_C], rows[:, _C:])
        is_leaf = child[:, 13] > 0.5
        idx = child[:, 12].round().to(torch.int64)
        # a zero-importance subtree still descends 50/50, so that the walk
        # stays the one pmf_bvh_light takes
        pmf = torch.where(done, pmf, pmf * pc)
        light = torch.where(~done & is_leaf, idx, light)
        cur = torch.where(~done & ~is_leaf, idx, cur)
        uu = torch.where(done, uu, uu_new)
        done = done | is_leaf
    li = torch.where(use_out, idx_out, light)
    pm = torch.where(use_out, pmf_out, pmf)
    return li, pm, torch.where(use_out, 0.5, uu)


def pmf_bvh_light(ls: BVHLightSampler, p, n_ref, light_idx):
    """The pmf with which sample_bvh_light picks light_idx (N,) from p
    (N, 3) (reference pmf_bvh_light), for MIS."""
    li = torch.clamp(light_idx.to(torch.int64), 0, ls.n_lights - 1)
    trail = ls.bit_trail[li]
    tlen = ls.trail_len[li]
    N = li.shape[0]
    cur = torch.zeros((N,), dtype=torch.int64, device=li.device)
    pmf = torch.full((N,), 1.0 - ls.p_outside, dtype=p.dtype,
                     device=li.device)
    for d in range(ls.max_depth):
        rows = ls.nodes[cur]
        p0 = _child_probability(rows, p, n_ref)
        go0 = ((trail >> d) & 1) == 0
        pc = torch.where(go0, p0, 1 - p0)
        active = d < tlen
        pmf = pmf * torch.where(active, pc, 1.0)
        child = torch.where(go0[:, None], rows[:, :_C], rows[:, _C:])
        nxt = child[:, 12].round().to(torch.int64)
        cur = torch.where(active & ~(child[:, 13] > 0.5), nxt, cur)
    return torch.where(ls.outside[li], ls.pmf_outside[li], pmf)
