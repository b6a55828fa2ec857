"""Volumetric path integrator (counterpart of pbrt_tpu/integrators/
volpath.py): null-scattering path tracing with rescaled path probabilities
and spectral MIS (the reference renderer's VolPathIntegrator).

Free flights are delta-tracked through the scene's majorant super-grid
(media.py) by a 3D DDA: each step of the flight loop either moves a lane
to its next grid cell or takes one null, scatter or absorb event. A cell's
majorant is a scalar, so every T_maj factor of the estimator cancels from
the ratios beta, r_u and r_l: the loop carries no exponentials. The loop
is the reference's masked while loop run on the host, one synchronising
check a step; it runs over the flying lanes only, gathered whenever half
of them have landed, and each lane's draws are keyed on the global step
`it` (the reference's uniform_float(seed, it, stream)), so a lane draws
what it draws in the reference's loop over all lanes. A lane still flying after
MAX_FLIGHT_EVENTS steps ends as EV_REACH, as in the reference. The loop is
tensor code in both packages; it is no TPU kernel.

The wave runs the reference's body once per iteration: the closest hit;
with medium interfaces, their closest crossing, which truncates the
segment (a crossing consumes no depth, switches the ray's medium by the
side it crosses, and the loop gets 8 iterations of slack); the flight;
emission at area-light hits and escapes with the r_u / r_l MIS; next-event
estimation with a shadow ray whose transmittance is ratio-tracked through
the grid (its medium is found by a point-in-box lookup even where the
scene has interfaces, as in the reference); the BSDF or Henyey-Greenstein
sample; Russian roulette on max(beta) eta_scale / avg(r_u). The camera's
medium is the box lookup at the ray origin. Dead lanes query with t_max =
-1.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import bxdfs
from .. import lights as lgt
from .. import lightsamplers as lsamp
from .. import materials as mtl
from .. import media as med_mod
from .. import samplers as smp
from .. import scene_core as sc
from .. import spans
from ..utils import rng as prng
from ..utils import sampling as usamp
from ..utils import vecmath as vm
from ..utils.math import INV_4PI, safe_div
from .path import (CAM_DIMS, DIMS_PER_BOUNCE, PathOptions, _shading_frame,
                   _to_local, _to_world, camera_lanes, camera_rays)

MAX_FLIGHT_EVENTS = 512
EV_REACH, EV_SCATTER, EV_ABSORB = 0, 1, 2
_FLYING = -1
_EPS = 1e-9
_FLIGHT_STREAMS = (0x51a7, 0x9bd3)   # the event's distance, its kind
_SHADOW_STREAMS = (0x7b55, 0x3d91)   # the event's distance, roulette
_BOUNCE_SALT = 0x6d3a
# gather the flying lanes once at most this share of the gathered set flies
_COMPACT_SHARE = 0.5


def _avg(x):
    return x.mean(dim=-1)


def medium_index_at(pool: med_mod.MediumPool, p):
    """The first medium whose world box holds p (N, 3), -1 where none
    (reference medium_index_at; a zero-extent row claims no point)."""
    idx = torch.full(p.shape[:-1], -1, dtype=torch.int64, device=p.device)
    for m in range(pool.desc.shape[0] - 1, -1, -1):
        lo, hi = pool.desc[m, 15:18], pool.desc[m, 18:21]
        inside = ((p >= lo) & (p <= hi) & (hi > lo)).all(dim=-1)
        idx = torch.where(inside, m, idx)
    return idx


def _res(pool, device, dtype):
    return torch.tensor(pool.maj_res, dtype=dtype, device=device)


def _dda_init(pool: med_mod.MediumPool, o, d, t_start):
    """Each lane's 3D DDA over the majorant super-grid from t_start
    (reference _dda_init, the DDAMajorantIterator): the voxel, the next
    crossing along each axis, the step between crossings, the voxel step
    and the index past the grid. Returns a dict."""
    res = _res(pool, o.device, torch.float32)
    res_i = _res(pool, o.device, torch.int64)
    diag = torch.clamp(pool.maj_hi - pool.maj_lo, min=_EPS)
    og = (o - pool.maj_lo) / diag
    dg = d / diag
    gi = og + dg * t_start[:, None]
    voxel = torch.minimum(torch.clamp(torch.floor(gi * res).to(torch.int64),
                                      min=0), res_i - 1)
    small = torch.abs(dg) < _EPS
    dg_safe = torch.where(small, _EPS, dg)
    delta_t = 1.0 / (torch.abs(dg_safe) * res)
    pos = dg >= 0
    vf = voxel.to(torch.float32)
    next_pos = torch.where(pos, (vf + 1.0) / res, vf / res)
    nc = t_start[:, None] + (next_pos - gi) / dg_safe
    return dict(voxel=voxel, nc=torch.where(small, torch.inf, nc),
                delta_t=delta_t,
                step=torch.where(pos, 1, -1).to(torch.int64),
                limit=torch.where(pos, res_i, -1))


def _grid_span(pool: med_mod.MediumPool, o, d, t_max):
    """[t0, t1]: the rays' overlap with the super-grid's box within [0,
    t_max]; t0 >= t1 where they miss it."""
    inv_d = 1.0 / torch.where(torch.abs(d) < _EPS, _EPS, d)
    ta = (pool.maj_lo - o) * inv_d
    tb = (pool.maj_hi - o) * inv_d
    t0 = torch.clamp(torch.minimum(ta, tb).amax(dim=-1), min=0.0)
    t1 = torch.minimum(torch.maximum(ta, tb).amin(dim=-1), t_max)
    return t0, t1


def _maj_lookup(pool: med_mod.MediumPool, voxel):
    mx, my, _mz = pool.maj_res
    flat = (voxel[:, 2] * my + voxel[:, 1]) * mx + voxel[:, 0]
    return pool.maj_grid[torch.clamp(flat, 0, pool.maj_grid.shape[0] - 1)]


def _dda_step(st, flying, has_event):
    """The no-event lanes' DDA step to the next cell (reference body, the
    argmin axis as a one-hot). Returns (advance, reached)."""
    nc, voxel = st["nc"], st["voxel"]
    advance = flying & ~has_event
    ax0 = (nc[:, 0] <= nc[:, 1]) & (nc[:, 0] <= nc[:, 2])
    ax1 = ~ax0 & (nc[:, 1] <= nc[:, 2])
    ax = torch.where(ax0, 0, torch.where(ax1, 1, 2))
    onehot = torch.nn.functional.one_hot(ax, 3)
    stepped_voxel = voxel + onehot * st["step"]
    stepped_nc = nc + onehot.to(torch.float32) * st["delta_t"]
    out = (stepped_voxel * onehot).sum(-1) == (st["limit"] * onehot).sum(-1)
    t_cell = torch.minimum(nc.amin(dim=-1), st["t1"])
    a3 = advance[:, None]
    st["voxel"] = torch.where(a3, stepped_voxel, voxel)
    st["nc"] = torch.where(a3, stepped_nc, nc)
    st["t_lo"] = torch.where(advance, t_cell, st["t_lo"])
    return advance & ((t_cell >= st["t1"]) | out)


def _flight_loop(idx, extra, full, step, counter):
    """Run step(st, it, flying) -> flying over the lanes idx (N',) until
    none flies or MAX_FLIGHT_EVENTS steps, and add the steps to the spans'
    counter `counter`. st holds each lane's tensors
    (first dimension N'): those of `full` (N, ...), gathered, into which
    they scatter back, and `extra`, already gathered (the constants and
    the DDA's state). The flying lanes are gathered again whenever at
    most _COMPACT_SHARE of the set flies."""
    st = {k: v[idx] for k, v in full.items()}
    st.update(extra)
    keys = list(full)
    it = 0
    fly = torch.ones_like(idx, dtype=torch.bool)
    while it < MAX_FLIGHT_EVENTS:
        n_fly = int(fly.sum())
        if n_fly == 0:
            break
        if n_fly <= _COMPACT_SHARE * idx.shape[0]:
            for k in keys:
                full[k][idx] = st[k]
            keep = fly.nonzero()[:, 0]
            st = {k: v[keep] for k, v in st.items()}
            idx = idx[keep]
            fly = fly[keep]
        fly = step(st, it, fly)
        it += 1
    for k in keys:
        full[k][idx] = st[k]
    spans.count(counter, it)


def _start(pool, o, d, t_max, lam, seed, in_grid):
    """The lanes that fly (a synchronising nonzero), (N',), and their
    gathered constants (o, d, lam, t1, the seed's hash prefix) and DDA
    state; (None, None) where none flies."""
    idx = in_grid.nonzero()[:, 0]
    if idx.shape[0] == 0:
        return None, None
    o, d, lam, seed = o[idx], d[idx], lam[idx], seed[idx]
    t0, t1 = _grid_span(pool, o, d, t_max[idx])
    dda = _dda_init(pool, o, d, t0)
    return idx, dict(dda, o=o, d=d, lam=lam, t1=t1, t_lo=t0,
                     h1=prng.hash_continue(0x9E3779B9, seed))


def _draws(st, it, streams):
    """The two uniforms of step `it`: uniform_float(seed, it, stream)."""
    h2 = prng.hash_continue(st["h1"], it)
    return [prng.u32_to_float01(prng.hash_continue(h2, s)) for s in streams]


def _sigma(pool, st, cur_med, t):
    """(p_ev, the medium's row, sigma_a, sigma_s) at distance t, zero
    outside every medium."""
    p_ev = st["o"] + st["d"] * t[:, None]
    med_idx = medium_index_at(pool, p_ev) if cur_med is None else cur_med
    row = med_mod.medium_row(pool, med_idx)
    sa, ss = med_mod.sigma_at(pool, row, p_ev, st["lam"])
    none = (med_idx < 0)[:, None]
    return row, torch.where(none, 0.0, sa), torch.where(none, 0.0, ss)


@spans.span("media.flight")
def sample_t_maj(scene, o, d, t_max, lam, seed, active, beta, r_u, r_l,
                 cur_med=None):
    """The free flight of rays o, d (N, 3) up to t_max (N,) with the
    integrator's event callback (reference sample_t_maj): null events
    update beta, r_u, r_l in the loop, and a lane stops at a scatter, an
    absorption or the segment's end. seed (N,) u32 values; cur_med (N,)
    the ray-carried medium with interfaces (its sigma instead of the box
    lookup; a vacuum lane does not fly). Returns dict(status, t, g, beta,
    r_u, r_l); lanes not active reach with their state untouched."""
    pool = scene.media
    N = o.shape[0]
    t0, t1 = _grid_span(pool, o, d, t_max)
    in_grid = active & (t1 > t0)
    if cur_med is not None:
        in_grid = in_grid & (cur_med >= 0)
    full = dict(status=torch.full((N,), EV_REACH, dtype=torch.int64,
                                  device=o.device),
                t_ev=torch.zeros_like(t_max), g_ev=torch.zeros_like(t_max),
                beta=beta.clone(), r_u=r_u.clone(), r_l=r_l.clone())
    idx, extra = _start(pool, o, d, t_max, lam, seed, in_grid)
    spans.count("flight.calls")
    if idx is not None:
        full["status"][idx] = _FLYING
        if cur_med is not None:
            extra["cur_med"] = cur_med[idx]
        _flight_loop(idx, extra, full, functools.partial(_flight_step, pool),
                     "flight.steps")
    status = torch.where(full["status"] == _FLYING, EV_REACH, full["status"])
    return dict(status=status, t=full["t_ev"], g=full["g_ev"],
                beta=full["beta"], r_u=full["r_u"], r_l=full["r_l"])


def _flight_step(pool, st, it, flying):
    """One step of sample_t_maj's loop on the gathered lanes st: a DDA
    step to the next cell, or an event (null, scatter, absorb) with the
    integrator's callback. Returns the lanes still flying."""
    sigma_bar = _maj_lookup(pool, st["voxel"])
    u1, u2 = _draws(st, it, _FLIGHT_STREAMS)
    dt = torch.where(sigma_bar > 0, -torch.log1p(-u1)
                     / torch.clamp(sigma_bar, min=_EPS), torch.inf)
    t = st["t_lo"] + dt
    t_exit = torch.minimum(st["nc"].amin(dim=-1), st["t1"])
    has_event = flying & (t < t_exit)
    row, sa, ss = _sigma(pool, st, st.get("cur_med"), t)
    sig = torch.clamp(sigma_bar, min=_EPS)
    pa = sa[:, 0] / sig
    ps = ss[:, 0] / sig
    absorb = has_event & (u2 < pa)
    scatter = has_event & ~absorb & (u2 < pa + ps)
    null = has_event & ~absorb & ~scatter
    sn = torch.clamp(sigma_bar[:, None] - sa - ss, min=0.0)
    sn_h = sn[:, 0]
    w_null = sn / torch.clamp(sn_h, min=_EPS)[:, None]
    rl_null = sigma_bar / torch.clamp(sn_h, min=_EPS)
    w_scat = ss / torch.clamp(ss[:, 0], min=_EPS)[:, None]
    n3, s3 = null[:, None], scatter[:, None]
    st["beta"] = torch.where(n3, st["beta"] * w_null, torch.where(
        s3, st["beta"] * w_scat, st["beta"]))
    st["r_u"] = torch.where(n3, st["r_u"] * w_null, torch.where(
        s3, st["r_u"] * w_scat, st["r_u"]))
    st["r_l"] = torch.where(n3, st["r_l"] * rl_null[:, None], st["r_l"])
    dead = null & (sn_h <= 0)
    status = torch.where(absorb | dead, EV_ABSORB,
                         torch.where(scatter, EV_SCATTER, st["status"]))
    st["t_ev"] = torch.where(scatter, t, st["t_ev"])
    st["g_ev"] = torch.where(scatter, med_mod.hg_g(row), st["g_ev"])
    st["t_lo"] = torch.where(null, t, st["t_lo"])
    reached = _dda_step(st, flying, has_event)
    st["status"] = torch.where(reached, EV_REACH, status)
    return st["status"] == _FLYING


@spans.span("media.transmittance")
def transmittance_ratio(scene, o, d, dist, lam, seed, active):
    """Ratio-tracked transmittance of shadow rays o, d (N, 3) over dist
    (N,) with rescaled pdfs (reference transmittance_ratio, the SampleLd
    loop), the medium by the box lookup, roulette where the ratio falls
    under 0.05. Returns (T_ray, r_l, r_u), each (N, 4)."""
    pool = scene.media
    N = o.shape[0]
    t0, t1 = _grid_span(pool, o, d, dist)
    full = {k: torch.ones((N, 4), dtype=torch.float32, device=o.device)
            for k in ("T_ray", "r_l", "r_u")}
    idx, extra = _start(pool, o, d, dist, lam, seed, active & (t1 > t0))
    spans.count("shadow.calls")
    if idx is not None:
        _flight_loop(idx, extra, full, functools.partial(_shadow_step, pool),
                     "shadow.steps")
    return full["T_ray"], full["r_l"], full["r_u"]


def _shadow_step(pool, st, it, flying):
    """One step of transmittance_ratio's loop on the gathered lanes st: a
    DDA step, or an event that scales T_ray and r_u by the null share,
    with roulette where the ratio falls under 0.05. Returns the lanes
    still flying."""
    sigma_bar = _maj_lookup(pool, st["voxel"])
    u1, u_rr = _draws(st, it, _SHADOW_STREAMS)
    dt = torch.where(sigma_bar > 0, -torch.log1p(-u1)
                     / torch.clamp(sigma_bar, min=_EPS), torch.inf)
    t = st["t_lo"] + dt
    t_exit = torch.minimum(st["nc"].amin(dim=-1), st["t1"])
    has_event = flying & (t < t_exit)
    _row, sa, ss = _sigma(pool, st, None, t)
    sn = torch.clamp(sigma_bar[:, None] - sa - ss, min=0.0)
    w = sn / torch.clamp(sigma_bar, min=_EPS)[:, None]
    e3 = has_event[:, None]
    T_ray = torch.where(e3, st["T_ray"] * w, st["T_ray"])
    st["r_u"] = torch.where(e3, st["r_u"] * w, st["r_u"])
    st["t_lo"] = torch.where(has_event, t, st["t_lo"])
    Tr = T_ray / torch.clamp(_avg(st["r_l"] + st["r_u"]),
                             min=_EPS)[:, None]
    low = has_event & (Tr.amax(dim=-1) < 0.05)
    kill = low & (u_rr < 0.75)
    st["T_ray"] = torch.where(kill[:, None], 0.0, torch.where(
        low[:, None], T_ray / 0.25, T_ray))
    dead = (st["T_ray"] <= 0).all(dim=-1)
    reached = _dda_step(st, flying, has_event)
    return flying & ~reached & ~dead


def _sample_ld(scene, sampler, px, py, si, lam, spec_cache, p, p_err, ns,
               ng, t1, t2, wo_local, bp, active, depth, r_p, scattered,
               wo_world, g_hg, seed):
    """Next-event estimation with a ratio-tracked shadow ray and spectral
    MIS (reference sample_ld). Returns the (N, 4) contribution before
    beta."""
    base = CAM_DIMS + depth * DIMS_PER_BOUNCE
    u_pick = smp.sample_1d(sampler, px, py, si, base)
    u_l = smp.sample_2d(sampler, px, py, si, base + 1)
    li_idx, pmf = lsamp.sample_light(scene.light_sampler, u_pick,
                                     scene.alias_rows, p=p)
    ls = lgt.sample_li(scene.lights_packed, torch.clamp(li_idx, min=0), p,
                       u_l, lam, scene.spectra_pool, scene.scene_radius,
                       scene.light_tags, spec_cache, env=scene.env)
    wi = ls["wi"]
    wi_local = _to_local(ns, t1, t2, wi)
    f_hat = bxdfs.bsdf_f(bp, wo_local, wi_local) * \
        torch.abs(wi_local[:, 2])[:, None]
    scatter_pdf = bxdfs.bsdf_pdf(bp, wo_local, wi_local)
    ph = usamp.henyey_greenstein(vm.dot(wo_world, wi), g_hg)
    f_hat = torch.where(scattered[:, None], ph[:, None], f_hat)
    scatter_pdf = torch.where(scattered, ph, scatter_pdf)
    p_l = ls["pdf"] * pmf
    ok = active & ls["valid"] & (p_l > 0) & (f_hat > 0).any(dim=-1)
    o_sh = sc.offset_ray_origin_exact(p, p_err, ng, wi)
    o_sh = torch.where(scattered[:, None], p + 1e-5 * wi, o_sh)
    dist = vm.length(ls["p_light"] - o_sh)
    spans.tally("shadow.rays", ok)
    ok = ok & ~sc.intersect_p(scene, o_sh, wi,
                              torch.where(ok, dist * 0.999, -1.0))
    T_ray, r_l_sh, r_u_sh = transmittance_ratio(scene, o_sh, wi, dist, lam,
                                                seed, ok)
    r_l_tot = r_l_sh * r_p * p_l[:, None]
    r_u_tot = r_u_sh * r_p * scatter_pdf[:, None]
    denom = torch.where(ls["is_delta"], _avg(r_l_tot),
                        _avg(r_l_tot + r_u_tot))
    Ld = f_hat * T_ray * ls["L"] / torch.clamp(denom, min=_EPS)[:, None]
    return torch.where((ok & (denom > 0))[:, None], Ld, 0.0)


def trace_paths(scene, sampler, px, py, sample_index, o, d, swl,
                opts: PathOptions):
    """Volumetric path trace of one wave from camera rays o, d (N, 3)
    (reference volpath.trace_paths). Returns L (N, 4); the film divides by
    swl.pdf."""
    N = o.shape[0]
    dev = o.device
    lam = swl.lam
    ls = scene.light_sampler
    spec_cache = None
    if scene.spectra_pool.shape[0] <= lgt.SPEC_CACHE_MAX:
        spec_cache = lgt.eval_all_spectra(scene.spectra_pool, lam)
    textures = scene.textures if scene.has_textures else None
    has_ifaces = scene.has_medium_interfaces
    need_uc = bool({bxdfs.BXDF_HAIR, bxdfs.BXDF_DIELECTRIC}
                   & set(scene.bxdf_tags))
    beta = torch.ones((N, 4), dtype=torch.float32, device=dev)
    L = torch.zeros_like(beta)
    r_u = torch.ones_like(beta)
    r_l = torch.ones_like(beta)
    active = torch.ones((N,), dtype=torch.bool, device=dev)
    spec_bounce = torch.zeros_like(active)
    sec_term = torch.zeros_like(active)
    eta_scale = torch.ones((N,), dtype=torch.float32, device=dev)
    depth = torch.zeros((N,), dtype=torch.int64, device=dev)
    disp_weight = torch.tensor([4.0, 0.0, 0.0, 0.0], device=dev)
    # the camera's medium: the box lookup at the ray origin
    cur_med = medium_index_at(scene.media, o) if has_ifaces else \
        torch.full((N,), -1, dtype=torch.int64, device=dev)
    pix_hash = prng.hash_u32(px.to(torch.int64), py.to(torch.int64),
                             sample_index.to(torch.int64))
    n_iters = opts.max_depth + (8 if has_ifaces else 0)
    for it in range(n_iters):
        if not bool(active.any()):
            break
        spans.tally("lanes.alive", active, it)
        with spans.span("scene.intersect", depth=it):
            isect = sc.intersect(scene, o, d,
                                 torch.where(active, 1e30, -1.0))
        if has_ifaces:
            ii = sc.intersect_interfaces(
                scene, o, d, torch.where(active, isect["t"], -1.0))
            iface_first = ii["hit"] & (ii["t"] < isect["t"])
            t_seg = torch.where(iface_first, ii["t"], isect["t"])
        else:
            iface_first = torch.zeros_like(active)
            t_seg = isect["t"]

        # --- the medium flight ---
        seed_fl = prng.hash_continue(pix_hash, it, _BOUNCE_SALT)
        fl = sample_t_maj(scene, o, d, t_seg, lam, seed_fl, active, beta,
                          r_u, r_l, cur_med=cur_med if has_ifaces else None)
        beta, r_u, r_l = fl["beta"], fl["r_u"], fl["r_l"]
        scattered = active & (fl["status"] == EV_SCATTER)
        absorbed = active & (fl["status"] == EV_ABSORB)
        reach = fl["status"] == EV_REACH
        p_med = o + d * fl["t"][:, None]
        active = active & ~absorbed
        passthru = iface_first & active & reach
        hit = isect["hit"] & active & reach & ~passthru
        first = (depth == 0) | spec_bounce

        with spans.span("wave.emission", depth=it):
            # --- emission at area-light hits ---
            if scene.has_area_lights:
                is_emitter = hit & (isect["light"] >= 0)
                li_safe = torch.clamp(isect["light"], min=0)
                lrow = scene.lights_packed[li_safe]
                Le = lgt.area_light_radiance(lrow, isect["ng"], isect["wo"],
                                             lam, scene.spectra_pool,
                                             spec_cache)
                if lsamp.positional(ls):
                    pick_pmf = lsamp.light_pmf(ls, li_safe, p=o)
                else:
                    pick_pmf = lrow[:, 14]
                pdf_light = lgt.pdf_li_area_tri(o, d, isect["p"],
                                                isect["p0"], isect["p1"],
                                                isect["p2"])
                if scene.n_spheres > 0:
                    pdf_light = torch.where(
                        lrow[:, 0].round() == lgt.LIGHT_AREA_SPHERE,
                        lgt.pdf_li_sphere(lrow, o), pdf_light)
                p_l = pdf_light * pick_pmf
                denom = torch.where(first, _avg(r_u),
                                    _avg(r_u + r_l * p_l[:, None]))
                L = L + torch.where(is_emitter[:, None],
                                    beta * Le / torch.clamp(
                                        denom, min=_EPS)[:, None], 0.0)

            escaped = active & reach & ~isect["hit"] & ~passthru
            # --- escapes: the image infinite light ---
            if scene.env is not None:
                Le_env = lgt.env_radiance(scene.env, d, lam)
                pdf_env = lgt.env_pdf_li(scene.env, d) * float(
                    ls.pmf_table[scene.env.light_index])
                denom = torch.where(first, _avg(r_u),
                                    _avg(r_u + r_l * pdf_env[:, None]))
                L = L + torch.where(escaped[:, None],
                                    beta * Le_env / torch.clamp(
                                        denom, min=_EPS)[:, None], 0.0)
            # --- escapes: the uniform infinite lights ---
            if scene.inf_indices:
                Le_inf = lgt.infinite_light_radiance(
                    scene.lights_packed, scene.inf_indices, lam,
                    scene.spectra_pool, spec_cache)
                pdf_inf = float(
                    np.float32(ls.pmf_table[scene.inf_indices[0]])
                    * np.float32(INV_4PI))
                denom = torch.where(first, _avg(r_u),
                                    _avg(r_u + r_l * pdf_inf))
                L = L + torch.where(escaped[:, None],
                                    beta * Le_inf / torch.clamp(
                                        denom, min=_EPS)[:, None], 0.0)

        real_ev = hit | scattered      # the events that take a depth
        active = real_ev | passthru
        ns, ng = isect["ns"], isect["ng"]
        t1, t2 = _shading_frame(ns, isect["dpdu"])
        wo_local = _to_local(ns, t1, t2, isect["wo"])
        with spans.span("material.params", depth=it):
            bp = mtl.get_bsdf_params(scene.mat_pool, isect["mat"], lam,
                                     scene.bxdf_tags, uv=isect["uv"],
                                     spectra_pool=scene.spectra_pool,
                                     spec_cache=spec_cache,
                                     textures=textures)

        # --- next-event estimation at the real events ---
        if ls.n_lights > 0:
            with spans.span("nee", depth=it):
                p_shade = torch.where(scattered[:, None], p_med, isect["p"])
                L = L + beta * _sample_ld(
                    scene, sampler, px, py, sample_index, lam, spec_cache,
                    p_shade, isect["p_err"], ns, ng, t1, t2, wo_local, bp,
                    real_ev, depth, r_u, scattered, -d, fl["g"], seed_fl)
        if it + 1 == n_iters:
            break   # the last iteration's sample and roulette add nothing

        # --- the next direction: BSDF or phase function ---
        base = CAM_DIMS + depth * DIMS_PER_BOUNCE
        uc = smp.sample_1d(sampler, px, py, sample_index, base + 3) \
            if need_uc else None
        u2 = smp.sample_2d(sampler, px, py, sample_index, base + 4)
        with spans.span("bsdf.sample", depth=it):
            bs = bxdfs.bsdf_sample(bp, wo_local, uc, u2)
        wi_world = _to_world(ns, t1, t2, bs["wi"])
        throughput = bs["f"] * safe_div(torch.abs(bs["wi"][:, 2]),
                                        bs["pdf"])[:, None]
        wi_hg, pdf_hg = usamp.sample_henyey_greenstein(u2, fl["g"], -d)
        s3 = scattered[:, None]
        wi_world = torch.where(s3, wi_hg, wi_world)
        throughput = torch.where(s3, 1.0, throughput)
        sel_pdf = torch.where(scattered, pdf_hg, bs["pdf"])
        sel_valid = torch.where(scattered, pdf_hg > 0, bs["valid"])
        sel_spec = torch.where(scattered, False, bs["specular"])
        if has_ifaces:
            # a crossing goes straight on, its state untouched, no depth
            wi_world = torch.where(passthru[:, None], d, wi_world)
            throughput = torch.where(passthru[:, None], 1.0, throughput)
            sel_valid = sel_valid | passthru
            sel_spec = torch.where(passthru, spec_bounce, sel_spec)
        beta_new = beta * throughput
        r_l_new = r_u / torch.clamp(sel_pdf, min=_EPS)[:, None]
        r_l = torch.where(passthru[:, None], r_l, r_l_new) if has_ifaces \
            else r_l_new
        first_disp = bs["dispersed"] & ~sec_term & ~passthru
        beta_new = torch.where(first_disp[:, None], beta_new * disp_weight,
                               beta_new)
        sec_term = sec_term | (bs["dispersed"] & real_ev)
        active = active & sel_valid & (beta_new > 0).any(dim=-1) & \
            (r_u > 0).any(dim=-1)
        beta = torch.where(active[:, None], beta_new, beta)
        eta_scale = eta_scale * torch.where(scattered | passthru, 1.0,
                                            bs["eta_scale"])

        # --- Russian roulette on max(beta) eta_scale / avg(r_u) ---
        with spans.span("wave.roulette", depth=it):
            rr_max = beta.amax(dim=-1) * eta_scale / torch.clamp(_avg(r_u),
                                                                 min=_EPS)
            u_rr = smp.sample_1d(sampler, px, py, sample_index, base + 6)
            q = torch.clamp(1.0 - rr_max, min=0.0)
            do_rr = (depth >= opts.rr_start_depth) & (rr_max < 1.0) & \
                ~passthru
            killed = do_rr & (u_rr < q)
            active = active & ~killed
            beta = torch.where((do_rr & ~killed)[:, None],
                               beta / torch.clamp(1.0 - q, min=1e-6)[:, None],
                               beta)

        o_next = sc.offset_ray_origin_exact(isect["p"], isect["p_err"], ng,
                                            wi_world)
        o_next = torch.where(s3, p_med + 1e-5 * wi_world, o_next)
        if has_ifaces:
            # a crossing: on from the interface point, into med_in behind
            # the geometric normal or med_out in front of it
            o_if = sc.offset_ray_origin(o + d * ii["t"][:, None], ii["ng"], d)
            o_next = torch.where(passthru[:, None], o_if, o_next)
            entering = vm.dot(d, ii["ng"]) < 0
            cur_med = torch.where(passthru, torch.where(
                entering, ii["med_in"], ii["med_out"]), cur_med)
        depth = depth + real_ev.to(torch.int64)
        active = active & (depth < opts.max_depth)
        o, d, spec_bounce = o_next, wi_world, sel_spec
    return L


def render_wave(scene, camera, sampler, filt, pixel_idx, sample_index,
                opts: PathOptions):
    """One volumetric wave over flat pixel ids (N,) and sample indices
    (N,), through the path integrator's front end. Returns (spectral L
    (N, 4), wavelengths, filter weight (N,))."""
    px, py, swl = camera_lanes(camera, sampler, pixel_idx, sample_index)
    o, d, weight = camera_rays(camera, sampler, filt, px, py, sample_index)
    return trace_paths(scene, sampler, px, py, sample_index, o, d, swl,
                       opts), swl, weight
