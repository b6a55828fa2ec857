"""Path integrator (counterpart of pbrt_tpu_torch/integrators/path.py),
cut to what the benchmark's cells reach: one wave of camera paths, through
the megakernel's plain version or the general wave.

`trace_paths` takes camera rays. As in the reference, it hands an eligible
scene's wave to the megakernel with the rays given (`megawave.trace`)
unless `PathOptions.megakernel` is False or the rays carry a `time`; the
reference does so on its chip only, the port wherever it runs.
`render_wave` makes the rays itself: the megakernel with in-kernel camera
rays (`megawave.trace_full`) where that is eligible, else the general
wave, never the rays-in megakernel (the reference passes the camera's
time for that).

The general wave keeps every lane's state in tensors and runs one depth
at a time: the closest hit, emission with MIS at area-light hits (under
the light-BVH or exhaustive sampler, the pick's pmf taken from the ray's
origin), escaped rays to the image and uniform infinite lights (an MIS
weight of 1 at depth 0 and after a specular bounce), next-event
estimation with an any-hit shadow ray (the light picked at the shading
point), the BSDF sample (diffuse, conductor or dielectric), the
dispersion of a spectral dielectric (the secondary wavelengths terminated
once, the hero's weight times 4) and Russian roulette on max(beta) times
the accumulated eta_scale, with the reference's sampler dimension layout
(camera dims 0-5, then 11 per bounce: light pick +0, light point +1/+2,
BSDF lobe choice +3 and direction +4/+5, roulette +6; the lobe choice is
drawn only where the dielectric reads it). Each lane carries the
reference's ray cone (its width and spread: the spread starts at the
camera's pixel spread and gains 0.25 at each non-specular bounce, the
width grows by spread times the hit distance), whose uv footprint picks a
texture's MIP level. The shading frame's +x follows the hit's dpdu. Dead
lanes are masked, and their rays are queried with t_max = -1, which every
query answers with a miss. The reference's lane compaction and morton ray
sort are TPU workarounds and are left out.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import bxdfs
from .. import cameras as cam_mod
from .. import filters as flt
from .. import lights as lgt
from .. import lightsamplers as lsamp
from .. import materials as mtl
from .. import samplers as smp
from .. import scene_core as sc
from ..ops import megawave
from ..utils import spectrum as spc
from ..utils import vecmath as vm
from ..utils.math import INV_4PI, power_heuristic, safe_div

CAM_DIMS = megawave.CAM_DIMS
DIMS_PER_BOUNCE = megawave.DIMS_PER_BOUNCE


@dataclasses.dataclass(frozen=True)
class PathOptions:
    max_depth: int = 5
    rr_start_depth: int = 1
    # the megakernel for eligible scenes: "auto" or True (used whenever the
    # scene and sampler, and for render_wave the camera and filter, are
    # eligible) or False (the general wave)
    megakernel: object = "auto"


def _megakernel_allowed(opts) -> bool:
    mk = opts.megakernel
    if mk is False:
        return False
    if mk is not True and mk != "auto":
        raise ValueError(f"PathOptions.megakernel must be False, True or "
                         f"'auto', not {mk!r}")
    return True


def _use_megawave(scene, sampler, opts, time=None) -> bool:
    """The reference's routing of trace_paths to the rays-in megakernel."""
    return (time is None and _megakernel_allowed(opts)
            and megawave.eligible(scene, sampler))


def _to_local(ns, t1, t2, w):
    return torch.stack([vm.dot(w, t1), vm.dot(w, t2), vm.dot(w, ns)],
                       dim=-1)


def _to_world(ns, t1, t2, w):
    return w[:, 0:1] * t1 + w[:, 1:2] * t2 + w[:, 2:3] * ns


def _shading_frame(ns, dpdu):
    """Orthonormal (t1, t2), t1 along dpdu projected off ns."""
    t1 = dpdu - vm.dot(dpdu, ns)[:, None] * ns
    bad = vm.length_squared(t1) < 1e-12
    t1f, _ = vm.coordinate_system(ns)
    t1 = vm.normalize(torch.where(bad[:, None], t1f, t1))
    return t1, vm.cross(ns, t1)


def _nee(scene, sampler, px, py, si, lam, spec_cache, isect, ns, ng, t1, t2,
         wo_local, bp, active, depth):
    """Next-event estimation (reference SampleLd): one light sample and its
    shadow ray. Returns the (N, 4) contribution before beta."""
    base = CAM_DIMS + depth * DIMS_PER_BOUNCE
    u_pick = smp.sample_1d(sampler, px, py, si, base)
    u_l = smp.sample_2d(sampler, px, py, si, base + 1)
    li_idx, pmf = lsamp.sample_light(scene.light_sampler, u_pick,
                                     scene.alias_rows, p=isect["p"])
    ls = lgt.sample_li(scene.lights_packed, torch.clamp(li_idx, min=0),
                       isect["p"], u_l, lam, scene.spectra_pool,
                       scene.scene_radius, scene.light_tags, spec_cache,
                       env=scene.env)
    wi = ls["wi"]
    wi_local = _to_local(ns, t1, t2, wi)
    f = bxdfs.bsdf_f(bp, wo_local, wi_local) * \
        torch.abs(wi_local[:, 2])[:, None]
    pdf_b = bxdfs.bsdf_pdf(bp, wo_local, wi_local)
    pdf_l = ls["pdf"] * pmf
    ok = active & ls["valid"] & (pdf_l > 0) & (f > 0).any(dim=-1)
    o_sh = sc.offset_ray_origin_exact(isect["p"], isect["p_err"], ng, wi)
    dist = vm.length(ls["p_light"] - o_sh)
    ok = ok & ~sc.intersect_p(scene, o_sh, wi,
                              torch.where(ok, dist * 0.999, -1.0))
    w_mis = torch.where(ls["is_delta"], 1.0,
                        power_heuristic(1.0, pdf_l, 1.0, pdf_b))
    Ld = f * ls["L"] * safe_div(w_mis, pdf_l)[:, None]
    return torch.where(ok[:, None], Ld, 0.0)


def trace_paths(scene, sampler, px, py, sample_index, o, d,
                swl: spc.SampledWavelengths, opts: PathOptions,
                cone_spread=None, time=None):
    """Trace one wave of paths from camera rays o, d (N, 3). Returns L
    (N, 4) spectral radiance (the film divides by swl.pdf). cone_spread:
    the rays' cone spread (cameras.pixel_cone_spread; None: 0, level-0
    texture lookups). time: the rays' time, if they have one (it keeps
    them off the megakernel, as in the reference)."""
    if _use_megawave(scene, sampler, opts, time):
        return megawave.trace(scene, sampler, px, py, sample_index, o, d,
                              swl.lam, max_depth=opts.max_depth,
                              rr_start=opts.rr_start_depth)
    return _general_wave(scene, sampler, px, py, sample_index, o, d, swl,
                         opts, cone_spread)


def _general_wave(scene, sampler, px, py, sample_index, o, d, swl, opts,
                  cone_spread=None):
    """The general wave of trace_paths."""
    N = o.shape[0]
    lam = swl.lam
    spec_cache = None
    if scene.spectra_pool.shape[0] <= lgt.SPEC_CACHE_MAX:
        spec_cache = lgt.eval_all_spectra(scene.spectra_pool, lam)
    ls = scene.light_sampler
    beta = torch.ones((N, 4), dtype=torch.float32, device=o.device)
    L = torch.zeros_like(beta)
    active = torch.ones((N,), dtype=torch.bool, device=o.device)
    prev_pdf = torch.ones((N,), dtype=torch.float32, device=o.device)
    specular = torch.zeros_like(active)     # the last bounce was specular
    eta_scale = torch.ones_like(prev_pdf)
    sec_term = torch.zeros_like(active)     # secondary wavelengths ended
    disp_weight = torch.tensor([4.0, 0.0, 0.0, 0.0], device=o.device)
    cone_w = torch.zeros_like(prev_pdf)     # the ray cone's width
    cone_s = torch.full_like(prev_pdf, 0.0 if cone_spread is None
                             else float(cone_spread))
    textures = scene.textures if scene.has_textures else None

    def mis_weight(depth, pdf_light):
        """The emission's MIS weight against light sampling: 1 at depth 0
        and after a specular bounce."""
        if depth == 0:
            return torch.ones_like(pdf_light)
        return torch.where(specular, 1.0,
                           power_heuristic(1.0, prev_pdf, 1.0, pdf_light))

    for depth in range(opts.max_depth):
        isect = sc.intersect(scene, o, d, torch.where(active, 1e30, -1.0))
        hit = isect["hit"] & active
        cone_w = cone_w + cone_s * torch.where(isect["hit"], isect["t"], 0.0)

        # --- emitted radiance at hits of emissive triangles ---
        if scene.has_area_lights:
            is_emitter = hit & (isect["light"] >= 0)
            lrow = scene.lights_packed[torch.clamp(isect["light"], min=0)]
            Le = lgt.area_light_radiance(lrow, isect["ng"], isect["wo"], lam,
                                         scene.spectra_pool, spec_cache)
            if lsamp.positional(ls):
                # the pick's pmf from the ray's origin
                pick_pmf = lsamp.light_pmf(
                    ls, torch.clamp(isect["light"], min=0), p=o)
            else:
                pick_pmf = lrow[:, 14]
            pdf_light = lgt.pdf_li_area_tri(o, d, isect["p"], isect["p0"],
                                            isect["p1"], isect["p2"])
            pdf_light = pdf_light * pick_pmf
            w_emit = mis_weight(depth, pdf_light)
            L = L + torch.where(is_emitter[:, None],
                                beta * Le * w_emit[:, None], 0.0)

        # --- escaped rays: the image infinite light ---
        if scene.env is not None:
            escaped = active & ~isect["hit"]
            Le_env = lgt.env_radiance(scene.env, d, lam)
            pdf_env = lgt.env_pdf_li(scene.env, d) * float(
                ls.pmf_table[scene.env.light_index])
            w_env = mis_weight(depth, pdf_env)
            L = L + torch.where(escaped[:, None],
                                beta * Le_env * w_env[:, None], 0.0)

        # --- escaped rays: uniform infinite lights ---
        if scene.inf_indices:
            escaped = active & ~isect["hit"]
            Le_inf = lgt.infinite_light_radiance(
                scene.lights_packed, scene.inf_indices, lam,
                scene.spectra_pool, spec_cache)
            pdf_inf = torch.full_like(prev_pdf, float(
                np.float32(ls.pmf_table[scene.inf_indices[0]])
                * np.float32(INV_4PI)))
            w_inf = mis_weight(depth, pdf_inf)
            L = L + torch.where(escaped[:, None],
                                beta * Le_inf * w_inf[:, None], 0.0)

        active = hit
        ns, ng = isect["ns"], isect["ng"]
        t1, t2 = _shading_frame(ns, isect["dpdu"])
        wo_local = _to_local(ns, t1, t2, isect["wo"])
        footprint = None
        if textures is not None:
            # the cone's width in uv, through the parametric derivatives
            inv_dpdu = 1.0 / torch.clamp(vm.length(isect["dpdu"]), min=1e-8)
            inv_dpdv = 1.0 / torch.clamp(vm.length(isect["dpdv"]), min=1e-8)
            footprint = cone_w * torch.maximum(inv_dpdu, inv_dpdv)
        bp = mtl.get_bsdf_params(scene.mat_pool, isect["mat"], lam,
                                 scene.bxdf_tags, uv=isect["uv"],
                                 spectra_pool=scene.spectra_pool,
                                 spec_cache=spec_cache, textures=textures,
                                 footprint=footprint)

        # --- next-event estimation ---
        if ls.n_lights > 0:
            L = L + beta * _nee(scene, sampler, px, py, sample_index, lam,
                                spec_cache, isect, ns, ng, t1, t2, wo_local,
                                bp, active, depth)
        if depth + 1 == opts.max_depth:
            break   # the last bounce's sample and roulette add nothing to L

        # --- BSDF sample for the next bounce ---
        base = CAM_DIMS + depth * DIMS_PER_BOUNCE
        uc = None
        if bxdfs.BXDF_DIELECTRIC in scene.bxdf_tags:
            uc = smp.sample_1d(sampler, px, py, sample_index, base + 3)
        u2 = smp.sample_2d(sampler, px, py, sample_index, base + 4)
        bs = bxdfs.bsdf_sample(bp, wo_local, uc, u2)
        wi_world = _to_world(ns, t1, t2, bs["wi"])
        throughput = bs["f"] * safe_div(torch.abs(bs["wi"][:, 2]),
                                        bs["pdf"])[:, None]
        beta_new = beta * throughput
        if bxdfs.BXDF_DIELECTRIC in scene.bxdf_tags:
            # dispersion: the first dispersive event ends the secondary
            # wavelengths and weights the hero by 4 (reference
            # TerminateSecondary, idempotent)
            first = bs["dispersed"] & ~sec_term
            beta_new = torch.where(first[:, None], beta_new * disp_weight,
                                   beta_new)
            sec_term = sec_term | (bs["dispersed"] & active)
        active = active & bs["valid"] & (beta_new > 0).any(dim=-1)
        beta = torch.where(active[:, None], beta_new, beta)
        eta_scale = eta_scale * bs["eta_scale"]

        # --- Russian roulette on max(beta) * eta_scale ---
        if depth >= opts.rr_start_depth:
            rr_max = beta.amax(dim=-1) * eta_scale
            u_rr = smp.sample_1d(sampler, px, py, sample_index, base + 6)
            q = torch.clamp(1.0 - rr_max, min=0.0)
            do_rr = rr_max < 1.0
            killed = do_rr & (u_rr < q)
            active = active & ~killed
            beta = torch.where((do_rr & ~killed)[:, None],
                               beta / torch.clamp(1.0 - q, min=1e-6)[:, None],
                               beta)
        o = sc.offset_ray_origin_exact(isect["p"], isect["p_err"], ng,
                                       wi_world)
        d = wi_world
        prev_pdf = bs["pdf"]
        specular = bs["specular"]
        cone_s = cone_s + torch.where(specular, 0.0, 0.25)
    return L


def camera_lanes(camera, sampler, pixel_idx, sample_index):
    """A wave's lanes from flat pixel ids (N,) and sample indices (N,):
    (px, py, the sampled wavelengths)."""
    px = pixel_idx % camera.width
    py = pixel_idx // camera.width
    u_lam = smp.sample_1d(sampler, px, py, sample_index, 5)
    return px, py, spc.sample_visible_wavelengths(u_lam)


def camera_rays(camera, sampler, filt, px, py, sample_index):
    """The general wave's camera front end: each lane's filter sample and
    pinhole ray. Returns (o, d (N, 3), filter weight (N,))."""
    u_pix = smp.sample_pixel_2d(sampler, px, py, sample_index, 0)
    f_off, f_weight = flt.sample(filt, u_pix)
    p_film = torch.stack([px.to(torch.float32) + 0.5 + f_off[:, 0],
                          py.to(torch.float32) + 0.5 + f_off[:, 1]], dim=-1)
    o, d, cam_wt = cam_mod.generate_ray_weighted(camera, p_film)
    return o, d, f_weight * cam_wt


def render_wave(scene, camera, sampler, filt, pixel_idx: torch.Tensor,
                sample_index: torch.Tensor, opts: PathOptions):
    """One wave over flat pixel ids (N,) and per-lane sample indices (N,).
    Returns (spectral L (N, 4), wavelengths, filter weight (N,))."""
    px, py, swl = camera_lanes(camera, sampler, pixel_idx, sample_index)
    if _megakernel_allowed(opts) and megawave.eligible_full(scene, sampler,
                                                             camera, filt):
        L, fw = megawave.trace_full(scene, sampler, camera, filt, px, py,
                                    sample_index, swl.lam,
                                    max_depth=opts.max_depth,
                                    rr_start=opts.rr_start_depth)
        return L, swl, fw
    o, d, weight = camera_rays(camera, sampler, filt, px, py, sample_index)
    L = _general_wave(scene, sampler, px, py, sample_index, o, d, swl, opts,
                      cam_mod.pixel_cone_spread(camera))
    return L, swl, weight
