"""Whole-path megakernel for diffuse / area-light scenes (counterpart of
pbrt_tpu/ops/megawave.py: megakernel v2, `trace_full`, and megakernel v1,
`trace`).

One lane traces one whole path: pixel decode from the morton|spp index,
ZSobol camera dimensions, gaussian filter importance sample (Giles erf^-1),
pinhole ray -- or, for `trace`, the camera ray given from outside -- then
per depth the closest hit, emission with power-heuristic MIS, next-event
estimation with a uniform or power-alias light pick and an any-hit shadow
ray, the diffuse cosine BSDF sample and Russian roulette. Outputs: L at
the lane's 4 wavelengths, and the filter weight when the kernel made the
camera ray.

`wave_full` is the wrapper: CPU tensors run `wave_full_plain`, which is the
reference's `_wave_kernel_full` / `_wave_kernel` + `_path_loop` as tensor
ops over all lanes; CUDA tensors launch csrc/megawave.cu (one kernel, the
camera section switched off when rays are given; persistent warps that
start a new lane when a path ends), or raise. The triangle,
attribute, light and material tables keep the reference layouts
(`scene_tables`). What the reference did for the TPU only -- one-hot row
selects, ints held as f32, compile-time depth unrolling and ablation knobs
-- is not carried over: rows are read by integer index and every loop
bound is a run-time argument.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from .. import bxdfs
from .. import cameras as cam_mod
from .. import filters as flt
from .. import lights as lgt
from .. import materials as mtl
from .. import samplers as smp
from .. import spans
from ..utils import lowdiscrepancy as ld
from ..utils import rng as prng
from ..utils.math import (INV_PI, next_float_down, next_float_up,
                          power_heuristic, safe_div)
from . import LaunchCounter
from .tri_intersect import GROUP, tri_intersect_plain

# per-triangle attribute row: p0(3) p1(3) p2(3) mat light
ATTR_COLS = 11
# per-light row: va(3) vb(3) vc(3) scale pmf two_sided q alias pmf_self
# pmf_alias
LIGHT_COLS = 16
# sampler dimension layout (integrators/path.py of the reference): camera
# dims 0-5 (dim 5 = wavelengths), then 11 per bounce: NEE light pick +0,
# light point +1/+2, BSDF +4/+5, RR +6
CAM_DIMS = 6
DIMS_PER_BOUNCE = 11
# camera table: c2w rows 0-2 | screen window | tan_half_fov | W | H
CAM_COLS = 19

# gamma(7) error-bound factor, rounded once from float64 like the reference
_EPS = np.finfo(np.float32).eps * 0.5
_G7 = float(np.float32((7 * _EPS) / (1 - 7 * _EPS)))


class MegaMeta(NamedTuple):
    """Static scene metadata of an eligible scene (reference Scene.mega)."""
    n_tris: int
    n_mats: int
    n_lights: int
    light_spec: int    # spectra_pool row shared by every light
    ls_uniform: bool   # uniform light sampler (else power alias)


counter = LaunchCounter("megawave")


def n_dims(max_depth: int) -> int:
    """Sampler dimensions a path of max_depth may draw: 0 ... 6 + 11 *
    max_depth."""
    return CAM_DIMS + 1 + DIMS_PER_BOUNCE * max_depth


@functools.lru_cache(maxsize=16)
def seed_table(seed: int, max_depth: int) -> np.ndarray:
    """(n_dims, 3) uint32 per-dimension scramble seeds, the words the
    reference bakes at trace time (_zsobol_index / _zs_1d / _zs_2d):
    [index-shuffle seed, first-axis seed, second-axis seed]. Read-only:
    one table serves every wave of a render."""
    rows = [(prng.hash_u32(d, seed, smp._INDEX_SALT), prng.hash_u32(d, seed),
             prng.hash_u32(d, seed, smp._SECOND_SALT))
            for d in range(n_dims(max_depth))]
    table = np.asarray(rows, np.uint32)
    table.setflags(write=False)
    return table


@functools.lru_cache(maxsize=1)
def sobol_cols01() -> np.ndarray:
    """(64,) uint32: the first 32 columns of Sobol' dimensions 0 and 1."""
    m = ld.sobol_matrices()
    return np.concatenate([m[0][:32], m[1][:32]]).astype(np.uint32)


@functools.lru_cache(maxsize=1)
def sobol_table() -> np.ndarray:
    """(1024,) uint32, the kernel's Sobol' table: dimension 1's four
    256-entry byte tables (entry b of table k: the xor of the columns
    8k + i whose bit i is set in b), so that its product is four lookups.
    Dimension 0's product is the bit reversal and needs no table."""
    cols = sobol_cols01()[32:]
    b = np.arange(256)[:, None]
    bits = ((b >> np.arange(8)) & 1).astype(bool)            # (256, 8)
    table = np.concatenate([np.bitwise_xor.reduce(
        np.where(bits, cols[8 * k:8 * k + 8], 0), axis=1)
        for k in range(4)]).astype(np.uint32)
    table.setflags(write=False)
    return table


def encode_mi(mi: torch.Tensor) -> torch.Tensor:
    """The morton|spp lane index, u32 values in int64, as the int32 bits
    the kernels read and write (FullWave.mi)."""
    return torch.where(mi >= 2 ** 31, mi - 2 ** 32, mi).to(torch.int32)


def widen_mi(mi: torch.Tensor) -> torch.Tensor:
    """FullWave.mi's int32 bits as the u32 values in int64 that the plain
    version's arithmetic takes."""
    return mi.to(torch.int64) & prng.MASK32


def _on_card(a: np.ndarray, device) -> torch.Tensor:
    """u32 values as int32 bits on the card (the kernel reads uint32)."""
    return torch.as_tensor(a.view(np.int32).copy(), device=device)


@functools.lru_cache(maxsize=16)
def device_seeds(device: torch.device, seed: int, max_depth: int):
    """The seed table on the card, uploaded once per (device, seed,
    max_depth); the megakernel and the front end's lanes kernel read it."""
    return _on_card(seed_table(seed, max_depth), device)


@functools.lru_cache(maxsize=4)
def _device_sobol(device: torch.device):
    """The Sobol' table on the card, uploaded once per device."""
    return _on_card(sobol_table(), device)


@functools.lru_cache(maxsize=8)
def _next_lane(device: torch.device, stream: int):
    """The kernel's lane counter: one int32 a (device, stream), which each
    launch zeroes on its stream before the kernel reads it."""
    return torch.empty((1,), dtype=torch.int32, device=device)


def scene_tables(scene):
    """(attr, light, mat) flat float32 tables in the reference layout
    (reference megawave.scene_tables); the scene builder packs them."""
    return scene.attr, scene.light, scene.mat


def camera_table(camera, device) -> torch.Tensor:
    """(19,) float32 [c2w rows 0-2 (12) | smin0 smin1 smax0 smax1 |
    tan_half_fov | W | H]."""
    m = np.asarray(camera.c2w_m, np.float32)
    cam = np.concatenate([
        m[:3].reshape(-1),
        np.asarray([camera.screen_min[0], camera.screen_min[1],
                    camera.screen_max[0], camera.screen_max[1],
                    camera.tan_half_fov, camera.width, camera.height],
                   np.float32)])
    return torch.as_tensor(cam, device=device)


def eligible(scene, sampler) -> bool:
    """Static megakernel eligibility (reference megawave.eligible)."""
    return (getattr(scene, "mega", None) is not None
            and sampler.kind == smp.SAMPLER_ZSOBOL)


def eligible_full(scene, sampler, camera, filt) -> bool:
    """In-kernel camera eligibility (reference megawave.eligible_full):
    pinhole perspective camera, gaussian filter, and a morton|spp index
    that fits 32 bits."""
    if not eligible(scene, sampler):
        return False
    if camera.kind != cam_mod.CAMERA_PERSPECTIVE or camera.has_lens:
        return False
    if filt.kind != flt.FILTER_GAUSSIAN:
        return False
    side_bits = max(1, math.ceil(math.log2(max(camera.width,
                                               camera.height))))
    return 2 * side_bits + sampler.log2_spp <= 32


@dataclasses.dataclass
class FullWave:
    """Inputs of one megakernel launch. Tensors live on one device; mi is
    the morton|spp lane index, int32 holding its u32 bits (encode_mi; the
    kernels read and write that form); lam and le are (N, 4).
    The camera rays are made in the kernel from cam and filt, or given as
    o, d (N, 3) (then cam and filt are None)."""
    cam: torch.Tensor | None
    tri: torch.Tensor
    attr: torch.Tensor
    light: torch.Tensor
    mat: torch.Tensor
    mi: torch.Tensor
    lam: torch.Tensor
    le: torch.Tensor
    seed: int               # the sampler's seed
    n_real: int
    n_mats: int
    n_lights: int
    max_depth: int
    rr_start: int
    B: int
    log2_spp: int
    ls_uniform: bool
    filt: flt.Filter | None     # gaussian
    o: torch.Tensor | None = None
    d: torch.Tensor | None = None

    @property
    def seeds(self) -> np.ndarray:
        return seed_table(self.seed, self.max_depth)


def light_spectrum(scene, lam):
    """The light spectrum at the lanes' wavelengths lam (N, 4): the
    spectra_pool row every light of an eligible scene shares."""
    N = lam.shape[0]
    return lgt.eval_light_spectrum(
        scene.spectra_pool,
        torch.full((N,), scene.mega.light_spec, dtype=torch.int64,
                   device=lam.device),
        torch.ones((N,), dtype=torch.float32, device=lam.device), lam)


def wave_of(scene, sampler, mi, lam, le, max_depth, rr_start,
            **rays) -> FullWave:
    """The wave over the lanes' index mi, wavelengths lam and light
    spectrum le, with the scene's constant tables; `rays`: cam and filt,
    or o and d."""
    meta = scene.mega
    attr, light, mat = scene_tables(scene)
    return FullWave(
        tri=scene.tri_pallas, attr=attr, light=light, mat=mat, mi=mi,
        lam=lam, le=le, seed=int(sampler.seed),
        n_real=meta.n_tris, n_mats=meta.n_mats, n_lights=meta.n_lights,
        max_depth=int(max_depth), rr_start=int(rr_start),
        B=smp.zsobol_index_bits(sampler), log2_spp=sampler.log2_spp,
        ls_uniform=bool(meta.ls_uniform), **rays)


def _prepare(scene, sampler, px, py, sample_index, lam, max_depth,
             rr_start, **rays) -> FullWave:
    """Front end of both entries in plain torch: the lane index, the light
    spectrum at the lanes' wavelengths, and the constant tables; `rays`:
    cam and filt, or o and d."""
    return wave_of(scene, sampler,
                   encode_mi(smp.morton_index(sampler, px, py, sample_index)),
                   lam.contiguous(), light_spectrum(scene, lam).contiguous(),
                   max_depth, rr_start, **rays)


@spans.span("megawave.prepare")
def prepare_full(scene, sampler, camera, filt, px, py, sample_index, lam,
                 max_depth=5, rr_start=1) -> FullWave:
    """The wave of trace_full: camera rays made in the kernel."""
    return _prepare(scene, sampler, px, py, sample_index, lam, max_depth,
                    rr_start, cam=camera_table(camera, lam.device),
                    filt=filt)


def prepare_rays(scene, sampler, px, py, sample_index, o, d, lam,
                 max_depth=5, rr_start=1) -> FullWave:
    """The wave of trace: camera rays o, d (N, 3) given."""
    return _prepare(scene, sampler, px, py, sample_index, lam, max_depth,
                    rr_start, cam=None, filt=None, o=o.contiguous(),
                    d=d.contiguous())


def trace_full(scene, sampler, camera, filt, px, py, sample_index, lam,
               max_depth=5, rr_start=1):
    """Megakernel path trace with in-kernel camera rays. Returns
    (L (N, 4), filter_weight (N,)). Gate with eligible_full()."""
    return wave_full(prepare_full(scene, sampler, camera, filt, px, py,
                                  sample_index, lam, max_depth, rr_start))


def trace(scene, sampler, px, py, sample_index, o, d, lam, max_depth=5,
          rr_start=1):
    """Megakernel path trace of the camera rays o, d (N, 3) (reference
    megawave.trace). Returns L (N, 4). Gate with eligible()."""
    return wave_full(prepare_rays(scene, sampler, px, py, sample_index, o, d,
                                  lam, max_depth, rr_start))[0]


def wave_full(w: FullWave):
    """The wrapper: plain version for CPU tensors, kernel for CUDA.
    Returns (L (N, 4), filter weight (N,), None when rays were given)."""
    tensors = (w.cam, w.tri, w.attr, w.light, w.mat, w.mi, w.lam, w.le,
               w.o, w.d)
    devices = {x.device.type for x in tensors if x is not None}
    if devices == {"cpu"}:
        with spans.span("megawave.kernel"):
            return wave_full_plain(w)
    if devices != {"cuda"}:
        raise ValueError(f"megawave: tensors on mixed devices {devices}")
    return _launch(w)


# ---------------------------------------------------------------------------
# Plain PyTorch version (component tuples of (N,) tensors)

def _dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross3(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _normalize3(a):
    inv = torch.rsqrt(torch.clamp(_dot3(a, a), min=1e-30))
    return (a[0] * inv, a[1] * inv, a[2] * inv), 1.0 / inv


def _offset_origin(p, p_err, ng, w):
    """Offset a ray origin past the hit's error bounds, stepping each
    coordinate one float away from the surface."""
    dmag = torch.abs(ng[0]) * p_err[0] + torch.abs(ng[1]) * p_err[1] + \
        torch.abs(ng[2]) * p_err[2]
    sgn = torch.where(_dot3(w, ng) < 0, -1.0, 1.0)
    out = []
    for c in range(3):
        off = dmag * ng[c] * sgn
        po = p[c] + off
        out.append(torch.where(off > 0, next_float_up(po),
                               torch.where(off < 0, next_float_down(po), po)))
    return tuple(out)


def _coordinate_system_t1(v):
    """First tangent of the Duff et al. branchless frame around v."""
    sign = torch.where(v[2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + v[2])
    b = v[0] * v[1] * a
    return (1.0 + sign * v[0] * v[0] * a, sign * b, -sign * v[0])


class _ZSobol:
    """ZSobol draws of one wave with the host seed table."""

    def __init__(self, mi, seeds, B):
        self.mi, self.seeds, self.B = mi, seeds, B

    def _index(self, dim):
        s = int(self.seeds[dim, 0])
        v = (self.mi << (32 - self.B)) & prng.MASK32
        return ld.fast_owen_scramble(v, s) >> (32 - self.B)

    def _axis(self, idx, axis, dim):
        return ld.u32_to_sample(ld.fast_owen_scramble(
            ld.sobol_sample_u32(idx, axis), int(self.seeds[dim, 1 + axis])))

    def d1(self, dim):
        return self._axis(self._index(dim), 0, dim)

    def d2(self, dim):
        idx = self._index(dim)
        return self._axis(idx, 0, dim), self._axis(idx, 1, dim)


def _camera_rays(w: FullWave, zs: _ZSobol):
    """Pixel decode, gaussian filter sample and pinhole ray (reference
    _wave_kernel_full) of the lanes zs draws for. Returns (o, d, filter
    weight)."""
    cam = w.cam
    pm = zs.mi >> w.log2_spp
    pxf = prng.compact_bits_2(pm).to(torch.float32)
    pyf = prng.compact_bits_2(pm >> 1).to(torch.float32)
    u0, u1 = zs.d2(0)
    f_off, fw = flt.sample(w.filt, torch.stack([u0, u1], dim=-1))
    fx, fy = f_off[:, 0], f_off[:, 1]

    W, H = cam[17], cam[18]
    sx = cam[12] + ((pxf + 0.5 + fx) / W) * (cam[14] - cam[12])
    sy = cam[15] - ((pyf + 0.5 + fy) / H) * (cam[15] - cam[13])
    dcx = sx * cam[16]
    dcy = sy * cam[16]
    dw = (cam[0] * dcx + cam[1] * dcy + cam[2],
          cam[4] * dcx + cam[5] * dcy + cam[6],
          cam[8] * dcx + cam[9] * dcy + cam[10])
    d, _ = _normalize3(dw)
    o = tuple(cam[i].expand(pxf.shape) for i in (3, 7, 11))
    return o, d, fw


def wave_full_plain(w: FullWave):
    """Plain PyTorch version of the megakernel: all lanes, all depths, as
    masked tensor ops (reference _path_loop). Returns (L (N, 4), fw (N,),
    None when rays were given). counter.work: what the kernel runs on these
    inputs (`_path_loop`), for its bound."""
    counter.plain += 1
    zs = _ZSobol(widen_mi(w.mi), w.seeds, w.B)
    if w.o is None:
        o, d, fw = _camera_rays(w, zs)
    else:
        o = tuple(w.o[:, c] for c in range(3))
        d = tuple(w.d[:, c] for c in range(3))
        fw = None
    L, counter.work = _path_loop(w, zs, o, d)
    return L, fw


def _warp_busy_share(path_len: torch.Tensor) -> float:
    """The share of a warp's issue slots in the bounce loop that run a live
    path when 32 consecutive lanes trace side by side: the sum of the
    lanes' path lengths over 32 x the longest, summed over warps."""
    n = path_len.shape[0]
    lens = torch.nn.functional.pad(path_len, (0, -n % 32)).reshape(-1, 32)
    longest = int(lens.amax(dim=1).sum())
    return int(lens.sum()) / (32 * longest) if longest else 1.0


def _path_loop(w: FullWave, zs: _ZSobol, o, d):
    """Every depth of every lane from camera rays o, d (component tuples).
    Returns (L (N, 4), work): the kernel's work on these lanes, each count
    summed over lane-depths. live_lane_depths: closest-hit queries (lanes
    still alive), live_by_depth: the same per depth; hits: lanes shaded
    (the frame, albedo and the light sample of next-event estimation);
    emissions: emissive hits weighed by MIS; shadow_rays, shadow_tests:
    the shadow rays cast and the triangles their any-hit scans test (the
    groups of four up to the first that holds a hit, every real triangle
    when unoccluded); unoccluded: light contributions added; bsdf_samples,
    rr_draws: BSDF samples and roulette draws; warp_busy_share
    (`_warp_busy_share`)."""
    work = dict(live_by_depth=[], hits=0, emissions=0, shadow_rays=0,
                shadow_tests=0, unoccluded=0, bsdf_samples=0, rr_draws=0)
    path_len = torch.zeros(w.lam.shape[0], dtype=torch.int64,
                           device=w.lam.device)
    attr_rows = w.attr.reshape(-1, ATTR_COLS)
    light_rows = w.light.reshape(-1, LIGHT_COLS)
    mat_rows = w.mat.reshape(-1, 3)
    lam4 = [w.lam[:, c] for c in range(4)]
    Le_in = [w.le[:, c] for c in range(4)]
    ones = torch.ones_like(lam4[0])
    beta = [ones] * 4
    L = [torch.zeros_like(ones)] * 4
    active = torch.ones_like(ones, dtype=torch.bool)
    prev_pdf = ones
    t_far = torch.full_like(ones, 1e30)

    for depth in range(w.max_depth):
        work["live_by_depth"].append(int(active.sum()))
        path_len += active
        # --- closest hit over the pool ---
        _t, k, b1, b2 = tri_intersect_plain(
            w.tri, torch.stack(o, -1), torch.stack(d, -1), t_far, w.n_real,
            any_hit=False)
        hit = (k >= 0) & active
        a = attr_rows[torch.clamp(k, min=0).to(torch.int64)]
        p0 = (a[:, 0], a[:, 1], a[:, 2])
        p1 = (a[:, 3], a[:, 4], a[:, 5])
        p2 = (a[:, 6], a[:, 7], a[:, 8])
        matf, lightf = a[:, 9], a[:, 10]
        b0 = 1.0 - b1 - b2
        p = tuple(b0 * p0[c] + b1 * p1[c] + b2 * p2[c] for c in range(3))
        p_err = tuple(_G7 * (torch.abs(b0 * p0[c]) + torch.abs(b1 * p1[c])
                             + torch.abs(b2 * p2[c])) for c in range(3))
        e1v = tuple(p1[c] - p0[c] for c in range(3))
        e2v = tuple(p2[c] - p0[c] for c in range(3))
        ng, ng_len = _normalize3(_cross3(e1v, e2v))
        area_hit = 0.5 * ng_len
        wo = (-d[0], -d[1], -d[2])

        # --- emission at emissive hits, MIS against the previous BSDF pdf
        is_emitter = hit & (lightf >= 0.0)
        er = light_rows[torch.clamp(lightf, min=0.0).to(torch.int64)]
        esc, epmf, ets = er[:, 9], er[:, 10], er[:, 11]
        emit_ok = (ets > 0.5) | (_dot3(ng, wo) > 0)
        po = (p[0] - o[0], p[1] - o[1], p[2] - o[2])
        dist2_e = torch.clamp(_dot3(po, po), min=1e-12)
        cos_e = torch.abs(_dot3(ng, wo))
        pdf_light = safe_div(dist2_e, cos_e * area_hit) * epmf
        w_emit = ones if depth == 0 else power_heuristic(1.0, prev_pdf, 1.0,
                                                         pdf_light)
        emask = is_emitter & emit_ok
        work["hits"] += int(hit.sum())
        work["emissions"] += int(emask.sum())
        L = [L[c] + torch.where(emask, beta[c] * Le_in[c] * esc * w_emit,
                                0.0) for c in range(4)]
        active = hit

        # --- shading frame: ns = ng, t1 along dpdu = p1 - p0 ---
        ns = ng
        t1 = tuple(e1v[c] - _dot3(e1v, ns) * ns[c] for c in range(3))
        bad = _dot3(t1, t1) < 1e-12
        t1f = _coordinate_system_t1(ns)
        t1, _ = _normalize3(tuple(torch.where(bad, t1f[c], t1[c])
                                  for c in range(3)))
        t2 = _cross3(ns, t1)
        wo_local = (_dot3(wo, t1), _dot3(wo, t2), _dot3(wo, ns))
        m = mat_rows[matf.to(torch.int64)]
        albedo = [mtl.sigmoid_polynomial(m[:, 0], m[:, 1], m[:, 2], lam4[c])
                  for c in range(4)]

        # --- next-event estimation ---
        base = CAM_DIMS + depth * DIMS_PER_BOUNCE
        u_pick = zs.d1(base)
        ul0, ul1 = zs.d2(base + 1)
        nl = w.n_lights
        if w.ls_uniform:
            li = torch.clamp((u_pick * nl).to(torch.int32), 0, nl - 1)
            pmf = torch.full_like(u_pick, float(np.float32(1.0 / nl)))
        else:
            up = u_pick * float(nl)
            i0 = torch.clamp(up.to(torch.int32), 0, nl - 1)
            frac = up - i0.to(torch.float32)
            ar = light_rows[i0.to(torch.int64)]
            take = frac < ar[:, 12]
            li = torch.where(take, i0, ar[:, 13].to(torch.int32))
            pmf = torch.where(take, ar[:, 14], ar[:, 15])
        lv = light_rows[li.to(torch.int64)]
        va = (lv[:, 0], lv[:, 1], lv[:, 2])
        vb = (lv[:, 3], lv[:, 4], lv[:, 5])
        vc = (lv[:, 6], lv[:, 7], lv[:, 8])
        lscale, lts = lv[:, 9], lv[:, 11]
        sb0, sb1, sb2 = lgt.sample_uniform_triangle(ul0, ul1)
        p_tri = tuple(sb0 * va[c] + sb1 * vb[c] + sb2 * vc[c]
                      for c in range(3))
        ngl, ngl_len = _normalize3(_cross3(
            tuple(vb[c] - va[c] for c in range(3)),
            tuple(vc[c] - va[c] for c in range(3))))
        area_l = 0.5 * ngl_len
        d_tri = tuple(p_tri[c] - p[c] for c in range(3))
        dist2 = torch.clamp(_dot3(d_tri, d_tri), min=1e-12)
        inv_dist = torch.rsqrt(dist2)
        wi = tuple(d_tri[c] * inv_dist for c in range(3))
        cos_l = -_dot3(ngl, wi)
        l_emit_ok = (lts > 0.5) | (cos_l > 0)
        pdf_l = safe_div(dist2, torch.abs(cos_l) * area_l) * pmf
        wi_local = (_dot3(wi, t1), _dot3(wi, t2), _dot3(wi, ns))
        same = wo_local[2] * wi_local[2] > 0
        awi = torch.abs(wi_local[2])
        f = [torch.where(same, albedo[c] * INV_PI * awi, 0.0)
             for c in range(4)]
        pdf_b = torch.where(same, awi * INV_PI, 0.0)
        Le_l = [torch.where(l_emit_ok, Le_in[c] * lscale, 0.0)
                for c in range(4)]
        any_L = (Le_l[0] > 0) | (Le_l[1] > 0) | (Le_l[2] > 0) | (Le_l[3] > 0)
        any_f = (f[0] > 0) | (f[1] > 0) | (f[2] > 0) | (f[3] > 0)
        contrib_ok = active & (pdf_l > 0) & any_L & any_f
        o_sh = _offset_origin(p, p_err, ng, wi)
        ds = tuple(p_tri[c] - o_sh[c] for c in range(3))
        dist_sh = torch.sqrt(torch.clamp(_dot3(ds, ds), min=0.0))
        _t, k_sh, _b1, _b2 = tri_intersect_plain(
            w.tri, torch.stack(o_sh, -1), torch.stack(wi, -1),
            dist_sh * 0.999, w.n_real, any_hit=True)
        work["shadow_rays"] += int(contrib_ok.sum())
        tested = torch.where(k_sh >= 0, torch.clamp(
            (k_sh // GROUP + 1) * GROUP, max=w.n_real), w.n_real)
        work["shadow_tests"] += int(tested[contrib_ok].sum())
        contrib_ok = contrib_ok & ~(k_sh >= 0)
        work["unoccluded"] += int(contrib_ok.sum())
        if depth + 1 < w.max_depth:
            work["bsdf_samples"] += int(active.sum())
        inv_pl = safe_div(power_heuristic(1.0, pdf_l, 1.0, pdf_b), pdf_l)
        L = [L[c] + torch.where(contrib_ok,
                                beta[c] * f[c] * Le_l[c] * inv_pl, 0.0)
             for c in range(4)]

        # --- BSDF sample (diffuse cosine lobe) ---
        ub0, ub1 = zs.d2(base + 4)
        wx, wy, wz = bxdfs.sample_cosine_hemisphere(ub0, ub1)
        wz = torch.where(wo_local[2] < 0, -wz, wz)
        same_b = wo_local[2] * wz > 0
        acb = torch.abs(wz)
        pdf_s = torch.where(same_b, acb * INV_PI, 0.0)
        thr = safe_div(acb, pdf_s) * INV_PI
        beta_new = [beta[c] * torch.where(same_b, albedo[c] * thr, 0.0)
                    for c in range(4)]
        any_beta = (beta_new[0] > 0) | (beta_new[1] > 0) | \
            (beta_new[2] > 0) | (beta_new[3] > 0)
        active = active & (pdf_s > 0) & any_beta
        beta = [torch.where(active, beta_new[c], beta[c]) for c in range(4)]
        prev_pdf = pdf_s
        wi_w = tuple(wx * t1[c] + wy * t2[c] + wz * ns[c] for c in range(3))

        # --- Russian roulette on beta ---
        if depth >= w.rr_start and depth + 1 < w.max_depth:
            work["rr_draws"] += int(active.sum())
            u_rr = zs.d1(base + 6)
            bmax = torch.maximum(torch.maximum(beta[0], beta[1]),
                                 torch.maximum(beta[2], beta[3]))
            q = torch.clamp(1.0 - bmax, min=0.0)
            do_rr = bmax < 1.0
            killed = do_rr & (u_rr < q)
            active = active & ~killed
            scale_rr = 1.0 / torch.clamp(1.0 - q, min=1e-6)
            keep = do_rr & ~killed
            beta = [torch.where(keep, beta[c] * scale_rr, beta[c])
                    for c in range(4)]

        if depth + 1 < w.max_depth:
            o = _offset_origin(p, p_err, ng, wi_w)
            d = wi_w

    work["live_lane_depths"] = sum(work["live_by_depth"])
    work["warp_busy_share"] = _warp_busy_share(path_len)
    return torch.stack(L, dim=-1), work


# ---------------------------------------------------------------------------
# CUDA kernel launch

def grid(w: FullWave) -> dict:
    """The kernel's persistent grid for wave w on its card: blocks,
    blocks_per_sm, threads (a block), resident_lanes (threads in flight at
    once: blocks x threads when the wave fills the card)."""
    import ctypes
    from . import _build
    lib = _build.load_library("megawave")
    out = [ctypes.c_int(0) for _ in range(3)]
    with torch.cuda.device(w.lam.device):
        err = lib.megawave_grid(
            w.mi.shape[0], w.tri.numel() // 16, w.n_real, w.n_mats,
            w.n_lights, n_dims(w.max_depth), *(ctypes.byref(x) for x in out))
    _build.check(err, "megawave_grid")
    blocks, per_sm, threads = (x.value for x in out)
    return dict(blocks=blocks, blocks_per_sm=per_sm, threads=threads,
                resident_lanes=blocks * threads)


def _launch(w: FullWave, *, out=None):
    """out: (L, fw) to write into (fw None for rays in)."""
    with torch.cuda.device(w.lam.device):
        args, L, fw, _keep = launch_args(w, out=out)
        if args is not None:
            launch(args)
    return L, fw


def launch(args):
    """One launch of the kernel with the arguments launch_args made, on the
    current device."""
    from . import _build
    lib = _build.load_library("megawave")
    with spans.span("megawave.kernel"):
        err = lib.megawave_launch(*args)
    _build.check(err, "megawave")
    counter.launches += 1


def launch_args(w: FullWave, *, out=None):
    """The arguments of megawave_launch for wave w on the current device's
    current stream:
    (args, L, fw, keep), args None when the wave is empty; keep holds the
    tensors args points into. A timing tool calls the library with them
    again to time the launch without the wrapper's host work."""
    import ctypes
    rays = w.o is not None
    names = ("tri", "attr", "light", "mat", "lam", "le") + \
        (("o", "d") if rays else ("cam",))
    for name in names:
        x = getattr(w, name)
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"megawave: {name} must be float32 contiguous")
    N = w.mi.shape[0]
    if w.lam.shape != (N, 4) or w.le.shape != (N, 4):
        raise ValueError("megawave: lam and le must be (N, 4)")
    if rays and not (w.o.shape == w.d.shape == (N, 3)):
        raise ValueError("megawave: o and d must be (N, 3)")
    if not rays and w.cam.numel() != CAM_COLS:
        raise ValueError("megawave: camera table must have 19 entries")
    dev = w.lam.device
    if w.mi.dtype != torch.int32 or not w.mi.is_contiguous():
        raise ValueError("megawave: mi must be int32 contiguous (encode_mi)")
    seeds, sobol = device_seeds(dev, w.seed, w.max_depth), _device_sobol(dev)
    # float4 access: the kernel needs 16-byte aligned (N, 4) rows
    lam, le = (x if x.data_ptr() % 16 == 0 else x.clone()
               for x in (w.lam, w.le))
    if out is None:
        L = torch.empty((N, 4), dtype=torch.float32, device=dev)
        fw = None if rays else torch.empty((N,), dtype=torch.float32,
                                           device=dev)
    else:
        L, fw = out
    if N == 0:
        return None, L, fw, ()
    stream = torch.cuda.current_stream()
    next_lane = _next_lane(dev, stream.cuda_stream)
    # the filter's constants, read only when the kernel makes the rays
    c = dict.fromkeys(("s2", "inv_2s2", "norm", "zx", "zy", "ex", "ey", "rx",
                       "ry"), 0.0) if rays else flt.gaussian_constants(w.filt)
    F = ctypes.c_float
    args = (
        None if rays else w.cam.data_ptr(), w.tri.data_ptr(),
        w.attr.data_ptr(), w.light.data_ptr(), w.mat.data_ptr(),
        seeds.data_ptr(), sobol.data_ptr(), w.mi.data_ptr(),
        lam.data_ptr(), le.data_ptr(),
        w.o.data_ptr() if rays else None,
        w.d.data_ptr() if rays else None, L.data_ptr(),
        None if rays else fw.data_ptr(), next_lane.data_ptr(),
        N, w.tri.numel() // 16, w.n_real, w.n_mats, w.n_lights,
        seeds.shape[0], w.max_depth, w.rr_start, w.B, w.log2_spp,
        int(w.ls_uniform),
        F(c["s2"]), F(c["inv_2s2"]), F(c["norm"]), F(c["zx"]),
        F(c["zy"]), F(c["ex"]), F(c["ey"]), F(c["rx"]), F(c["ry"]),
        ctypes.c_void_p(stream.cuda_stream))
    return args, L, fw, (lam, le, next_lane, seeds, sobol)
