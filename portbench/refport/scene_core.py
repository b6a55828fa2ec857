"""Compiled scene (counterpart of pbrt_tpu_torch/scene_core.py), cut to
what the benchmark's cells reach: the SceneBuilder's triangle meshes
(per-vertex normals and uvs when given) with diffuse, conductor,
dielectric materials, area-triangle emission, uniform infinite
lights and an image infinite light, under a uniform, power, light-BVH or
exhaustive light sampler (the last two with area triangles alone, as in
the program), image and constant textures on the diffuse reflectance;
the device tables; the intersection entry points of the general path
wave.

A scene is built on the host in numpy and moved once to the device the
caller names. Triangle queries follow the program's dispatch
(_tri_dispatch): above 4096 triangles or with force_bvh through the BVH8
traversal (ops/bvh8.py) over the whole scene, and below through the
brute-force triangle test (ops/tri_intersect.py), each in its plain
version. The megakernel's eligibility test is the program's: an eligible
scene (cornell class) also carries the megakernel's tables and metadata.
Instances, curves, bilinear patches, quadrics, sphere lights (and their
light bounds), media and medium interfaces are not copied: the parser
refuses them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import bxdfs
from . import device as dev_mod
from . import lights as lgt
from . import lightsamplers as lsamp
from . import materials as mtl
from . import textures as tex_mod
from .ops import bvh as bvh_mod
from .ops import bvh8 as bvh8_mod
from .ops import tri_intersect as ti
from .ops.megawave import MegaMeta, ATTR_COLS, LIGHT_COLS
from .utils import color as pcolor
from .utils import spectrum as spc
from .utils import vecmath as vm
from .utils.math import gamma_bound, next_float_down, next_float_up

MAX_MEGA_TRIS = 64
BVH_MIN_TRIS = 4096   # the reference's brute-force / BVH crossover


@dataclasses.dataclass
class Scene:
    """Device tables.

    tri_all (T, 27) triangle rows in original order, [p0, p1, p2, id]
    then [n0, n1, n2, uv0, uv1, uv2, mat, light]: the world triangles,
    then each prototype's in object space, ids rebased; tri_pallas
    (T'*16,) the brute-force pool (None on the other routes); bvh8 the
    BVH8 tables (None off the BVH8 route); mat_pool (M, 22);
    lights_packed (L, 24); alias_rows (L, 4) alias rows of a power sampler
    (else None); spectra_pool (S, 471). Host metadata: the light sampler,
    the scene radius (float32 value), the pool indices of the infinite
    lights, the light tags present. attr, light, mat and mega: the
    megakernel's tables and metadata, None unless the scene is eligible.
    bxdf_tags: the BxDF tags of the material pool. env: the image infinite
    light's tables (lights.EnvLight), None without one. textures: the
    texture pool (textures.TexturePool); has_textures: a material reads
    a texture."""
    tri_all: torch.Tensor
    tri_pallas: torch.Tensor
    bvh8: bvh8_mod.BVH8
    mat_pool: torch.Tensor
    lights_packed: torch.Tensor
    alias_rows: torch.Tensor
    spectra_pool: torch.Tensor
    light_sampler: lsamp.LightSampler
    scene_radius: float
    inf_indices: tuple
    light_tags: tuple
    n_tris: int
    attr: torch.Tensor = None
    light: torch.Tensor = None
    mat: torch.Tensor = None
    mega: MegaMeta = None
    bxdf_tags: tuple = (bxdfs.BXDF_DIFFUSE,)
    env: lgt.EnvLight = None
    textures: tex_mod.TexturePool = None
    has_textures: bool = False

    @property
    def device(self) -> torch.device:
        return self.tri_all.device

    @property
    def use_bvh(self) -> bool:
        return self.bvh8 is not None

    @property
    def has_area_lights(self) -> bool:
        """Emitting triangles (a hit can return emission)."""
        return lgt.LIGHT_AREA_TRI in self.light_tags

def _mesh_rows(vertices, indices, normals, uvs):
    """Per-triangle corner attributes of a mesh: (p0, p1, p2, n0, n1, n2,
    uv0, uv1, uv2), float32 (F, 3) and (F, 2); without normals each corner
    takes the face normal, without uvs (0, 0), (1, 0), (1, 1)."""
    vertices = np.asarray(vertices, np.float32)
    indices = np.asarray(indices, np.int64)
    p0, p1, p2 = (vertices[indices[:, i]] for i in range(3))
    if normals is not None:
        normals = np.asarray(normals, np.float32)
        n0, n1, n2 = (normals[indices[:, i]] for i in range(3))
    else:
        ng = np.cross(p1 - p0, p2 - p0)
        ng /= np.maximum(np.linalg.norm(ng, axis=-1, keepdims=True), 1e-20)
        n0 = n1 = n2 = ng
    if uvs is not None:
        uvs = np.asarray(uvs, np.float32)
        uv0, uv1, uv2 = (uvs[indices[:, i]] for i in range(3))
    else:
        uv0 = np.zeros((len(p0), 2), np.float32)
        uv1 = np.tile(np.array([[1, 0]], np.float32), (len(p0), 1))
        uv2 = np.tile(np.array([[1, 1]], np.float32), (len(p0), 1))
    return p0, p1, p2, n0, n1, n2, uv0, uv1, uv2


class SceneBuilder:
    """Host-side scene assembly (reference SceneBuilder subset)."""

    def __init__(self):
        self.cs = pcolor.srgb()
        self.materials = mtl.MaterialBuilder(self.cs)
        self.textures = tex_mod.TextureBuilder(self.cs)
        self.p0, self.p1, self.p2 = [], [], []
        self.n0, self.n1, self.n2 = [], [], []
        self.uv0, self.uv1, self.uv2 = [], [], []
        self.t_mat = []
        self.t_light = []
        self.light_rows = []
        self.spectra = []
        self._spec_cache = {}
        self._spec_keep = []         # the spectra named by a cache key
        self._env_image = None       # (image, scale) of the image light

    def add_spectrum(self, s: spc.Spectrum, key=None) -> int:
        """Add a spectrum to the pool, deduplicated by content. key: a
        cache key naming s (callers pass id(s)); s is kept alive with it,
        so that the id cannot name another spectrum later."""
        if key is not None and key in self._spec_cache:
            return self._spec_cache[key]
        if key is not None:
            self._spec_keep.append(s)
        dense = s.to_dense()
        ckey = ("content", dense.tobytes())
        if ckey not in self._spec_cache:
            self._spec_cache[ckey] = len(self.spectra)
            self.spectra.append(dense)
        idx = self._spec_cache[ckey]
        if key is not None:
            self._spec_cache[key] = idx
        return idx

    def add_mesh(self, vertices, indices, material: int, normals=None,
                 uvs=None, emission=None, emission_scale=1.0,
                 two_sided=False):
        """vertices (V, 3); indices (F, 3); normals (V, 3) and uvs (V, 2)
        per vertex, optional; emission: host Spectrum making each triangle
        an area light. Returns the light indices created."""
        p0, p1, p2, n0, n1, n2, uv0, uv1, uv2 = _mesh_rows(
            vertices, indices, normals, uvs)
        created = []
        for i in range(len(p0)):
            tri = len(self.t_mat)
            for dst, src in ((self.p0, p0), (self.p1, p1), (self.p2, p2),
                             (self.n0, n0), (self.n1, n1), (self.n2, n2),
                             (self.uv0, uv0), (self.uv1, uv1),
                             (self.uv2, uv2)):
                dst.append(src[i])
            self.t_mat.append(material)
            if emission is None:
                self.t_light.append(-1)
                continue
            area = 0.5 * np.linalg.norm(np.cross(p1[i] - p0[i],
                                                 p2[i] - p0[i]))
            li = len(self.light_rows)
            self.light_rows.append(dict(
                tag=lgt.LIGHT_AREA_TRI, p=np.zeros(3), dir=np.zeros(3),
                spec_idx=self.add_spectrum(emission,
                                           key=("emit", id(emission))),
                scale=emission_scale, tri=tri, two_sided=two_sided,
                cfs=1.0, cfe=1.0, is_delta=False,
                power=lgt.compute_light_power(
                    lgt.LIGHT_AREA_TRI, emission_scale, emission, area=area,
                    two_sided=two_sided)))
            self.t_light.append(li)
            created.append(li)
        return created

    def add_uniform_infinite_light(self, spectrum: spc.Spectrum,
                                   scale=1.0) -> int:
        """A constant environment; its power is set at build time from the
        scene radius."""
        self.light_rows.append(dict(
            tag=lgt.LIGHT_UNIFORM_INFINITE, p=np.zeros(3), dir=np.zeros(3),
            spec_idx=self.add_spectrum(spectrum, key=("inf", id(spectrum))),
            scale=scale, tri=0, two_sided=False, cfs=1.0, cfe=1.0,
            is_delta=False, power=1.0))
        return len(self.light_rows) - 1

    def add_image_infinite_light(self, image_rgb, scale=1.0) -> int:
        """An environment map: image_rgb (H, W, 3) linear RGB in the
        equal-area octahedral layout; its power is the mean luminance times scale,
        times 4 pi^2 r^2 at build (r the scene radius), as in the reference.
        One a scene, as in the reference."""
        if self._env_image is not None:
            raise NotImplementedError("a second image infinite light")
        image_rgb = np.asarray(image_rgb, np.float32)
        lum = (0.2126 * image_rgb[..., 0] + 0.7152 * image_rgb[..., 1]
               + 0.0722 * image_rgb[..., 2]).mean()
        self._env_image = (image_rgb, scale)
        self.light_rows.append(dict(
            tag=lgt.LIGHT_IMAGE_INFINITE, p=np.zeros(3), dir=np.zeros(3),
            spec_idx=0, scale=scale, tri=0, two_sided=False, cfs=1.0,
            cfe=1.0, power=float(lum) * scale, is_delta=False))
        return len(self.light_rows) - 1

    def _mega_meta(self, use_bvh, ls, p0, p1, p2):
        """The megakernel's static eligibility (reference SceneBuilder.build,
        the megakernel block); None when the scene is outside it."""
        rows = self.light_rows
        n_tri = len(p0)
        if (use_bvh or n_tri > MAX_MEGA_TRIS or not rows
                or self.materials.tags() != (bxdfs.BXDF_DIFFUSE,)
                or self.materials.has_textures()
                or ls.kind not in (lsamp.LS_UNIFORM, lsamp.LS_POWER)
                or any(r["tag"] != lgt.LIGHT_AREA_TRI for r in rows)
                or len({r["spec_idx"] for r in rows}) != 1):
            return None
        face_ng = np.cross(p1 - p0, p2 - p0)
        face_ng /= np.maximum(
            np.linalg.norm(face_ng, axis=-1, keepdims=True), 1e-20)
        n0h = np.stack(self.n0)
        flat_ok = (np.allclose(n0h, np.stack(self.n1))
                   and np.allclose(n0h, np.stack(self.n2))
                   and np.allclose(n0h, face_ng, atol=1e-5))
        uv_ok = (np.allclose(np.stack(self.uv0), [0.0, 0.0])
                 and np.allclose(np.stack(self.uv1), [1.0, 0.0])
                 and np.allclose(np.stack(self.uv2), [1.0, 1.0]))
        if not (flat_ok and uv_ok):
            return None
        return MegaMeta(n_tris=n_tri, n_mats=len(self.materials.rows),
                        n_lights=len(rows),
                        light_spec=int(rows[0]["spec_idx"]),
                        ls_uniform=bool(ls.kind == lsamp.LS_UNIFORM))

    @staticmethod
    def _light_bounds(rows, p0, p1, p2):
        """Each light's LightBounds for the position-aware samplers
        (reference _light_bounds): an area triangle's box, its normal as
        the cone axis (cos_theta_o -1 when two-sided, else 1) and
        cos_theta_e 0; infinite lights outside the tree. (The program's
        sphere-light branch is not copied: the parser refuses spheres.)"""
        L = len(rows)
        lo = np.zeros((L, 3), np.float32)
        hi = np.zeros((L, 3), np.float32)
        w = np.tile(np.asarray([0, 0, 1.0], np.float32), (L, 1))
        cos_o = np.full(L, -1.0, np.float32)
        cos_e = np.zeros(L, np.float32)
        inf = np.zeros(L, bool)
        for i, r in enumerate(rows):
            if r["tag"] == lgt.LIGHT_AREA_TRI:
                t = r["tri"]
                pts = np.stack([p0[t], p1[t], p2[t]])
                lo[i] = pts.min(0)
                hi[i] = pts.max(0)
                ng = np.cross(p1[t] - p0[t], p2[t] - p0[t])
                nn = np.linalg.norm(ng)
                w[i] = ng / nn if nn > 1e-12 else w[i]
                cos_o[i] = -1.0 if r["two_sided"] else 1.0
            else:   # the infinite lights
                inf[i] = True
        return dict(bounds_lo=lo, bounds_hi=hi, axis_w=w, cos_theta_o=cos_o,
                    cos_theta_e=cos_e,
                    power=np.asarray([r["power"] for r in rows], np.float64),
                    is_infinite=inf)

    def build(self, light_sampler="power", force_bvh=None,
              device="cuda") -> Scene:
        device = dev_mod.resolve(device)
        if not self.p0:
            # a dummy far-away triangle keeps the triangle pipeline
            # non-empty, as in the reference
            self.add_mesh([[9e8, 9e8, 9e8], [9.0001e8, 9e8, 9e8],
                           [9e8, 9.0001e8, 9e8]], [[0, 1, 2]],
                          self.materials.add_diffuse((0, 0, 0)))
        p0, p1, p2 = (np.stack(v) for v in (self.p0, self.p1, self.p2))
        n_tri = len(p0)
        lo = np.minimum(np.minimum(p0, p1), p2)
        hi = np.maximum(np.maximum(p0, p1), p2)
        world_lo, world_hi = lo.min(axis=0), hi.max(axis=0)
        radius = 0.5 * float(np.linalg.norm(world_hi - world_lo)) + 1e-3
        use_bvh = (n_tri > BVH_MIN_TRIS) if force_bvh is None else \
            bool(force_bvh)
        rows = self.light_rows
        for r in rows:     # the scene-radius term of infinite-light power
            if r["tag"] == lgt.LIGHT_IMAGE_INFINITE:
                r["power"] = r["power"] * 4 * np.pi * np.pi * radius ** 2
            if r["tag"] == lgt.LIGHT_UNIFORM_INFINITE:
                base = spc.DenselySampledSpectrum(
                    self.spectra[r["spec_idx"]].astype(np.float64))
                r["power"] = lgt.compute_light_power(
                    r["tag"], r["scale"], base, scene_radius=radius)
        ls = lsamp.make_light_sampler(
            light_sampler, [r["power"] for r in rows],
            self._light_bounds(rows, p0, p1, p2) if rows else None,
            device=device)
        if lsamp.positional(ls):
            if any(r["tag"] != lgt.LIGHT_AREA_TRI for r in rows):
                # the reference's escape branches read pmf_table, which
                # its position-aware samplers lack: it cannot render this
                raise NotImplementedError(
                    f"the {light_sampler!r} light sampler with an infinite "
                    "light: the reference renders no such scene (ROADMAP.md "
                    "section 3, recorded behaviours of the reference)")
            # the pool's pmf column is uniform; the sampler gives the pick's
            pmf = np.full(len(rows), 1.0 / len(rows), np.float32)
        else:
            pmf = ls.pmf_table
        lights_packed = lgt.pack_light_pool(rows, p0, p1, p2, pmf)
        tri_geo = bvh_mod.pack_tri_geo(p0, p1, p2)
        tri_shade = np.concatenate([
            np.stack(self.n0), np.stack(self.n1), np.stack(self.n2),
            np.stack(self.uv0), np.stack(self.uv1), np.stack(self.uv2),
            np.asarray(self.t_mat, np.float32)[:, None],
            np.asarray(self.t_light, np.float32)[:, None]],
            axis=1).astype(np.float32)

        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                   device=device)

        bvh8 = tri_pallas = None
        extra = {}
        if use_bvh:
            bvh8 = bvh8_mod.build_bvh8(lo, hi, tri_geo, device=device)
        else:
            tri_pallas = t(ti.pad_triangles(tri_geo[:, :9]))
        if self._env_image is not None:
            img, esc = self._env_image
            extra["env"] = lgt.make_env_light(
                img, self.cs, scale=esc, device=device,
                light_index=next(i for i, r in enumerate(rows)
                                 if r["tag"] == lgt.LIGHT_IMAGE_INFINITE))
        scene = Scene(
            tri_all=t(np.concatenate([tri_geo, tri_shade], axis=1)),
            tri_pallas=tri_pallas, bvh8=bvh8,
            mat_pool=t(self.materials.packed()),
            lights_packed=t(lights_packed),
            alias_rows=t(ls.rows) if ls.kind == lsamp.LS_POWER else None,
            spectra_pool=t(np.stack(self.spectra) if self.spectra
                           else np.zeros((1, spc.N_CIE))),
            light_sampler=ls, scene_radius=float(np.float32(radius)),
            inf_indices=tuple(i for i, r in enumerate(rows)
                              if r["tag"] == lgt.LIGHT_UNIFORM_INFINITE),
            light_tags=tuple(sorted({r["tag"] for r in rows})),
            n_tris=len(tri_geo), bxdf_tags=self.materials.tags(),
            textures=self.textures.build(device),
            has_textures=self.materials.has_textures(), **extra)
        mega = self._mega_meta(use_bvh, ls, p0, p1, p2)
        if mega is None:
            return scene
        attr = np.concatenate([
            p0, p1, p2, np.asarray(self.t_mat, np.float32)[:, None],
            np.asarray(self.t_light, np.float32)[:, None]], axis=1)
        assert attr.shape[1] == ATTR_COLS
        if ls.kind == lsamp.LS_POWER:
            alias = ls.rows
        else:
            u = 1.0 / len(rows)
            alias = np.tile(np.asarray([[1.0, 0.0, u, u]], np.float32),
                            (len(rows), 1))
        light = np.concatenate([lights_packed[:, 15:24],
                                lights_packed[:, 8:9],
                                lights_packed[:, 14:15],
                                lights_packed[:, 10:11], alias], axis=1)
        assert light.shape[1] == LIGHT_COLS
        return dataclasses.replace(
            scene, attr=t(attr.reshape(-1)), light=t(light.reshape(-1)),
            mat=t(self.materials.coeffs().reshape(-1)), mega=mega)


# ---------------------------------------------------------------------------
# Intersection entry points

def _tri_dispatch(scene: Scene, o, d, t_max, any_hit: bool):
    """Closest or any hit through the scene's route. Returns dict(hit, t
    (inf on a miss), prim (original id, -1 on a miss), b0, b1, b2)."""
    if scene.use_bvh:
        return bvh8_mod.bvh8_intersect(scene.bvh8, o, d, t_max, any_hit)
    t, prim, b1, b2 = ti.tri_intersect(scene.tri_pallas, o, d, t_max,
                                       scene.n_tris, any_hit)
    hit = prim >= 0
    return dict(hit=hit, t=torch.where(hit, t, torch.inf), prim=prim,
                b0=1.0 - b1 - b2, b1=b1, b2=b2)


def intersection_p_error(b0, b1, b2, p0, p1, p2):
    """Triangle-hit position error bound: gamma(7) * sum |b_i p_i|."""
    return gamma_bound(7) * (torch.abs(b0[:, None] * p0)
                             + torch.abs(b1[:, None] * p1)
                             + torch.abs(b2[:, None] * p2))


def intersect(scene: Scene, o, d, t_max):
    """Closest hit of rays o, d (N, 3) below t_max (N,). Returns dict(hit,
    t, prim, p, ng, ns, uv, mat, light, wo, p0, p1, p2, dpdu, dpdv,
    p_err); ng is turned to the side of the shading normal ns."""
    # the kernels read packed rows: camera origins arrive broadcast
    o, d, t_max = o.contiguous(), d.contiguous(), t_max.contiguous()
    r = _tri_dispatch(scene, o, d, t_max, any_hit=False)
    prim = torch.clamp(r["prim"], min=0).to(torch.int64)
    b0, b1, b2 = r["b0"], r["b1"], r["b2"]
    row = scene.tri_all[prim]
    p0, p1, p2 = row[:, 0:3], row[:, 3:6], row[:, 6:9]
    n0, n1, n2 = row[:, 10:13], row[:, 13:16], row[:, 16:19]
    uv0, uv1, uv2 = row[:, 19:21], row[:, 21:23], row[:, 23:25]
    p = b0[:, None] * p0 + b1[:, None] * p1 + b2[:, None] * p2
    ng = vm.normalize(vm.cross(p1 - p0, p2 - p0))
    ns = vm.normalize(b0[:, None] * n0 + b1[:, None] * n1 + b2[:, None] * n2)
    ng = torch.where((vm.dot(ng, ns) < 0)[:, None], -ng, ng)
    uv = b0[:, None] * uv0 + b1[:, None] * uv1 + b2[:, None] * uv2
    # parametric derivatives (reference Triangle InteractionFromIntersection)
    duv02 = uv0 - uv2
    duv12 = uv1 - uv2
    dp02 = p0 - p2
    dp12 = p1 - p2
    det = duv02[:, 0] * duv12[:, 1] - duv02[:, 1] * duv12[:, 0]
    small = torch.abs(det) < 1e-12
    inv_det = torch.where(small, 0.0, 1.0 / det)
    dpdu = (duv12[:, 1:2] * dp02 - duv02[:, 1:2] * dp12) * inv_det[:, None]
    dpdv = (-duv12[:, 0:1] * dp02 + duv02[:, 0:1] * dp12) * inv_det[:, None]
    degen = small | (vm.length_squared(vm.cross(dpdu, dpdv)) < 1e-18)
    t1f, t2f = vm.coordinate_system(ng)
    dpdu = torch.where(degen[:, None], t1f, dpdu)
    dpdv = torch.where(degen[:, None], t2f, dpdv)
    out = dict(hit=r["hit"], t=r["t"], prim=prim, p=p, ng=ng, ns=ns, uv=uv,
               mat=row[:, 25].round().to(torch.int64),
               light=row[:, 26].round().to(torch.int64), wo=-d, p0=p0,
               p1=p1, p2=p2, dpdu=dpdu, dpdv=dpdv,
               p_err=intersection_p_error(b0, b1, b2, p0, p1, p2))
    # the floor of the error bound
    out["p_err"] = torch.maximum(out["p_err"], gamma_bound(7)
                                 * torch.abs(out["p"]))
    return out


def intersect_p(scene: Scene, o, d, t_max):
    """Any-hit (shadow) query. Returns bool occluded (N,)."""
    o, d, t_max = o.contiguous(), d.contiguous(), t_max.contiguous()
    return _tri_dispatch(scene, o, d, t_max, any_hit=True)["hit"]


def offset_ray_origin_exact(p, p_err, ng, w):
    """Push the origin past the hit's error box along ng, to the side of
    w, each coordinate rounded one float away from p (reference
    Interaction::OffsetRayOrigin)."""
    dist = (torch.abs(ng[:, 0]) * p_err[:, 0]
            + torch.abs(ng[:, 1]) * p_err[:, 1]
            + torch.abs(ng[:, 2]) * p_err[:, 2])
    offset = dist[:, None] * ng
    offset = torch.where((vm.dot(w, ng) < 0)[:, None], -offset, offset)
    po = p + offset
    return torch.where(offset > 0, next_float_up(po),
                       torch.where(offset < 0, next_float_down(po), po))

