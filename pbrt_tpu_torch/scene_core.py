"""Compiled scene (counterpart of pbrt_tpu/scene_core.py): the SceneBuilder
subset of the ported slices, the device tables, and the intersection entry
points of the general path wave.

A scene is built on the host in numpy and moved once to the device the
caller names. It holds triangle meshes (per-vertex normals and uvs when
given) with diffuse and hair materials, cubic Bezier curves, exact bilinear
patches, area-triangle emission and uniform infinite lights, under a
uniform or power light sampler, and static object instances of triangle
prototypes. Other shapes,
lights, materials, media, textures, animated instances and alpha are not
ported: their builders do not exist here, and the parser refuses their
directives.

Triangle queries follow the reference's dispatch (_tri_dispatch): a scene
with instances sends every closest and any hit through the two-level
kernel (ops/bvh2.py) over its TLAS and BLASes; otherwise, above 4096
triangles or with force_bvh, through the BVH8 kernel (ops/bvh8.py) over
the whole scene, and below through the brute-force triangle kernel
(ops/tri_intersect.py). A scene with curves then sends every query
through the curve kernel (ops/curves.py) as well, over the curves' own
BVH, and merges its hits as the reference does; a scene with bilinear
patches tests every ray against its small patch pool in tensor code
(ops/intersect.py), before the curves. The megakernel's
eligibility test is the reference's: an eligible scene (cornell class)
also carries the megakernel's tables and metadata.
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
from .ops import bvh as bvh_mod
from .ops import bvh2 as bvh2_mod
from .ops import bvh8 as bvh8_mod
from .ops import curves as crv
from .ops import intersect as isect_ops
from .ops import tlas as tlas_mod
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
    Instanced scenes (ops/tlas.py): tlas_nodes (M, 8) the BLAS nodes then
    the TLAS from tlas_root on, inst_rows (I, 66), tri_geo_tlas (T, 10)
    the BLAS-ordered rows with the global id in column 9, tlas_depth the
    stack the tables need; None (0, False) without instances. Scenes with
    curves (ops/curves.py): curve_nodes (M, 8) the curve BVH, curve_segs
    (S, 16) its sub-segment rows in leaf order, curve_mats (C,) int64 the
    material of each curve id, curve_depth the tree's depth; None (0,
    False) without curves. blp_rows (K, 14) the exact bilinear patches
    [p00, p10, p01, p11, material, -1]; None (False) without patches.
    bxdf_tags: the BxDF tags of the material pool."""
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
    tlas_nodes: torch.Tensor = None
    inst_rows: torch.Tensor = None
    tri_geo_tlas: torch.Tensor = None
    tlas_root: int = 0
    tlas_depth: int = 0
    has_instances: bool = False
    curve_nodes: torch.Tensor = None
    curve_segs: torch.Tensor = None
    curve_mats: torch.Tensor = None
    curve_depth: int = 0
    has_curves: bool = False
    blp_rows: torch.Tensor = None
    has_blps: bool = False
    bxdf_tags: tuple = (bxdfs.BXDF_DIFFUSE,)

    @property
    def device(self) -> torch.device:
        return self.tri_all.device

    @property
    def use_bvh(self) -> bool:
        return self.bvh8 is not None

    @property
    def has_area_lights(self) -> bool:
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
        self.p0, self.p1, self.p2 = [], [], []
        self.n0, self.n1, self.n2 = [], [], []
        self.uv0, self.uv1, self.uv2 = [], [], []
        self.t_mat = []
        self.t_light = []
        self.light_rows = []
        self.spectra = []
        self._spec_cache = {}
        self.protos = []
        self.instances = []
        self.curve_seg_rows = []     # (2^crv.SUBDIV, 16) rows of each curve
        self.curve_seg_bounds = []   # (lo, hi) of its sub-segments
        self.curve_mat_list = []     # material of each curve id
        self.blp_list = []           # (p00, p10, p01, p11, material)

    def add_spectrum(self, s: spc.Spectrum, key=None) -> int:
        """Add a spectrum to the pool, deduplicated by content."""
        if key is not None and key in self._spec_cache:
            return self._spec_cache[key]
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

    def new_prototype(self) -> int:
        """Open an instancing prototype (reference ObjectBegin): geometry
        added with add_proto_mesh is stored once, in object space."""
        self.protos.append(dict(p0=[], p1=[], p2=[], n0=[], n1=[], n2=[],
                                uv0=[], uv1=[], uv2=[], mat=[]))
        return len(self.protos) - 1

    def add_proto_mesh(self, proto: int, vertices, indices, material: int,
                       normals=None, uvs=None):
        """Add a mesh to a prototype, in object space (no area lights:
        emissive instanced geometry is not supported)."""
        P = self.protos[proto]
        rows = _mesh_rows(vertices, indices, normals, uvs)
        for key, v in zip(("p0", "p1", "p2", "n0", "n1", "n2", "uv0", "uv1",
                           "uv2"), rows):
            P[key].extend(v)
        P["mat"].extend([material] * len(rows[0]))

    def add_instance(self, proto: int, object_to_world,
                     object_to_world_end=None) -> int:
        """Instantiate a prototype (reference ObjectInstance).
        object_to_world: a utils.transform.Transform or a (4, 4) matrix,
        inverted in float64 and stored as float32 3x4 rows.
        object_to_world_end makes the instance animated, which build()
        refuses (ops/tlas.py)."""
        def mat(x):
            return np.asarray(x.m if hasattr(x, "m") else x, np.float64)
        o2w4 = mat(object_to_world)
        rec = dict(proto=proto, o2w=o2w4[:3, :].astype(np.float32),
                   w2o=np.linalg.inv(o2w4)[:3, :].astype(np.float32))
        if object_to_world_end is not None:
            rec["o2w_end"] = mat(object_to_world_end)[:3, :].astype(
                np.float32)
        self.instances.append(rec)
        return len(self.instances) - 1

    def add_curve(self, control_points, width0, width1, material: int,
                  curve_type="flat", normals=None) -> int:
        """A cubic Bezier curve (reference Shape "curve"). control_points
        (4, 3); width0 and width1 the widths at u = 0 and 1; curve_type
        flat | cylinder | ribbon (a ribbon takes normals = (n0, n1));
        split into 2^crv.SUBDIV linear sub-segments. Returns the curve id."""
        ctype = {"flat": crv.CURVE_FLAT, "cylinder": crv.CURVE_CYLINDER,
                 "ribbon": crv.CURVE_RIBBON}[curve_type]
        cid = len(self.curve_mat_list)
        n0, n1 = normals if normals is not None else (None, None)
        rows, lo, hi = crv.split_curve(control_points, width0, width1,
                                       crv.SUBDIV, ctype=ctype, normal0=n0,
                                       normal1=n1, curve_id=cid)
        self.curve_seg_rows.append(rows)
        self.curve_seg_bounds.append((lo, hi))
        self.curve_mat_list.append(material)
        return cid

    def add_bilinear_patch(self, p00, p10, p01, p11, material: int):
        """An exact (not tessellated) bilinear patch, world-space corners,
        point(u, v) = lerp(v; lerp(u; p00, p10), lerp(u; p01, p11)). An
        emissive quad mesh is triangulated instead: area lights are
        triangles."""
        self.blp_list.append((*(np.asarray(x, np.float32)
                                for x in (p00, p10, p01, p11)),
                              int(material)))

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

    def _mega_meta(self, use_bvh, ls, p0, p1, p2):
        """The megakernel's static eligibility (reference SceneBuilder.build,
        the megakernel block); None when the scene is outside it."""
        rows = self.light_rows
        n_tri = len(p0)
        if (use_bvh or self.instances or self.curve_seg_rows
                or self.blp_list
                or n_tri > MAX_MEGA_TRIS or not rows
                or self.materials.tags() != (bxdfs.BXDF_DIFFUSE,)
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

    def _world_bounds(self, lo, hi):
        """World box of the triangles, the bilinear patches' corners, the
        curves' sub-segment boxes and every instance's prototype box
        corners through its o2w (reference build, :627-648)."""
        world_lo, world_hi = lo.min(axis=0), hi.max(axis=0)
        for *corners, _m in self.blp_list:
            world_lo = np.minimum(world_lo, np.min(corners, axis=0))
            world_hi = np.maximum(world_hi, np.max(corners, axis=0))
        if self.curve_seg_bounds:
            world_lo = np.minimum(world_lo, np.concatenate(
                [b[0] for b in self.curve_seg_bounds]).min(axis=0))
            world_hi = np.maximum(world_hi, np.concatenate(
                [b[1] for b in self.curve_seg_bounds]).max(axis=0))
        for inst in self.instances:
            P = self.protos[inst["proto"]]
            if not P["p0"]:
                continue
            plo = np.minimum(np.min(P["p0"], 0), np.minimum(
                np.min(P["p1"], 0), np.min(P["p2"], 0)))
            phi = np.maximum(np.max(P["p0"], 0), np.maximum(
                np.max(P["p1"], 0), np.max(P["p2"], 0)))
            corners = np.stack(np.meshgrid(*zip(plo, phi), indexing="ij"),
                               -1).reshape(-1, 3)
            wc = corners @ inst["o2w"][:, :3].T + inst["o2w"][:, 3]
            world_lo = np.minimum(world_lo, wc.min(axis=0))
            world_hi = np.maximum(world_hi, wc.max(axis=0))
        return world_lo, world_hi

    def _two_level(self, p0, p1, p2, lo, hi):
        """The instancing tables (reference build, :823-914): the world
        triangles as BLAS 0 under an identity instance, one BLAS per
        non-empty prototype, the TLAS. Returns (nodes_all, inst_rows,
        tri_geo_tlas, tlas_root, stack depth, the prototypes' (T', 10)
        geometry rows and (T', 17) shading rows, ids rebased past the
        world's)."""
        world = bvh_mod.build_bvh(lo, hi)
        eye = np.eye(4, dtype=np.float32)[:3]
        blas_list = [(world.nodes, world.prim_indices, lo, hi)]
        ordered = [bvh_mod.pack_tri_geo(p0, p1, p2, order=world.prim_indices)]
        inst_list = [dict(proto=0, o2w=eye, w2o=eye)]
        extra_geo, extra_shade, blas_of = [], [], {}
        gbase = len(p0)
        for pi, P in enumerate(self.protos):
            if not P["p0"]:
                continue
            pp0, pp1, pp2 = (np.stack(P[k]) for k in ("p0", "p1", "p2"))
            plo = np.minimum(np.minimum(pp0, pp1), pp2)
            phi = np.maximum(np.maximum(pp0, pp1), pp2)
            pbvh = bvh_mod.build_bvh(plo, phi)
            # column 9: the global id, past the world's and earlier ones'
            geo_bvh = bvh_mod.pack_tri_geo(pp0, pp1, pp2,
                                           order=pbvh.prim_indices)
            geo_bvh[:, 9] += gbase
            ordered.append(geo_bvh)
            geo = bvh_mod.pack_tri_geo(pp0, pp1, pp2)
            geo[:, 9] += gbase
            extra_geo.append(geo)
            extra_shade.append(np.concatenate([
                np.stack(P["n0"]), np.stack(P["n1"]), np.stack(P["n2"]),
                np.stack(P["uv0"]), np.stack(P["uv1"]), np.stack(P["uv2"]),
                np.asarray(P["mat"], np.float32)[:, None],
                np.full((len(pp0), 1), -1, np.float32)],
                axis=1).astype(np.float32))
            blas_of[pi] = len(blas_list)
            blas_list.append((pbvh.nodes, pbvh.prim_indices, plo, phi))
            gbase += len(pp0)
        inst_list += [dict(inst, proto=blas_of[inst["proto"]])
                      for inst in self.instances if inst["proto"] in blas_of]
        nodes_all, inst_rows, _pb, tlas_root = tlas_mod.build_two_level(
            blas_list, inst_list)
        depth = tlas_mod.stack_depth(nodes_all, inst_rows, tlas_root)
        if depth > bvh2_mod.MAX_DEPTH_TWO_LEVEL:
            raise NotImplementedError(
                f"instance tables need a {depth}-entry traversal stack, "
                f"over the two-level kernel's {bvh2_mod.MAX_DEPTH_TWO_LEVEL}"
                "; the fallback traversal is not ported yet (ROADMAP.md "
                "slice 3 item 10, deep instance trees)")
        return (nodes_all, inst_rows, np.concatenate(ordered), tlas_root,
                depth, extra_geo, extra_shade)

    def _curve_pool(self):
        """The curve tables (reference build, :915-935): the native SAH
        build over the sub-segment boxes, the rows in leaf order, each
        curve's material, the tree depth."""
        rows = np.concatenate(self.curve_seg_rows)
        cbvh = bvh_mod.build_bvh(
            np.concatenate([b[0] for b in self.curve_seg_bounds]),
            np.concatenate([b[1] for b in self.curve_seg_bounds]))
        depth = bvh_mod.bvh_max_depth(cbvh.nodes)
        if depth > crv.MAX_DEPTH:
            raise NotImplementedError(
                f"the curve BVH is {depth} deep, over the curve kernel's "
                f"{crv.MAX_DEPTH} (its {crv.STACK}-entry stack)")
        return cbvh.nodes, rows[cbvh.prim_indices], depth

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
        world_lo, world_hi = self._world_bounds(lo, hi)
        radius = 0.5 * float(np.linalg.norm(world_hi - world_lo)) + 1e-3
        use_bvh = (n_tri > BVH_MIN_TRIS) if force_bvh is None else \
            bool(force_bvh)
        rows = self.light_rows
        for r in rows:     # the scene-radius term of infinite-light power
            if r["tag"] == lgt.LIGHT_UNIFORM_INFINITE:
                base = spc.DenselySampledSpectrum(
                    self.spectra[r["spec_idx"]].astype(np.float64))
                r["power"] = lgt.compute_light_power(
                    r["tag"], r["scale"], base, scene_radius=radius)
        ls = lsamp.make_light_sampler(light_sampler,
                                      [r["power"] for r in rows])
        lights_packed = lgt.pack_light_pool(rows, p0, p1, p2, ls.pmf_table)
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
        if self.instances:
            (nodes_all, inst_rows, tri_geo_tlas, tlas_root, depth,
             extra_geo, extra_shade) = self._two_level(p0, p1, p2, lo, hi)
            tri_geo = np.concatenate([tri_geo] + extra_geo)
            tri_shade = np.concatenate([tri_shade] + extra_shade)
            extra = dict(tlas_nodes=t(nodes_all), inst_rows=t(inst_rows),
                         tri_geo_tlas=t(tri_geo_tlas), tlas_root=tlas_root,
                         tlas_depth=depth, has_instances=True)
        elif use_bvh:
            bvh8 = bvh8_mod.build_bvh8(lo, hi, tri_geo, device=device)
        else:
            tri_pallas = t(ti.pad_triangles(tri_geo[:, :9]))
        if self.curve_seg_rows:
            nodes, segs, depth = self._curve_pool()
            extra.update(curve_nodes=t(nodes), curve_segs=t(segs),
                         curve_mats=torch.as_tensor(
                             np.asarray(self.curve_mat_list, np.int64),
                             device=device),
                         curve_depth=depth, has_curves=True)
        if self.blp_list:
            extra.update(has_blps=True, blp_rows=t(np.stack([
                np.concatenate([*corners, [float(m), -1.0]])
                for *corners, m in self.blp_list])))
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
            n_tris=len(tri_geo), bxdf_tags=self.materials.tags(), **extra)
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
    (inf on a miss), prim (original id, -1 on a miss), b0, b1, b2), and
    inst (the hit's instance row) on an instanced scene."""
    if scene.has_instances:
        return bvh2_mod.two_level_intersect(
            scene.tlas_nodes, scene.inst_rows, scene.tri_geo_tlas,
            scene.tlas_root, o, d, t_max, any_hit, depth=scene.tlas_depth)
    if scene.use_bvh:
        return bvh8_mod.bvh8_intersect(scene.bvh8, o, d, t_max, any_hit)
    t, prim, b1, b2 = ti.tri_intersect(scene.tri_pallas, o, d, t_max,
                                       scene.n_tris, any_hit)
    hit = prim >= 0
    return dict(hit=hit, t=torch.where(hit, t, torch.inf), prim=prim,
                b0=1.0 - b1 - b2, b1=b1, b2=b2)


def _apply_transpose3(a, n):
    """Normals n (N, 3) through the transpose of the 3x3 part of rows a
    (N, 12) [3x4 row-major]: out_i = sum_j a[j, i] n_j."""
    return torch.stack([a[:, i] * n[:, 0] + a[:, 4 + i] * n[:, 1]
                        + a[:, 8 + i] * n[:, 2] for i in range(3)], dim=1)


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
    if scene.has_instances:
        # prototypes are stored in object space: the hit triangle to world
        # by the instance's o2w, its shading normals by w2o^T
        irow = scene.inst_rows[torch.clamp(r["inst"], min=0).to(torch.int64)]
        p0, p1, p2 = (bvh2_mod.transform_rows(irow[:, 12:24], x, points=True)
                      for x in (p0, p1, p2))
        n0, n1, n2 = (_apply_transpose3(irow[:, 0:12], x)
                      for x in (n0, n1, n2))
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
    # the reference's order: patches, then curves, then the floor, under
    # which a patch or curve hit keeps the triangle query's p_err
    if scene.has_blps:
        out = _merge_blp_hits(scene, o, d, t_max, out)
    if scene.has_curves:
        out = _merge_curve_hits(scene, o, d, t_max, out)
    out["p_err"] = torch.maximum(out["p_err"], gamma_bound(7)
                                 * torch.abs(out["p"]))
    return out


def _blp_query(scene: Scene, o, d, t_max):
    """Closest hit over the small bilinear-patch pool, every ray against
    every patch. Returns dict(hit, t, k (patch id), u, v)."""
    rows = scene.blp_rows
    r = isect_ops.ray_bilinear_patch(
        o[:, None, :], d[:, None, :],
        t_max[:, None].expand(o.shape[0], rows.shape[0]),
        rows[None, :, 0:3], rows[None, :, 3:6], rows[None, :, 6:9],
        rows[None, :, 9:12])
    k = torch.argmin(r["t"], dim=-1)

    def take(a):
        return torch.gather(a, 1, k[:, None])[:, 0]
    t = take(r["t"])
    return dict(hit=torch.isfinite(t), t=t, k=k, u=take(r["u"]),
                v=take(r["v"]))


def _merge_blp_hits(scene: Scene, o, d, t_max, out):
    """Merge the closest bilinear-patch hit below the triangle hit
    (reference _merge_blp_hits): the position on the ray, uv = (u, v) and
    dpdu, dpdv of the patch's own parameterisation, the normal their cross
    product, the patch's material, no light; prim stays the triangle
    query's."""
    t_best = torch.where(out["hit"], out["t"], t_max)
    r = _blp_query(scene, o, d, t_best)
    hit_b = r["hit"] & (r["t"] < t_best)
    row = scene.blp_rows[r["k"]]
    p00, p10, p01, p11 = (row[:, 3 * i:3 * i + 3] for i in range(4))
    u, v = r["u"], r["v"]
    dpdu = (1 - v)[:, None] * (p10 - p00) + v[:, None] * (p11 - p01)
    dpdv = (1 - u)[:, None] * (p01 - p00) + u[:, None] * (p11 - p10)
    ng = vm.normalize(vm.cross(dpdu, dpdv))
    h = hit_b[:, None]
    return dict(out,
                hit=out["hit"] | hit_b,
                t=torch.where(hit_b, r["t"], out["t"]),
                p=torch.where(h, o + r["t"][:, None] * d, out["p"]),
                ng=torch.where(h, ng, out["ng"]),
                ns=torch.where(h, ng, out["ns"]),
                uv=torch.where(h, torch.stack([u, v], dim=-1), out["uv"]),
                mat=torch.where(hit_b, row[:, 12].round().to(torch.int64),
                                out["mat"]),
                light=torch.where(hit_b, -1, out["light"]),
                dpdu=torch.where(h, dpdu, out["dpdu"]),
                dpdv=torch.where(h, dpdv, out["dpdv"]))


def _merge_curve_hits(scene: Scene, o, d, t_max, out):
    """Merge the closest curve hit below the triangle hit (reference
    _merge_curve_hits): the position on the ray, the normal turned against
    the ray (curves are two-sided), uv = (u along, v across), dpdu the
    segment's chord (the hair frame's +x), prim -1000000 - curve id, the
    curve's material, no light."""
    t_best = torch.where(out["hit"], out["t"], t_max)
    rc = crv.intersect_curves(scene.curve_nodes, scene.curve_segs, o, d,
                              t_best, depth=scene.curve_depth)
    hit_c = rc["hit"] & (rc["t"] < t_best)
    h = hit_c[:, None]
    n_c = rc["n"]
    n_c = torch.where((vm.dot(n_c, d) > 0)[:, None], -n_c, n_c)
    cid = torch.clamp(rc["curve_id"], min=0)
    dpdu_c = rc["axis"]
    return dict(out,
                hit=out["hit"] | hit_c,
                t=torch.where(hit_c, rc["t"], out["t"]),
                prim=torch.where(hit_c, -1000000 - cid, out["prim"]),
                p=torch.where(h, o + rc["t"][:, None] * d, out["p"]),
                ng=torch.where(h, n_c, out["ng"]),
                ns=torch.where(h, n_c, out["ns"]),
                uv=torch.where(h, torch.stack([rc["u"], rc["v"]], dim=-1),
                               out["uv"]),
                dpdu=torch.where(h, dpdu_c, out["dpdu"]),
                dpdv=torch.where(h, vm.normalize(vm.cross(n_c, dpdu_c)),
                                 out["dpdv"]),
                mat=torch.where(hit_c, scene.curve_mats[torch.clamp(
                    cid, max=scene.curve_mats.shape[0] - 1)], out["mat"]),
                light=torch.where(hit_c, -1, out["light"]))


def intersect_p(scene: Scene, o, d, t_max):
    """Any-hit (shadow) query. Returns bool occluded (N,)."""
    o, d, t_max = o.contiguous(), d.contiguous(), t_max.contiguous()
    occluded = _tri_dispatch(scene, o, d, t_max, any_hit=True)["hit"]
    if scene.has_blps:
        occluded = occluded | _blp_query(scene, o, d, t_max)["hit"]
    if scene.has_curves:
        _t, seg = crv.curves_intersect(scene.curve_nodes, scene.curve_segs,
                                       o, d, t_max, True,
                                       depth=scene.curve_depth)
        occluded = occluded | (seg >= 0)
    return occluded


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
