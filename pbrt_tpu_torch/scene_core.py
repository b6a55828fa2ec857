"""Compiled scene (counterpart of pbrt_tpu/scene_core.py): the SceneBuilder
subset of the ported slices, the device tables, and the intersection entry
points of the general path wave.

A scene is built on the host in numpy and moved once to the device the
caller names. It holds triangle meshes (per-vertex normals and uvs when
given) with diffuse, conductor, dielectric and hair materials, cubic
Bezier curves, exact bilinear patches, exact quadrics (spheres, disks,
cylinders), area-triangle and sphere emission, uniform infinite lights and
an image infinite light, under a uniform, power, light-BVH or exhaustive
light sampler, image and constant textures on the diffuse reflectance,
static object instances of triangle prototypes, homogeneous and grid
media (media.py) and the null-material triangles of medium interfaces.
Other shapes, lights, materials, media, textures, animated instances and
alpha are not ported: their builders do not exist here, and the parser
refuses their directives.

Triangle queries follow the reference's dispatch (_tri_dispatch): a scene
with instances sends every closest and any hit through the two-level
kernel (ops/bvh2.py) over its TLAS and BLASes; otherwise, above 4096
triangles or with force_bvh, through the BVH8 kernel (ops/bvh8.py) over
the whole scene, and below through the brute-force triangle kernel
(ops/tri_intersect.py). A scene with curves then sends every query
through the curve kernel (ops/curves.py) as well, over the curves' own
BVH, and merges its hits as the reference does; a scene with bilinear
patches tests every ray against its small patch pool in tensor code
(ops/intersect.py), before the curves, and a scene with quadrics tests
every ray against each quadric in its object space (tensor code, a static
loop over the quadrics as in the reference), before the patches.
Medium-interface triangles stay out of the main tables, as in the
reference: `intersect_interfaces` tests a pool of up to 256 of them in
tensor code and a larger one through its own binary BVH and the
single-level bvh2 kernel (ops/bvh2.bvh2_intersect), and shadow rays never
see them. The megakernel's
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
from . import media as med_mod
from . import spans
from . import textures as tex_mod
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
IFACE_BVH_MIN = 257   # interface pools from this size traverse a BVH
# the reference's quadric tags
QUADRIC_SPHERE = 0
QUADRIC_DISK = 1
QUADRIC_CYLINDER = 2
QUADRIC_COLS = 18


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
    stack the tables need, tlas_kernel the two-level kernel's own tables
    (bvh2.kernel_tables of inst_rows and tri_geo_tlas); None (0, False)
    without instances. Scenes with curves (ops/curves.py): curve_nodes (M, 8) the curve BVH, curve_segs
    (S, 16) its sub-segment rows in leaf order, curve_mats (C,) int64 the
    material of each curve id, curve_depth the tree's depth, curve_wide
    (W, 16) int32 the curve kernel's own node table (curves.wide_nodes of
    curve_nodes); None (0, False) without curves. blp_rows (K, 14) the
    exact bilinear patches [p00, p10, p01, p11, material, -1]; None (False)
    without patches.
    bxdf_tags: the BxDF tags of the material pool. env: the image infinite
    light's tables (lights.EnvLight), None without one. textures: the
    texture pool (textures.TexturePool); has_textures: a material reads
    a texture. The light sampler of a bvh or exhaustive scene holds its
    own tables on the scene's device.
    quadrics (Q, 18) the reference's rows [w2o (3x4), radius, p0, p1,
    material, light, phi_max] (p0, p1: z range of a cylinder, inner radius
    and height of a disk), quadric_o2w (Q, 9) the inverse of each row's
    3x3 (the tangent transform), quadric_tags the host tuple of their
    QUADRIC_* tags, n_spheres; None, () without quadrics. media: the
    medium pool (media.MediumPool, always present; an empty one has a
    single zero row), has_media; iface_tris (M, 10) the interface
    triangles [p0, p1, p2, 0], iface_med (M, 2) [medium behind, in front
    of] the geometric normal (-1 vacuum), iface_nodes / iface_tris_bvh /
    iface_depth the pool's binary BVH and leaf-ordered rows (id in column
    9) above 256 triangles, has_medium_interfaces."""
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
    tlas_kernel: bvh2_mod.TwoLevelTables = None
    has_instances: bool = False
    curve_nodes: torch.Tensor = None
    curve_segs: torch.Tensor = None
    curve_mats: torch.Tensor = None
    curve_depth: int = 0
    curve_wide: torch.Tensor = None
    has_curves: bool = False
    blp_rows: torch.Tensor = None
    has_blps: bool = False
    bxdf_tags: tuple = (bxdfs.BXDF_DIFFUSE,)
    env: lgt.EnvLight = None
    textures: tex_mod.TexturePool = None
    has_textures: bool = False
    quadrics: torch.Tensor = None
    quadric_o2w: torch.Tensor = None
    quadric_tags: tuple = ()
    n_spheres: int = 0
    media: med_mod.MediumPool = None
    has_media: bool = False
    iface_tris: torch.Tensor = None
    iface_med: torch.Tensor = None
    iface_nodes: torch.Tensor = None
    iface_tris_bvh: torch.Tensor = None
    iface_depth: int = 0
    has_medium_interfaces: bool = False

    @property
    def device(self) -> torch.device:
        return self.tri_all.device

    @property
    def use_bvh(self) -> bool:
        return self.bvh8 is not None

    @property
    def has_area_lights(self) -> bool:
        """Emitting triangles or spheres (a hit can return emission)."""
        return bool({lgt.LIGHT_AREA_TRI, lgt.LIGHT_AREA_SPHERE}
                    & set(self.light_tags))

    @property
    def use_iface_bvh(self) -> bool:
        return self.iface_nodes is not None


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
        self.protos = []
        self.instances = []
        self.curve_seg_rows = []     # (2^crv.SUBDIV, 16) rows of each curve
        self.curve_seg_bounds = []   # (lo, hi) of its sub-segments
        self.curve_mat_list = []     # material of each curve id
        self.blp_list = []           # (p00, p10, p01, p11, material)
        self._env_image = None       # (image, scale) of the image light
        self.quadric_rows = []       # dicts: tag, w2o (3, 4), radius, p0,
        #                              p1, mat, light, phi_max, bounds
        self.iface_rows = []         # (p0, p1, p2, med_in, med_out)
        self.media = med_mod.MediumBuilder(self.cs)

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

    def add_interface_mesh(self, vertices, indices, med_in=-1, med_out=-1):
        """Null-material medium-interface triangles (reference
        add_interface_mesh): a ray that crosses one switches to med_in on
        the back side of its geometric normal and to med_out on the front,
        without scattering; shadow rays ignore them. med_in, med_out:
        indices into self.media (-1 vacuum)."""
        vertices = np.asarray(vertices, np.float32)
        indices = np.asarray(indices, np.int64)
        for i0, i1, i2 in indices:
            self.iface_rows.append((vertices[i0], vertices[i1], vertices[i2],
                                    int(med_in), int(med_out)))

    def add_sphere(self, center, radius, material: int, emission=None,
                   emission_scale=1.0) -> int:
        """An exact sphere (reference add_sphere): its row holds the world
        to object translation; emission makes it a sphere light (centre in
        the light's p, radius in cfs, its quadric row in tri), weighed by
        the power of a one-sided emitter of area 4 pi r^2. Returns the
        light index, -1 without emission."""
        center = np.asarray(center, np.float32)
        qi = len(self.quadric_rows)
        light = -1
        if emission is not None:
            light = len(self.light_rows)
            self.light_rows.append(dict(
                tag=lgt.LIGHT_AREA_SPHERE, p=center, dir=np.zeros(3),
                spec_idx=self.add_spectrum(emission,
                                           key=("emit", id(emission))),
                scale=emission_scale, tri=qi, two_sided=False, cfs=radius,
                cfe=0.0, is_delta=False,
                power=lgt.compute_light_power(
                    lgt.LIGHT_AREA_SPHERE, emission_scale, emission,
                    area=4 * np.pi * radius ** 2)))
        w2o = np.concatenate([np.eye(3, dtype=np.float32),
                              -center[:, None]], axis=1)
        self.quadric_rows.append(dict(
            tag=QUADRIC_SPHERE, w2o=w2o, radius=float(radius),
            p0=-float(radius), p1=float(radius), mat=material, light=light,
            phi_max=2 * np.pi, bounds=(center - radius, center + radius)))
        return light

    def _add_transformed_quadric(self, tag, object_to_world, radius, p0, p1,
                                 material, phi_max, obj_lo, obj_hi) -> int:
        """A quadric row under an affine object_to_world (4, 4), inverted in
        float64; its world box from the 8 transformed corners of its
        object box."""
        o2w = np.asarray(object_to_world, np.float64).reshape(4, 4)
        w2o = np.linalg.inv(o2w)[:3, :4].astype(np.float32)
        corners = np.stack(np.meshgrid(*zip(obj_lo, obj_hi), indexing="ij"),
                           -1).reshape(-1, 3)
        wc = corners @ o2w[:3, :3].T + o2w[:3, 3]
        self.quadric_rows.append(dict(
            tag=tag, w2o=w2o, radius=float(radius), p0=float(p0),
            p1=float(p1), mat=material, light=-1, phi_max=float(phi_max),
            bounds=(wc.min(axis=0).astype(np.float32),
                    wc.max(axis=0).astype(np.float32))))
        return len(self.quadric_rows) - 1

    def add_quadric_sphere(self, object_to_world, radius,
                           material: int) -> int:
        """An exact sphere under any affine transform, ellipsoids included
        (no emission: an emissive sphere is add_sphere's)."""
        r = float(radius)
        return self._add_transformed_quadric(
            QUADRIC_SPHERE, object_to_world, r, -r, r, material, 2 * np.pi,
            obj_lo=(-r, -r, -r), obj_hi=(r, r, r))

    def add_disk(self, object_to_world, radius, material: int, height=0.0,
                 inner_radius=0.0, phi_max=2 * np.pi) -> int:
        """An exact disk: the annulus inner_radius <= r <= radius at z =
        height in object space (no emission)."""
        r = float(radius)
        return self._add_transformed_quadric(
            QUADRIC_DISK, object_to_world, r, inner_radius, height, material,
            phi_max, obj_lo=(-r, -r, height - 1e-4),
            obj_hi=(r, r, height + 1e-4))

    def add_cylinder(self, object_to_world, radius, z_min, z_max,
                     material: int, phi_max=2 * np.pi) -> int:
        """An exact cylinder x^2 + y^2 = r^2, z_min <= z <= z_max in object
        space (no emission)."""
        r = float(radius)
        return self._add_transformed_quadric(
            QUADRIC_CYLINDER, object_to_world, r, z_min, z_max, material,
            phi_max, obj_lo=(-r, -r, z_min), obj_hi=(r, r, z_max))

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
        equal-area octahedral layout (utils/image_env.equalarea_from_latlong
        for lat-long maps); its power is the mean luminance times scale,
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
        if (use_bvh or self.instances or self.curve_seg_rows
                or self.blp_list or self.quadric_rows or self.iface_rows
                or self.media.rows
                or n_tri > MAX_MEGA_TRIS or not rows
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
        cos_theta_e 0; a sphere light's box, emitting every way; infinite
        lights outside the tree."""
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
            elif r["tag"] == lgt.LIGHT_AREA_SPHERE:
                lo[i] = r["p"] - r["cfs"]
                hi[i] = r["p"] + r["cfs"]
            else:   # the infinite lights
                inf[i] = True
        return dict(bounds_lo=lo, bounds_hi=hi, axis_w=w, cos_theta_o=cos_o,
                    cos_theta_e=cos_e,
                    power=np.asarray([r["power"] for r in rows], np.float64),
                    is_infinite=inf)

    def _world_bounds(self, lo, hi):
        """World box of the triangles, the medium boxes, the quadrics'
        boxes, the interface triangles, the bilinear patches' corners, the
        curves' sub-segment boxes and every instance's prototype box
        corners through its o2w (reference build, :614-648)."""
        world_lo, world_hi = lo.min(axis=0), hi.max(axis=0)
        for r in self.media.rows:
            world_lo = np.minimum(world_lo, r[15:18])
            world_hi = np.maximum(world_hi, r[18:21])
        for q in self.quadric_rows:
            world_lo = np.minimum(world_lo, q["bounds"][0])
            world_hi = np.maximum(world_hi, q["bounds"][1])
        for *tri, _mi, _mo in self.iface_rows:
            world_lo = np.minimum(world_lo, np.min(tri, axis=0))
            world_hi = np.maximum(world_hi, np.max(tri, axis=0))
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

    def _quadric_tables(self, t):
        """The quadric rows (reference build, :675-681), each row's tangent
        transform, the tags and the sphere count."""
        quad = np.stack([np.concatenate([
            q["w2o"].reshape(-1), [q["radius"], q["p0"], q["p1"],
                                   float(q["mat"]), float(q["light"]),
                                   q["phi_max"]]])
            for q in self.quadric_rows]).astype(np.float32)
        o2w = np.stack([np.linalg.inv(r[0:12].reshape(3, 4)[:, :3])
                        for r in quad]).reshape(-1, 9)
        tags = tuple(q["tag"] for q in self.quadric_rows)
        return dict(quadrics=t(quad), quadric_o2w=t(o2w), quadric_tags=tags,
                    n_spheres=sum(1 for g in tags if g == QUADRIC_SPHERE))

    def _interface_tables(self, t, device):
        """The interface pool (reference build, :947-969): its rows and
        media, and above 256 triangles its binary BVH and leaf-ordered rows
        for the single-level bvh2 kernel."""
        p0, p1, p2 = (np.stack([r[k] for r in self.iface_rows])
                      for k in range(3))
        n = len(p0)
        out = dict(
            iface_tris=t(np.concatenate([p0, p1, p2, np.zeros((n, 1))],
                                        axis=1)),
            iface_med=t([[r[3], r[4]] for r in self.iface_rows]),
            has_medium_interfaces=True)
        if n >= IFACE_BVH_MIN:
            ibvh = bvh_mod.build_bvh(np.minimum(np.minimum(p0, p1), p2),
                                     np.maximum(np.maximum(p0, p1), p2))
            depth = bvh_mod.bvh_max_depth(ibvh.nodes)
            if depth > bvh2_mod.MAX_DEPTH:
                raise NotImplementedError(
                    f"the interface BVH is {depth} deep, over the bvh2 "
                    f"kernel's {bvh2_mod.MAX_DEPTH}")
            out.update(iface_nodes=t(ibvh.nodes), iface_depth=depth,
                       iface_tris_bvh=t(bvh_mod.pack_tri_geo(
                           p0, p1, p2, order=ibvh.prim_indices)))
        return out

    @spans.span("scene.build")
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
            if any(r["tag"] not in (lgt.LIGHT_AREA_TRI, lgt.LIGHT_AREA_SPHERE)
                   for r in rows):
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

        @spans.span("scene.upload")
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
            extra["tlas_kernel"] = bvh2_mod.kernel_tables(
                extra["inst_rows"], extra["tri_geo_tlas"])
        elif use_bvh:
            bvh8 = bvh8_mod.build_bvh8(lo, hi, tri_geo, device=device)
        else:
            tri_pallas = t(ti.pad_triangles(tri_geo[:, :9]))
        if self.curve_seg_rows:
            nodes, segs, depth = self._curve_pool()
            nodes = t(nodes)
            extra.update(curve_nodes=nodes, curve_segs=t(segs),
                         curve_wide=crv.wide_nodes(nodes),
                         curve_mats=torch.as_tensor(
                             np.asarray(self.curve_mat_list, np.int64),
                             device=device),
                         curve_depth=depth, has_curves=True)
        if self.blp_list:
            extra.update(has_blps=True, blp_rows=t(np.stack([
                np.concatenate([*corners, [float(m), -1.0]])
                for *corners, m in self.blp_list])))
        if self.quadric_rows:
            extra.update(self._quadric_tables(t))
        if self.iface_rows:
            extra.update(self._interface_tables(t, device))
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
            has_textures=self.materials.has_textures(),
            media=self.media.build(device), has_media=bool(self.media.rows),
            **extra)
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
            scene.tlas_root, o, d, t_max, any_hit, depth=scene.tlas_depth,
            kernel=scene.tlas_kernel)
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
    # the reference's order: quadrics, patches, then curves, then the
    # floor, under which a patch or curve hit keeps the triangle query's
    # p_err
    if scene.quadric_tags:
        out = _merge_quadric_hits(scene, o, d, t_max, out)
    if scene.has_blps:
        out = _merge_blp_hits(scene, o, d, t_max, out)
    if scene.has_curves:
        out = _merge_curve_hits(scene, o, d, t_max, out)
    out["p_err"] = torch.maximum(out["p_err"], gamma_bound(7)
                                 * torch.abs(out["p"]))
    return out


def _affine3(m, x, stride=3, offset=False):
    """x (N, 3) through the 3x3 part of row-major rows m (stride floats a
    row): out_i = sum_j m[i, j] x_j, plus m[i, 3] with offset (a 3x4
    row), elementwise in the reference's order."""
    out = [m[stride * i] * x[:, 0] + m[stride * i + 1] * x[:, 1]
           + m[stride * i + 2] * x[:, 2] for i in range(3)]
    if offset:
        out = [v + m[stride * i + 3] for i, v in enumerate(out)]
    return torch.stack(out, dim=-1)


def _quadric_ray(row, o, d):
    """World rays into a quadric's object space by its w2o (the direction
    is not normalised, so t stays the world ray's)."""
    return _affine3(row, o, 4, offset=True), _affine3(row, d, 4)


def _quadric_test(tag, row, o_obj, d_obj, t_best):
    """The object-space test of a quadric of static tag below t_best."""
    radius, q0, q1, phi_max = row[12], row[13], row[14], row[17]
    if tag == QUADRIC_SPHERE:
        return isect_ops.ray_sphere(o_obj, d_obj, t_best, radius)
    if tag == QUADRIC_DISK:
        return isect_ops.ray_disk(o_obj, d_obj, t_best, radius, height=q1,
                                  inner_radius=q0, phi_max=phi_max)
    return isect_ops.ray_cylinder(o_obj, d_obj, t_best, radius, q0, q1,
                                  phi_max=phi_max)


def _merge_quadric_hits(scene: Scene, o, d, t_max, out):
    """Merge each quadric's hit below the best so far (reference
    _merge_quadric_hits, a static loop over the quadrics): the position on
    the world ray, the object normal through w2o^T, uv = (phi / phi_max,
    theta / pi | the radial or the height fraction), dpdu the object phi
    direction (-y, x, 0) through the tangent transform (a frame about the
    normal at the poles), dpdv = n x dpdu, prim -(q + 1), the quadric's
    material and light, p_err gamma(5) |p|. p0, p1, p2 stay the triangle
    query's: a sphere light's MIS reads its own pdf."""
    t_best = torch.where(out["hit"], out["t"], t_max)
    for q, tag in enumerate(scene.quadric_tags):
        row = scene.quadrics[q]
        o_obj, d_obj = _quadric_ray(row, o, d)
        rq = _quadric_test(tag, row, o_obj, d_obj, t_best)
        hit_q = rq["hit"] & (rq["t"] < t_best)
        t_best = torch.where(hit_q, rq["t"], t_best)
        p_obj = rq["p"]
        radius, q0, q1, phi_max = row[12], row[13], row[14], row[17]
        zero = torch.zeros_like(p_obj[:, 2])
        if tag == QUADRIC_SPHERE:
            n_obj = p_obj / torch.clamp(radius, min=1e-9)
            theta = torch.acos(torch.clamp(
                p_obj[:, 2] / torch.clamp(radius, min=1e-9), -1, 1))
            uv_q = torch.stack([rq["phi"] / phi_max, theta / np.pi], -1)
        elif tag == QUADRIC_DISK:
            n_obj = torch.stack([zero, zero, zero + 1.0], -1)
            r_hit = torch.sqrt(p_obj[:, 0] ** 2 + p_obj[:, 1] ** 2)
            v = (radius - r_hit) / torch.clamp(radius - q0, min=1e-9)
            uv_q = torch.stack([rq["phi"] / phi_max, v], -1)
        else:
            n_obj = torch.stack([p_obj[:, 0], p_obj[:, 1], zero], -1) / \
                torch.clamp(radius, min=1e-9)
            v = (p_obj[:, 2] - q0) / torch.clamp(q1 - q0, min=1e-9)
            uv_q = torch.stack([rq["phi"] / phi_max, v], -1)
        p_q = o + rq["t"][:, None] * d
        # n A (the transpose of w2o's 3x3 applied to n)
        n_q = vm.normalize(torch.stack(
            [n_obj[:, 0] * row[j] + n_obj[:, 1] * row[4 + j]
             + n_obj[:, 2] * row[8 + j] for j in range(3)], -1))
        dpdu_obj = torch.stack([-p_obj[:, 1], p_obj[:, 0], zero], -1)
        dpdu_q = vm.normalize(_affine3(scene.quadric_o2w[q], dpdu_obj))
        t1q, _ = vm.coordinate_system(n_q)
        bad = vm.length_squared(dpdu_obj) < 1e-12
        dpdu_q = torch.where(bad[:, None], t1q, dpdu_q)
        dpdv_q = vm.normalize(vm.cross(n_q, dpdu_q))
        h = hit_q[:, None]
        out = dict(out,
                   hit=out["hit"] | hit_q,
                   t=torch.where(hit_q, rq["t"], out["t"]),
                   prim=torch.where(hit_q, -(q + 1), out["prim"]),
                   p=torch.where(h, p_q, out["p"]),
                   ng=torch.where(h, n_q, out["ng"]),
                   ns=torch.where(h, n_q, out["ns"]),
                   uv=torch.where(h, uv_q, out["uv"]),
                   dpdu=torch.where(h, dpdu_q, out["dpdu"]),
                   dpdv=torch.where(h, dpdv_q, out["dpdv"]),
                   mat=torch.where(hit_q, row[15].to(torch.int64),
                                   out["mat"]),
                   light=torch.where(hit_q, row[16].to(torch.int64),
                                     out["light"]),
                   p_err=torch.where(h, gamma_bound(5) * torch.abs(p_q),
                                     out["p_err"]))
    return out


@spans.span("scene.interfaces")
def intersect_interfaces(scene: Scene, o, d, t_max):
    """Closest hit of rays o, d (N, 3) below t_max (N,) on the
    medium-interface triangles (reference intersect_interfaces): a pool of
    up to 256 every ray against every triangle (Moeller-Trumbore, t >
    1e-5), a larger one through its BVH and the single-level bvh2 kernel
    (its plain version on the CPU). Returns dict(hit, t (inf on a miss),
    ng (the triangle's unit normal), med_in, med_out (int64))."""
    if scene.use_iface_bvh:
        r = bvh2_mod.bvh2_intersect(scene.iface_nodes, scene.iface_tris_bvh,
                                    o.contiguous(), d.contiguous(),
                                    t_max.contiguous(), False,
                                    depth=scene.iface_depth)
        hit = r["hit"]
        k = torch.clamp(r["prim"], min=0).to(torch.int64)
        t_hit = r["t"]
    else:
        tri = scene.iface_tris
        p0 = tri[None, :, 0:3]
        e1 = tri[None, :, 3:6] - p0
        e2 = tri[None, :, 6:9] - p0
        ov = o[:, None, :]
        dv = d[:, None, :]
        pv = vm.cross(dv, e2)
        det = vm.dot(e1, pv)
        inv_det = 1.0 / torch.where(torch.abs(det) < 1e-12, 1.0, det)
        tv = ov - p0
        u = vm.dot(tv, pv) * inv_det
        qv = vm.cross(tv, e1)
        v = vm.dot(dv, qv) * inv_det
        t = vm.dot(e2, qv) * inv_det
        ok = (torch.abs(det) > 1e-12) & (u >= 0) & (v >= 0) & \
            (u + v <= 1) & (t > 1e-5) & (t < t_max[:, None])
        t = torch.where(ok, t, torch.inf)
        t_hit, k = torch.min(t, dim=-1)
        hit = torch.isfinite(t_hit)
    row = scene.iface_tris[k]
    ng = vm.normalize(vm.cross(row[:, 3:6] - row[:, 0:3],
                               row[:, 6:9] - row[:, 0:3]))
    med = scene.iface_med[k].round().to(torch.int64)
    return dict(hit=hit, t=torch.where(hit, t_hit, torch.inf), ng=ng,
                med_in=med[:, 0], med_out=med[:, 1])


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
                              t_best, depth=scene.curve_depth,
                              wide=scene.curve_wide)
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


@spans.span("scene.shadow")
def intersect_p(scene: Scene, o, d, t_max):
    """Any-hit (shadow) query. Returns bool occluded (N,)."""
    o, d, t_max = o.contiguous(), d.contiguous(), t_max.contiguous()
    occluded = _tri_dispatch(scene, o, d, t_max, any_hit=True)["hit"]
    for q, tag in enumerate(scene.quadric_tags):
        row = scene.quadrics[q]
        o_obj, d_obj = _quadric_ray(row, o, d)
        occluded = occluded | _quadric_test(tag, row, o_obj, d_obj,
                                            t_max)["hit"]
    if scene.has_blps:
        occluded = occluded | _blp_query(scene, o, d, t_max)["hit"]
    if scene.has_curves:
        _t, seg = crv.curves_intersect(scene.curve_nodes, scene.curve_segs,
                                       o, d, t_max, True,
                                       depth=scene.curve_depth,
                                       wide=scene.curve_wide)
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


def offset_ray_origin(p, ng, w):
    """The scaled-epsilon offset where no error bound is known (reference
    offset_ray_origin): 1e-4 max(max |p|, 1) along ng, to the side of w
    (the volumetric wave's interface crossings)."""
    eps = 1e-4 * torch.clamp(torch.abs(p).amax(dim=-1), min=1.0)
    sign = torch.where(vm.dot(w, ng) > 0, 1.0, -1.0)
    return p + (sign * eps)[:, None] * ng
