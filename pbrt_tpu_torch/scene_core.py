"""Compiled scene (counterpart of pbrt_tpu/scene_core.py): the SceneBuilder
subset the cornell box needs, and the tables the megakernel reads.

A scene is built on the host in numpy and moved once to the device the
caller names. Only the megakernel's closed world is ported — triangle
meshes with diffuse materials and area-triangle emission, at most 64
triangles, a uniform or power light sampler, one emission spectrum — so
`build` applies the reference's eligibility test (scene_core.py, the
megakernel block of SceneBuilder.build) and raises NotImplementedError for
anything outside it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import device as dev_mod
from . import lights as lgt
from . import lightsamplers as lsamp
from . import materials as mtl
from .ops.megawave import MegaMeta, ATTR_COLS, LIGHT_COLS
from .ops.tri_intersect import pad_triangles
from .utils import color as pcolor
from .utils import spectrum as spc

MAX_MEGA_TRIS = 64


@dataclasses.dataclass
class Scene:
    """Device tables of an eligible scene.

    tri_pallas: (T*16,) [p0, e1, e2, pad] per triangle, T padded to 4;
    attr: (n_tris*11,) [p0 p1 p2 mat light]; light: (L*16,) [va vb vc
    scale pmf two_sided q alias pmf_self pmf_alias]; mat: (M*3,) sigmoid
    albedo coefficients; spectra_pool: (S, 471); lights_packed: (L, 24)."""
    tri_pallas: torch.Tensor
    attr: torch.Tensor
    light: torch.Tensor
    mat: torch.Tensor
    spectra_pool: torch.Tensor
    lights_packed: torch.Tensor
    mega: MegaMeta

    @property
    def device(self) -> torch.device:
        return self.tri_pallas.device


class SceneBuilder:
    """Host-side scene assembly (reference SceneBuilder subset)."""

    def __init__(self):
        self.cs = pcolor.srgb()
        self.materials = mtl.MaterialBuilder(self.cs)
        self.p0, self.p1, self.p2 = [], [], []
        self.t_mat = []
        self.t_light = []
        self.light_rows = []
        self.spectra = []
        self._spec_cache = {}

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

    def add_mesh(self, vertices, indices, material: int, emission=None,
                 emission_scale=1.0, two_sided=False):
        """vertices (V, 3); indices (F, 3); emission: host Spectrum making
        each triangle an area light. Returns the light indices created."""
        vertices = np.asarray(vertices, np.float32)
        indices = np.asarray(indices, np.int64)
        p0 = vertices[indices[:, 0]]
        p1 = vertices[indices[:, 1]]
        p2 = vertices[indices[:, 2]]
        created = []
        for i in range(len(p0)):
            tri = len(self.t_mat)
            self.p0.append(p0[i])
            self.p1.append(p1[i])
            self.p2.append(p2[i])
            self.t_mat.append(material)
            if emission is None:
                self.t_light.append(-1)
                continue
            area = 0.5 * np.linalg.norm(np.cross(p1[i] - p0[i],
                                                 p2[i] - p0[i]))
            li = len(self.light_rows)
            self.light_rows.append(dict(
                tag=lgt.LIGHT_AREA_TRI,
                spec_idx=self.add_spectrum(emission,
                                           key=("emit", id(emission))),
                scale=emission_scale, tri=tri, two_sided=two_sided,
                power=lgt.compute_light_power(
                    lgt.LIGHT_AREA_TRI, emission_scale, emission, area=area,
                    two_sided=two_sided)))
            self.t_light.append(li)
            created.append(li)
        return created

    def _check_eligible(self, light_sampler: str):
        n_tri = len(self.p0)
        rows = self.light_rows
        why = None
        if n_tri == 0:
            why = "empty scene"
        elif n_tri > MAX_MEGA_TRIS:
            why = (f"{n_tri} triangles (the brute-force megakernel takes at "
                   f"most {MAX_MEGA_TRIS}; larger meshes need the BVH8 "
                   "kernel, ROADMAP.md slice 2)")
        elif not rows:
            why = "no area light (ROADMAP.md slice 2: infinite lights)"
        elif light_sampler not in ("uniform", "power"):
            why = f"light sampler {light_sampler!r} (ROADMAP.md slice 3)"
        elif len({r["spec_idx"] for r in rows}) != 1:
            why = "more than one emission spectrum (ROADMAP.md slice 3)"
        if why is not None:
            raise NotImplementedError(
                "scene outside the megakernel's closed world: " + why)

    def build(self, light_sampler="power", device="cpu") -> Scene:
        device = dev_mod.resolve(device)
        self._check_eligible(light_sampler)
        p0, p1, p2 = (np.stack(v) for v in (self.p0, self.p1, self.p2))
        rows = self.light_rows
        ls = lsamp.make_light_sampler(light_sampler,
                                      [r["power"] for r in rows])
        lights_packed = lgt.pack_area_lights(rows, p0, p1, p2, ls.pmf_table)
        n_tri = len(p0)
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
        mega = MegaMeta(n_tris=n_tri, n_mats=len(self.materials.rows),
                        n_lights=len(rows),
                        light_spec=int(rows[0]["spec_idx"]),
                        ls_uniform=bool(ls.kind == lsamp.LS_UNIFORM))

        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                   device=device)

        return Scene(
            tri_pallas=t(pad_triangles(np.concatenate([p0, p1, p2], 1))),
            attr=t(attr.reshape(-1)), light=t(light.reshape(-1)),
            mat=t(self.materials.coeffs().reshape(-1)),
            spectra_pool=t(np.stack(self.spectra)),
            lights_packed=t(lights_packed), mega=mega)
