"""State carried across from the JAX package.

`from_jax_scene` takes the fields of a pbrt_tpu Scene, Camera and
SamplerParams, exported to numpy by the caller (this package imports no
jax), and returns the port's (Scene, Camera, SamplerParams) on a device, so
both packages can compute on the same scene.

arrays: "tri_all" (T, 27); "mat_pool" (M, 22); "lights_packed" (L, 24);
"spectra_pool" (S, 471); "ls_rows" (L, 4) and "ls_pmf" (L,), the light
sampler's alias rows and pmf table; "c2w_m" (4, 4); "tan_half_fov" ();
"tri_pallas" (T'*16,) on the brute-force route; "nodes_f", "nodes_q",
"tris_b8", "prim_indices" (the BVH8 tables) on the BVH route;
"tlas_nodes", "inst_rows", "tri_geo_tlas" (the two-level tables) for an
instanced scene; "curve_nodes", "curve_segs", "curve_mats" (the curve
tables) for a scene with curves; "blp_rows" (K, 14) for a scene with
bilinear patches; "attr", "light", "mat" (the reference's
megawave.scene_tables) for a megakernel scene.
meta: "ls_kind", "n_lights", "scene_radius", "inf_indices", "light_tags",
"n_tris", "bxdf_tags" (the material pool's tag set); "bvh8" (n_nodes,
n_tris, depth) on the BVH route; "tlas_root" for an instanced scene;
"mega" (the
MegaMeta fields as a dict, or None); "width", "height", "screen_min",
"screen_max", "has_lens", "seed", "spp", "log2_spp", "n_base4_digits".
"""
from __future__ import annotations

import numpy as np
import torch

from . import cameras as cam_mod
from . import device as dev_mod
from . import lightsamplers as lsamp
from . import samplers as smp
from .ops import bvh as bvh_mod
from .ops import tlas as tlas_mod
from .ops.bvh8 import BVH8
from .ops.megawave import MegaMeta
from .scene_core import Scene


def from_jax_scene(arrays: dict, meta: dict, device="cuda"):
    device = dev_mod.resolve(device)

    def t(name, dtype=np.float32):
        if name not in arrays:
            return None
        return torch.as_tensor(np.array(arrays[name], dtype), device=device)

    bvh8 = None
    if "nodes_f" in arrays:
        n_nodes, n_tris, depth = meta["bvh8"]
        bvh8 = BVH8(nodes_f=t("nodes_f"), nodes_q=t("nodes_q", np.int32),
                    tris=t("tris_b8"),
                    prim_indices=t("prim_indices", np.int32),
                    n_nodes=int(n_nodes), n_tris=int(n_tris),
                    depth=int(depth))
    extra = {}
    if "tlas_nodes" in arrays:
        root = int(meta["tlas_root"])
        extra = dict(tlas_nodes=t("tlas_nodes"), inst_rows=t("inst_rows"),
                     tri_geo_tlas=t("tri_geo_tlas"), tlas_root=root,
                     tlas_depth=tlas_mod.stack_depth(
                         arrays["tlas_nodes"], arrays["inst_rows"], root),
                     has_instances=True)
    if "curve_nodes" in arrays:
        extra.update(
            curve_nodes=t("curve_nodes"), curve_segs=t("curve_segs"),
            curve_mats=t("curve_mats", np.int64),
            curve_depth=bvh_mod.bvh_max_depth(arrays["curve_nodes"]),
            has_curves=True)
    if "blp_rows" in arrays:
        extra.update(blp_rows=t("blp_rows"), has_blps=True)
    kind = int(meta["ls_kind"])
    ls = lsamp.LightSampler(
        kind=kind, n_lights=int(meta["n_lights"]),
        rows=(np.asarray(arrays["ls_rows"], np.float32)
              if kind == lsamp.LS_POWER else None),
        pmf_table=np.asarray(arrays["ls_pmf"], np.float32))
    mega = meta.get("mega")
    scene = Scene(
        tri_all=t("tri_all"), tri_pallas=t("tri_pallas"), bvh8=bvh8,
        mat_pool=t("mat_pool"), lights_packed=t("lights_packed"),
        alias_rows=t("ls_rows") if kind == lsamp.LS_POWER else None,
        spectra_pool=t("spectra_pool"), light_sampler=ls,
        scene_radius=float(np.float32(meta["scene_radius"])),
        inf_indices=tuple(int(i) for i in meta["inf_indices"]),
        light_tags=tuple(int(i) for i in meta["light_tags"]),
        n_tris=int(meta["n_tris"]),
        bxdf_tags=tuple(int(i) for i in meta["bxdf_tags"]),
        attr=t("attr"), light=t("light"),
        mat=t("mat"), mega=MegaMeta(**mega) if mega is not None else None,
        **extra)
    camera = cam_mod.Camera(
        kind=cam_mod.CAMERA_PERSPECTIVE,
        c2w_m=np.asarray(arrays["c2w_m"], np.float32),
        width=int(meta["width"]), height=int(meta["height"]),
        tan_half_fov=np.float32(arrays["tan_half_fov"]),
        screen_min=tuple(meta["screen_min"]),
        screen_max=tuple(meta["screen_max"]),
        has_lens=bool(meta["has_lens"]))
    sampler = smp.SamplerParams(
        kind=smp.SAMPLER_ZSOBOL, spp=int(meta["spp"]), seed=int(meta["seed"]),
        log2_spp=int(meta["log2_spp"]),
        n_base4_digits=int(meta["n_base4_digits"]))
    return scene, camera, sampler
