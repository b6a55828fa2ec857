"""State carried across from the JAX package.

`from_jax_scene` takes the fields of a pbrt_tpu Scene, Camera and
SamplerParams, exported to numpy by the caller (this package imports no
jax), and returns the port's (Scene, Camera, SamplerParams) on a device, so
both packages can compute on the same scene.

arrays: "tri_all" (T, 27); "mat_pool" (M, 22); "lights_packed" (L, 24);
"spectra_pool" (S, 471); "ls_rows" (L, 4) and "ls_pmf" (L,), the light
sampler's alias rows and pmf table (uniform and power samplers);
"ls_nodes", "ls_bit_trail", "ls_trail_len", "ls_outside",
"ls_pmf_outside" (the light BVH's tables) or "ls_cols", "ls_is_inf" (the
exhaustive sampler's); "tex_desc", "tex_atlas", "tex_mips" (the texture
pool); "c2w_m" (4, 4); "tan_half_fov" ();
"tri_pallas" (T'*16,) on the brute-force route; "nodes_f", "nodes_q",
"tris_b8", "prim_indices" (the BVH8 tables) on the BVH route;
"tlas_nodes", "inst_rows", "tri_geo_tlas" (the two-level tables; the
kernel's own are derived from them) for an instanced scene;
"curve_nodes", "curve_segs", "curve_mats" (the curve tables; the curve
kernel's own node table is derived from them) for a scene with curves;
"blp_rows" (K, 14) for a scene with bilinear patches; "env_texels",
"env_alias_rows", "env_pmf", "env_illum" (the image infinite light's
tables) for a scene with one; "attr", "light", "mat" (the reference's
megawave.scene_tables) for a megakernel scene.
meta: "ls_kind", "n_lights", "ls" (the light BVH's max_depth and
p_outside, or the exhaustive sampler's p_infinite), "has_textures",
"tex_flags" (has_image, has_mips), "scene_radius", "inf_indices",
"light_tags",
"n_tris", "bxdf_tags" (the material pool's tag set); "env" (scale,
width, height, light_index) with the image light's tables; "bvh8" (n_nodes,
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
from . import lightsampler_bvh as lbvh
from . import lights as lgt
from . import lightsamplers as lsamp
from . import textures as tex_mod
from . import samplers as smp
from .ops import bvh as bvh_mod
from .ops import bvh2 as bvh2_mod
from .ops import curves as curves_mod
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
        extra["tlas_kernel"] = bvh2_mod.kernel_tables(
            extra["inst_rows"], extra["tri_geo_tlas"])
    if "curve_nodes" in arrays:
        curve_nodes = t("curve_nodes")
        extra.update(
            curve_nodes=curve_nodes, curve_segs=t("curve_segs"),
            curve_wide=curves_mod.wide_nodes(curve_nodes),
            curve_mats=t("curve_mats", np.int64),
            curve_depth=bvh_mod.bvh_max_depth(arrays["curve_nodes"]),
            has_curves=True)
    if "blp_rows" in arrays:
        extra.update(blp_rows=t("blp_rows"), has_blps=True)
    if "env_texels" in arrays:
        em = meta["env"]
        extra["env"] = lgt.EnvLight(
            texels=t("env_texels"), alias_rows=t("env_alias_rows"),
            pmf=t("env_pmf"), illum=t("env_illum"),
            scale=float(np.float32(em["scale"])), width=int(em["width"]),
            height=int(em["height"]), light_index=int(em["light_index"]))
    kind, n_lights = int(meta["ls_kind"]), int(meta["n_lights"])
    lm = meta.get("ls", {})
    if kind == lsamp.LS_BVH:
        ls = lbvh.BVHLightSampler(
            nodes=t("ls_nodes"), bit_trail=t("ls_bit_trail", np.int32),
            trail_len=t("ls_trail_len", np.int32),
            outside=t("ls_outside", bool),
            pmf_outside=t("ls_pmf_outside"), n_lights=n_lights,
            max_depth=int(lm["max_depth"]),
            p_outside=float(lm["p_outside"]))
    elif kind == lsamp.LS_EXHAUSTIVE:
        ls = lsamp.ExhaustiveLightSampler(
            cols=t("ls_cols"), is_inf=t("ls_is_inf"), n_lights=n_lights,
            p_infinite=float(lm["p_infinite"]))
    else:
        ls = lsamp.LightSampler(
            kind=kind, n_lights=n_lights,
            rows=(np.asarray(arrays["ls_rows"], np.float32)
                  if kind == lsamp.LS_POWER else None),
            pmf_table=np.asarray(arrays["ls_pmf"], np.float32))
    if "tex_desc" in arrays:
        has_image, has_mips = meta["tex_flags"]
        extra.update(
            textures=tex_mod.TexturePool(
                desc=t("tex_desc"), atlas=t("tex_atlas"), mips=t("tex_mips"),
                has_image=bool(has_image), has_mips=bool(has_mips)),
            has_textures=bool(meta["has_textures"]))
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
