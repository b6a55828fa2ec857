"""State carried across from the JAX package.

`from_jax_scene` takes the fields of a pbrt_tpu Scene, Camera and
SamplerParams, exported to numpy by the caller (this package imports no
jax), and returns the port's (Scene, Camera, SamplerParams) on a device, so
both packages can compute on the same scene.

arrays: "tri_pallas" (T*16,); "attr", "light", "mat" (the reference's
megawave.scene_tables); "spectra_pool" (S, 471); "lights_packed" (L, 24);
"c2w_m" (4, 4); "tan_half_fov" ().
meta: "mega" (the MegaMeta fields as a dict), "width", "height",
"screen_min", "screen_max", "has_lens", "seed", "spp", "log2_spp",
"n_base4_digits".
"""
from __future__ import annotations

import numpy as np
import torch

from . import cameras as cam_mod
from . import device as dev_mod
from . import samplers as smp
from .ops.megawave import MegaMeta
from .scene_core import Scene


def from_jax_scene(arrays: dict, meta: dict, device="cpu"):
    device = dev_mod.resolve(device)

    def t(name):
        return torch.as_tensor(np.array(arrays[name], np.float32),
                               device=device)

    scene = Scene(tri_pallas=t("tri_pallas"), attr=t("attr"),
                  light=t("light"), mat=t("mat"),
                  spectra_pool=t("spectra_pool"),
                  lights_packed=t("lights_packed"),
                  mega=MegaMeta(**meta["mega"]))
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
