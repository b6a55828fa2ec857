"""Built-in scenes (counterpart of pbrt_tpu/scenes.py): the Cornell box of
the main path, with the reference's geometry, materials and camera."""
from __future__ import annotations

import numpy as np

from . import cameras as cam_mod
from . import scene_core as sc
from .utils import color as pcolor
from .utils import transform as tfm


def _quad(builder, corners, material, **kw):
    """Add a quad as two triangles. corners: 4x3 CCW."""
    v = np.asarray(corners, np.float32)
    return builder.add_mesh(v, [[0, 1, 2], [0, 2, 3]], material, **kw)


def make_cornell_box(width=400, height=400, light_scale=1.0,
                     device="cuda"):
    """The Cornell box (original Cornell measurement data, mm, y up, the
    camera looking down +z). Returns (scene, camera)."""
    b = sc.SceneBuilder()
    white = b.materials.add_diffuse((0.725, 0.71, 0.68))
    red = b.materials.add_diffuse((0.63, 0.065, 0.05))
    green = b.materials.add_diffuse((0.14, 0.45, 0.091))

    _quad(b, [(552.8, 0, 0), (0, 0, 0), (0, 0, 559.2), (549.6, 0, 559.2)],
          white)                                                   # floor
    _quad(b, [(556, 548.8, 0), (556, 548.8, 559.2), (0, 548.8, 559.2),
              (0, 548.8, 0)], white)                               # ceiling
    _quad(b, [(549.6, 0, 559.2), (0, 0, 559.2), (0, 548.8, 559.2),
              (556, 548.8, 559.2)], white)                         # back
    # red wall at x = 0 (image left), green wall at x ~ 556 (image right)
    _quad(b, [(0, 0, 559.2), (0, 0, 0), (0, 548.8, 0), (0, 548.8, 559.2)],
          red)
    _quad(b, [(552.8, 0, 0), (549.6, 0, 559.2), (556, 548.8, 559.2),
              (556, 548.8, 0)], green)
    for top in ([(130, 165, 65), (82, 165, 225), (240, 165, 272),
                 (290, 165, 114)],                                 # short
                [(423, 330, 247), (265, 330, 296), (314, 330, 456),
                 (472, 330, 406)]):                                # tall
        _quad(b, top, white)
        for i in range(4):
            a = top[i]
            c = top[(i + 1) % 4]
            _quad(b, [(a[0], 0, a[2]), (a[0], a[1], a[2]),
                      (c[0], c[1], c[2]), (c[0], 0, c[2])], white)
    # the lamp just below the ceiling, its normal pointing down (-y)
    emit = pcolor.RGBIlluminantSpectrum((17.0, 12.0, 4.0), b.cs)
    _quad(b, [(343, 548.75, 227), (343, 548.75, 332), (213, 548.75, 332),
              (213, 548.75, 227)], white, emission=emit,
          emission_scale=light_scale)

    scene = b.build(light_sampler="power", device=device)
    cam = cam_mod.make_camera(
        "perspective",
        camera_from_world=tfm.look_at((278, 273, -800), (278, 273, 0),
                                      (0, 1, 0)).inverse(),
        width=width, height=height, fov=38.5)
    return scene, cam
