"""Cameras (counterpart of pbrt_tpu/cameras.py): the pinhole perspective
camera of the main path.

A camera is host data (float32 numpy, as the reference stores it); rays are
tensors on the device of the film positions they are generated for.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .utils import transform as tfm

CAMERA_PERSPECTIVE = 0   # the reference's kind code


@dataclasses.dataclass(frozen=True)
class Camera:
    kind: int
    c2w_m: np.ndarray            # (4, 4) float32 camera-to-world
    width: int
    height: int
    tan_half_fov: np.float32
    screen_min: tuple
    screen_max: tuple
    has_lens: bool = False


def make_camera(kind="perspective", camera_from_world: tfm.Transform = None,
                width=640, height=480, fov=90.0, lens_radius=0.0,
                screen_window=None) -> Camera:
    if kind != "perspective":
        raise NotImplementedError(
            f"camera {kind!r}: only perspective is ported (ROADMAP.md, "
            "slice 4: the other cameras)")
    if camera_from_world is None:
        camera_from_world = tfm.identity()
    c2w = camera_from_world.inverse()
    aspect = width / height
    if screen_window is not None:
        smin, smax = tuple(screen_window[0]), tuple(screen_window[1])
    elif aspect > 1:
        smin, smax = (-aspect, -1.0), (aspect, 1.0)
    else:
        smin, smax = (-1.0, -1.0 / aspect), (1.0, 1.0 / aspect)
    return Camera(kind=CAMERA_PERSPECTIVE,
                  c2w_m=np.asarray(c2w.m, np.float32), width=width,
                  height=height,
                  tan_half_fov=np.float32(np.tan(np.radians(fov) / 2)),
                  screen_min=smin, screen_max=smax,
                  has_lens=bool(lens_radius > 0))


def generate_ray(cam: Camera, p_film: torch.Tensor):
    """Pinhole ray through raster position p_film (N, 2) -> (o, d), each
    (N, 3) world space (reference cameras.generate_ray without a lens)."""
    if cam.has_lens:
        raise NotImplementedError(
            "thin-lens camera: not ported (ROADMAP.md, slice 4 item 21, "
            "the other cameras)")
    sx = cam.screen_min[0] + (p_film[..., 0] / cam.width) * \
        (cam.screen_max[0] - cam.screen_min[0])
    sy = cam.screen_max[1] - (p_film[..., 1] / cam.height) * \
        (cam.screen_max[1] - cam.screen_min[1])
    thf = float(cam.tan_half_fov)
    d_cam = torch.stack([sx * thf, sy * thf, torch.ones_like(sx)], dim=-1)
    m = torch.as_tensor(cam.c2w_m, device=p_film.device)
    o = m[:3, 3].expand(d_cam.shape)
    d = d_cam @ m[:3, :3].T
    length = torch.sqrt(torch.sum(d * d, dim=-1))
    return o, d / torch.clamp(length, min=1e-20)[..., None]


def generate_ray_weighted(cam: Camera, p_film: torch.Tensor):
    """generate_ray and the camera weight (reference
    generate_ray_weighted; 1 for every pinhole ray). Returns (o, d,
    weight (N,))."""
    o, d = generate_ray(cam, p_film)
    return o, d, torch.ones_like(p_film[..., 0])


def pixel_cone_spread(cam: Camera) -> float:
    """The angular width of one pixel's ray cone (reference
    pixel_cone_spread), which the path integrator carries to pick texture
    MIP levels (the reference's stand-in for ray differentials), float32
    arithmetic in the reference's order."""
    f32 = np.float32
    spread = f32(2.0) * f32(cam.tan_half_fov) * \
        f32(cam.screen_max[0] - cam.screen_min[0])
    return float(spread / f32(2.0) / f32(cam.width))
