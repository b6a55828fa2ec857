"""Built-in scenes (counterpart of pbrt_tpu/scenes.py), with the
reference's geometry, materials and cameras: the Cornell box of the main
path, a box lit under the uniform light sampler, the material showcase
(three exact spheres under an environment map), a homogeneous medium
inside an interface shell, and the two furnace scenes whose images are
known analytically."""
from __future__ import annotations

import numpy as np
import torch

from . import cameras as cam_mod
from . import scene_core as sc
from .utils import color as pcolor
from .utils import spectrum as spc
from .utils import transform as tfm
from .utils import vecmath as vm


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


def make_uniform_light_box(device="cuda"):
    """A floor, a back wall and two lamps under the uniform light sampler
    (the megakernel's other light-pick branch), in the Cornell box's frame:
    make_cornell_box's camera sees it. Returns the scene."""
    b = sc.SceneBuilder()
    m = b.materials.add_diffuse((0.6, 0.5, 0.4))
    quad = [[0, 1, 2], [0, 2, 3]]
    b.add_mesh([(556, 0, 0), (0, 0, 0), (0, 0, 560), (556, 0, 560)], quad, m)
    b.add_mesh([(556, 0, 560), (0, 0, 560), (0, 549, 560), (556, 549, 560)],
               quad, m)
    lamp = pcolor.RGBIlluminantSpectrum((8.0, 8.0, 8.0))
    for x0 in (100, 350):
        # wound so the emitting side faces down
        b.add_mesh([(x0, 500, 200), (x0 + 100, 500, 200),
                    (x0 + 100, 500, 330), (x0, 500, 330)], quad, m,
                   emission=lamp)
    return b.build(light_sampler="uniform", device=device)


def make_furnace_plane(albedo=0.5, env_radiance=1.0, width=64, height=64,
                       center=(0.0, 0.0, 0.0), device="cuda"):
    """A large diffuse quad under a uniform environment, seen from straight
    above: every pixel is albedo * env_radiance (one bounce; the reflected
    rays escape to the environment). `center` moves plane and camera
    together: hit points at |p| ~ 10^3 exercise the error-bound ray
    offsets."""
    b = sc.SceneBuilder()
    m = b.materials.add_diffuse((albedo, albedo, albedo))
    s = 1000.0
    cx, cy, cz = center
    _quad(b, [(cx - s, cy, cz - s), (cx + s, cy, cz - s),
              (cx + s, cy, cz + s), (cx - s, cy, cz + s)], m)
    b.add_uniform_infinite_light(spc.ConstantSpectrum(env_radiance))
    scene = b.build(light_sampler="uniform", force_bvh=False, device=device)
    cam = cam_mod.make_camera(
        "perspective",
        camera_from_world=tfm.look_at(
            (cx, cy + 10, cz), (cx, cy, cz + 0.0001), (0, 0, 1)).inverse(),
        width=width, height=height, fov=30.0)
    return scene, cam


def make_sphere_mesh(center, radius, subdiv=3):
    """Icosphere triangle mesh on the host: (vertices (V, 3) float32, faces
    (F, 3) int64, unit normals (V, 3) float32)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]], np.int64)
    for _ in range(subdiv):
        vlist = list(verts)
        cache = {}

        def midpoint(i, j):
            key = (min(i, j), max(i, j))
            if key not in cache:
                m = vlist[i] + vlist[j]
                m /= np.linalg.norm(m)
                cache[key] = len(vlist)
                vlist.append(m)
            return cache[key]
        split = []
        for a, b_, c in faces:
            ab, bc, ca = midpoint(a, b_), midpoint(b_, c), midpoint(c, a)
            split += [[a, ab, ca], [ab, b_, bc], [ca, bc, c], [ab, bc, ca]]
        verts = np.asarray(vlist)
        faces = np.asarray(split, np.int64)
    normals = verts.copy()
    verts = verts * radius + np.asarray(center, np.float64)
    return verts.astype(np.float32), faces, normals.astype(np.float32)


def _showcase_sky(res=64):
    """The showcase's equal-area sky: a gradient brightening upwards and a
    sun disk (reference make_material_showcase's default env_image)."""
    u, v = np.meshgrid((np.arange(res) + 0.5) / res,
                       (np.arange(res) + 0.5) / res, indexing="xy")
    d = vm.equal_area_square_to_sphere(torch.as_tensor(
        np.stack([u, v], -1).reshape(-1, 2), dtype=torch.float32)).numpy()
    z = d[:, 2].reshape(res, res)
    sky = np.stack([0.4 + 0.3 * np.maximum(z, 0),
                    0.5 + 0.4 * np.maximum(z, 0),
                    0.8 + 0.8 * np.maximum(z, 0)], -1).astype(np.float32)
    sun_dir = np.asarray([0.4, 0.8, 0.3])
    sun_dir = sun_dir / np.linalg.norm(sun_dir)
    cosd = (d @ sun_dir).reshape(res, res)
    return sky + (cosd > 0.995)[..., None] * np.asarray([400.0, 380.0, 320.0])


def make_material_showcase(width=400, height=300, env_image=None,
                           device="cuda"):
    """Gold, glass and copper exact spheres (add_sphere) on a diffuse floor
    under an environment map (reference make_material_showcase): the
    API-built quadric scene. Returns (scene, camera)."""
    b = sc.SceneBuilder()
    floor = b.materials.add_diffuse((0.4, 0.4, 0.4))
    named = {k: b.add_spectrum(spc.get_named_spectrum(f"metal-{k}"),
                               key=k.lower())
             for k in ("Au-eta", "Au-k", "Cu-eta", "Cu-k")}
    gold = b.materials.add_conductor(eta_spec_idx=named["Au-eta"],
                                     k_spec_idx=named["Au-k"], roughness=0.1)
    copper = b.materials.add_conductor(eta_spec_idx=named["Cu-eta"],
                                       k_spec_idx=named["Cu-k"],
                                       roughness=0.005)
    glass = b.materials.add_dielectric(eta=1.5, roughness=0.0)
    _quad(b, [(-8, 0, -8), (8, 0, -8), (8, 0, 8), (-8, 0, 8)], floor,
          uvs=[[0, 0], [8, 0], [8, 8], [0, 8]])
    for cx, cz, mat in ((-2.2, 0.0, gold), (0.0, 0.0, glass),
                        (2.2, 0.0, copper)):
        b.add_sphere((cx, 1.0, cz), 1.0, mat)
    b.add_image_infinite_light(_showcase_sky() if env_image is None
                               else env_image)
    scene = b.build(light_sampler="power", force_bvh=True, device=device)
    cam = cam_mod.make_camera(
        "perspective",
        camera_from_world=tfm.look_at((0, 2.2, -7.5), (0, 1.0, 0),
                                      (0, 1, 0)).inverse(),
        width=width, height=height, fov=32.0)
    return scene, cam


def make_furnace_sphere(albedo=1.0, env_radiance=1.0, width=64, height=64,
                        subdiv=3, device="cuda", force_bvh=True):
    """The white furnace: a unit diffuse sphere under a uniform
    environment. With albedo 1 and enough bounces every pixel, on the
    sphere or not, equals env_radiance. force_bvh: the triangle route
    (SceneBuilder.build; True, the BVH8 kernel, is the reference's choice
    here; None leaves the 1,280 triangles of subdiv 3 to the brute-force
    kernel)."""
    b = sc.SceneBuilder()
    m = b.materials.add_diffuse((albedo, albedo, albedo))
    v, f, n = make_sphere_mesh((0, 0, 0), 1.0, subdiv)
    b.add_mesh(v, f, m, normals=n)
    b.add_uniform_infinite_light(spc.ConstantSpectrum(env_radiance))
    scene = b.build(light_sampler="uniform", force_bvh=force_bvh,
                    device=device)
    cam = cam_mod.make_camera(
        "perspective",
        camera_from_world=tfm.look_at((0, 0, -4), (0, 0, 0),
                                      (0, 1, 0)).inverse(),
        width=width, height=height, fov=40.0)
    return scene, cam


def make_medium_shell(width=200, height=200, device="cuda"):
    """A homogeneous medium bounded by an icosphere of 320 null-material
    interface triangles (above 256, so its crossings go through the
    interface BVH and the single-level bvh2 kernel) over a diffuse floor,
    lit by an area lamp. Returns (scene, camera); render picks the
    volumetric integrator."""
    b = sc.SceneBuilder()
    m = b.materials.add_diffuse((0.6, 0.55, 0.5))
    quad = [[0, 1, 2], [0, 2, 3]]
    b.add_mesh(np.asarray([[-4, -0.3, -4], [4, -0.3, -4], [4, -0.3, 4],
                           [-4, -0.3, 4]], np.float32), quad, m)
    b.add_mesh(np.asarray([[-0.6, 2.5, -0.6], [0.6, 2.5, -0.6],
                           [0.6, 2.5, 0.6], [-0.6, 2.5, 0.6]], np.float32),
               quad, m, emission=pcolor.RGBIlluminantSpectrum((9, 8, 7),
                                                              b.cs))
    med = b.media.add_homogeneous(sigma_a=(0.3, 0.2, 0.1),
                                  sigma_s=(1.2, 1.5, 1.8), g=0.4,
                                  bounds_lo=(-1.05, -0.25, -1.05),
                                  bounds_hi=(1.05, 1.85, 1.05))
    verts, faces, _n = make_sphere_mesh((0.0, 0.8, 0.0), 1.0, 2)
    b.add_interface_mesh(verts, faces, med_in=med, med_out=-1)
    cam = cam_mod.make_camera(
        "perspective", camera_from_world=tfm.look_at(
            (0, 1.2, 4.5), (0, 0.8, 0), (0, 1, 0)).inverse(),
        width=width, height=height, fov=40.0)
    return b.build(device=device), cam
