"""The furnace scenes, whose images are known analytically
(pbrt_tpu_torch.scenes.make_furnace_plane, make_furnace_sphere,
make_sphere_mesh): scene tables bit-equal to the reference's, and the
renders at the reference suite's gates (tests/test_render.py): the plane's
mean luminance equals its albedo within 0.025, the white furnace's equals
the environment's radiance within 0.03 (finite depth and roulette
variance). The port renders them with its zsobol sampler through the plain
versions on the CPU."""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from pbrt_tpu import scenes as jscenes  # noqa: E402
from pbrt_tpu_torch import scenes  # noqa: E402
from pbrt_tpu_torch.integrators import render  # noqa: E402
from pbrt_tpu_torch.integrators.path import PathOptions  # noqa: E402
from pbrt_tpu_torch.ops import bvh8  # noqa: E402
from pbrt_tpu_torch.ops import tri_intersect as ti  # noqa: E402

torch.set_num_threads(1)


def _luminance(img):
    mean = img.mean(axis=(0, 1))
    return 0.2126 * mean[0] + 0.7152 * mean[1] + 0.0722 * mean[2]


def _same(a, b, name):
    a, b = np.asarray(a), b.numpy()
    assert a.shape == b.shape, name
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8),
                                  err_msg=name)


def _compare(sj, cj, sp, cp):
    _same(sj.tri_all, sp.tri_all, "tri_all")
    _same(sj.materials.packed, sp.mat_pool, "mat_pool")
    _same(sj.lights.packed, sp.lights_packed, "lights_packed")
    _same(sj.spectra_pool, sp.spectra_pool, "spectra_pool")
    assert sp.scene_radius == float(sj.scene_radius)
    assert sp.mega is None and sj.mega is None
    np.testing.assert_array_equal(np.asarray(cj.c2w_m), cp.c2w_m)
    assert float(cj.tan_half_fov) == float(cp.tan_half_fov)


@pytest.mark.parametrize("center", [(0.0, 0.0, 0.0),
                                    (2000.0, -500.0, 1500.0)],
                         ids=["origin", "large-coordinates"])
def test_furnace_plane_tables_match_reference(center):
    sj, cj = jscenes.make_furnace_plane(albedo=0.6, width=48, height=48,
                                        center=center)
    sp, cp = scenes.make_furnace_plane(albedo=0.6, width=48, height=48,
                                       center=center, device="cpu")
    _compare(sj, cj, sp, cp)
    _same(sj.tri_pallas, sp.tri_pallas, "tri_pallas")
    assert sp.n_tris == 2 and not sp.use_bvh


def test_furnace_sphere_tables_match_reference():
    sj, cj = jscenes.make_furnace_sphere(width=32, height=32, subdiv=2)
    sp, cp = scenes.make_furnace_sphere(width=32, height=32, subdiv=2,
                                        device="cpu")
    _compare(sj, cj, sp, cp)
    assert sp.n_tris == 320 and sp.use_bvh


@pytest.mark.parametrize("subdiv", [0, 3])
def test_sphere_mesh_matches_reference(subdiv):
    want = jscenes.make_sphere_mesh((1.0, -2.0, 0.5), 1.5, subdiv)
    got = scenes.make_sphere_mesh((1.0, -2.0, 0.5), 1.5, subdiv)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got[1].shape == (20 * 4 ** subdiv, 3)


@pytest.mark.parametrize("center", [(0.0, 0.0, 0.0),
                                    (2000.0, -500.0, 1500.0)],
                         ids=["origin", "large-coordinates"])
def test_furnace_plane_mean_is_the_albedo(center):
    """One bounce to a uniform environment: L = albedo * L_env, through
    the camera, the triangle query, NEE with MIS against the environment
    and the BSDF sample; at |p| ~ 10^3 also through the error-bound ray
    offsets."""
    scene, cam = scenes.make_furnace_plane(albedo=0.6, env_radiance=1.0,
                                           width=48, height=48,
                                           center=center, device="cpu")
    before = ti.counter.plain
    img, _stats = render.render(scene, cam, spp=32, device="cpu",
                                opts=PathOptions(max_depth=3))
    assert ti.counter.plain > before
    lum = _luminance(img)
    assert abs(lum - 0.6) < 0.025, f"lum={lum}"


def test_white_furnace_is_the_environment():
    """An albedo-1 sphere in a uniform environment: every pixel's
    expectation is the environment's radiance (energy conservation through
    many bounces and roulette)."""
    scene, cam = scenes.make_furnace_sphere(albedo=1.0, env_radiance=1.0,
                                            width=32, height=32, subdiv=2,
                                            device="cpu")
    before = bvh8.counter.plain
    img, _stats = render.render(scene, cam, spp=64, device="cpu",
                                opts=PathOptions(max_depth=40))
    assert bvh8.counter.plain > before
    lum = _luminance(img)
    assert abs(lum - 1.0) < 0.03, f"lum={lum}"
    on_sphere = img[12:20, 12:20]
    assert abs(_luminance(on_sphere) - 1.0) < 0.05
