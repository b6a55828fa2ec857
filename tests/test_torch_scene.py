"""Port vs reference: the cornell scene build (packed tables, megakernel
metadata), camera rays, filter sampling, the state conversion from the
JAX package, and the megakernel eligibility refusals."""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from pbrt_tpu import cameras as jcam  # noqa: E402
from pbrt_tpu import filters as jflt  # noqa: E402
from pbrt_tpu_torch import cameras as cam_mod  # noqa: E402
from pbrt_tpu_torch import convert  # noqa: E402
from pbrt_tpu_torch import filters as flt  # noqa: E402
from pbrt_tpu_torch import samplers as smp  # noqa: E402
from pbrt_tpu_torch import scene_core as sc  # noqa: E402
from pbrt_tpu_torch import scenes  # noqa: E402
from pbrt_tpu_torch.integrators import path as path_mod  # noqa: E402
from pbrt_tpu_torch.ops import megawave  # noqa: E402
from pbrt_tpu_torch.utils import transform as tfm  # noqa: E402

from _jax_export import export_cornell  # noqa: E402

torch.set_num_threads(1)
W = H = 16


@pytest.fixture(scope="module")
def ref():
    return export_cornell(W, H, spp=4)


@pytest.fixture(scope="module")
def port():
    return scenes.make_cornell_box(W, H, device="cpu")


def test_cornell_tables_match(ref, port):
    _s, _c, _smp, arrays, meta = ref
    scene, _cam = port
    np.testing.assert_array_equal(scene.tri_pallas.numpy(),
                                  arrays["tri_pallas"])
    attr, light, mat = megawave.scene_tables(scene)
    for name, got in (("attr", attr), ("light", light), ("mat", mat),
                      ("spectra_pool", scene.spectra_pool),
                      ("lights_packed", scene.lights_packed)):
        np.testing.assert_allclose(got.numpy(), arrays[name], rtol=1e-6,
                                   atol=0, err_msg=name)
    assert scene.mega._asdict() == meta["mega"]
    assert scene.mega.n_tris == 32 and scene.mega.n_lights == 2


def test_camera_rays_match(ref, port):
    _s, jc, _smp, arrays, meta = ref
    _scene, cam = port
    np.testing.assert_allclose(cam.c2w_m, arrays["c2w_m"], rtol=1e-6)
    assert cam.tan_half_fov == arrays["tan_half_fov"]
    assert (cam.screen_min, cam.screen_max) == \
        (meta["screen_min"], meta["screen_max"])
    rs = np.random.RandomState(5)
    p_film = (rs.uniform(0, 1, (256, 2)) * [W, H]).astype(np.float32)
    o_j, d_j, _t = jcam.generate_ray(jc, jnp.asarray(p_film),
                                     jnp.zeros((256, 2)), jnp.zeros((256,)))
    o_t, d_t = cam_mod.generate_ray(cam, torch.as_tensor(p_film))
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), rtol=1e-6)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-5,
                               atol=1e-6)


def test_gaussian_filter_sample_matches():
    """The port samples with the megakernel's float32 constants; the
    reference's filters.sample folds the same numbers differently, so
    agreement is to float32 rounding."""
    rs = np.random.RandomState(6)
    u = rs.uniform(0, 1, (4096, 2)).astype(np.float32)
    p_j, w_j = jflt.sample(jflt.make_filter("gaussian"), jnp.asarray(u))
    p_t, w_t = flt.sample(flt.make_filter("gaussian"), torch.as_tensor(u))
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-5,
                               atol=1e-6)


def test_convert_round_trips_jax_state(ref):
    _s, _c, jsampler, arrays, meta = ref
    scene, cam, sampler = convert.from_jax_scene(arrays, meta, device="cpu")
    for name in ("tri_pallas", "attr", "light", "mat", "spectra_pool",
                 "lights_packed"):
        np.testing.assert_array_equal(getattr(scene, name).numpy(),
                                      arrays[name], err_msg=name)
    np.testing.assert_array_equal(cam.c2w_m, arrays["c2w_m"])
    assert cam.tan_half_fov == arrays["tan_half_fov"]
    assert (cam.width, cam.height) == (W, H)
    assert scene.mega._asdict() == meta["mega"]
    assert (sampler.seed, sampler.log2_spp, sampler.n_base4_digits) == \
        (jsampler.seed, jsampler.log2_spp, jsampler.n_base4_digits)
    assert megawave.eligible_full(scene, sampler, cam,
                                  flt.make_filter("gaussian"))


def test_eligibility_refuses_box_filter_and_lens_camera(port):
    scene, cam = port
    sampler = smp.make_sampler("zsobol", spp=4, full_resolution=(W, H))
    gauss, box = flt.make_filter("gaussian"), flt.make_filter("box")
    lens_cam = cam_mod.make_camera(
        "perspective", camera_from_world=tfm.look_at(
            (278, 273, -800), (278, 273, 0), (0, 1, 0)).inverse(),
        width=W, height=H, fov=38.5, lens_radius=0.1)
    assert megawave.eligible_full(scene, sampler, cam, gauss)
    assert not megawave.eligible_full(scene, sampler, cam, box)
    assert not megawave.eligible_full(scene, sampler, lens_cam, gauss)
    pix = torch.arange(W * H)
    si = torch.zeros(W * H, dtype=torch.int64)
    for c, f in ((cam, box), (lens_cam, gauss)):
        with pytest.raises(NotImplementedError):
            path_mod.render_wave(scene, c, sampler, f, pix, si,
                                 path_mod.PathOptions())


def test_builder_refuses_scenes_outside_the_closed_world():
    """Scenes outside the megakernel's closed world build for the general
    wave (no megakernel metadata); what is not ported at all raises."""
    from pbrt_tpu_torch.utils import color as pcolor
    quad = np.asarray([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]],
                      np.float32)
    b = sc.SceneBuilder()
    m = b.materials.add_diffuse((0.5, 0.5, 0.5))
    b.add_mesh(quad, [[0, 1, 2], [0, 2, 3]], m)
    no_light = b.build(device="cpu")
    assert no_light.mega is None and no_light.light_tags == ()
    b.add_mesh(quad, [[0, 1, 2]], m,
               emission=pcolor.RGBIlluminantSpectrum((1.0, 1.0, 1.0)))
    # the bvh light sampler builds, outside the megakernel; with an
    # infinite light it raises (the reference renders no such scene)
    bvh = b.build(light_sampler="bvh", device="cpu")
    assert bvh.mega is None and bvh.light_sampler.kind == 2
    b_inf = sc.SceneBuilder()
    b_inf.add_mesh(quad, [[0, 1, 2]], b_inf.materials.add_diffuse(),
                   emission=pcolor.RGBIlluminantSpectrum((1.0, 1.0, 1.0)))
    b_inf.add_uniform_infinite_light(pcolor.RGBIlluminantSpectrum((1, 1, 1)))
    with pytest.raises(NotImplementedError, match="light sampler"):
        b_inf.build(light_sampler="bvh", device="cpu")
    assert b.build(device="cpu").mega.n_tris == 3
    assert b.build(force_bvh=True, device="cpu").mega is None
    for _ in range(31):
        b.add_mesh(quad, [[0, 1, 2], [0, 2, 3]], m)
    big = b.build(device="cpu")
    assert big.mega is None and big.n_tris == 65 and not big.use_bvh
