"""Port vs reference: the quadrics and the plytex path.

Inputs come from numpy seeds or the scene files and go through the
reference's function and the port's:
- `ops/intersect.ray_sphere`, `ray_disk`, `ray_cylinder` on seeded rays
  (a sphere, an ellipsoid's object space, a disk with an inner radius, a
  partial cylinder): hit flags equal; t, p and phi within rtol 1e-5 where
  both hit. Where float32 cancels (a root next to 0, a grazing ray), the
  lanes outside rtol 1e-5 are held to the float64 root of the same
  quadratic: the port no farther from it than the reference plus 1e-6;
- `scene_core.intersect` with merged quadrics (add_quadric_sphere, add_disk,
  add_cylinder; the material showcase's three add_sphere objects at 32x24;
  the parsed plytex scene): hit and material equal on every lane, t, p,
  ng, uv, dpdu, dpdv within rel 1e-4 of the lane's vector on every lane;
  `intersect_p` equal; the megakernel refuses every quadric scene;
- the sphere light: its light row, power and LightBounds, `sample_li`'s
  cone samples (wi, L, pdf, p_light) and `pdf_li_sphere` at seeded points
  within rtol 1e-5; the general wave on a scene lit by an emissive sphere
  (the cone pdf's MIS at emitter hits) under the quadric-wave gate below;
- the parser: sphere, ellipsoid, emissive partial sphere (tessellated),
  disk and cylinder tables array for array; the reference's refusals;
- the plytex general wave at 16x16, 4 spp, depth 5 (5,122 triangles: the
  BVH8 route, the sphere merged). A shadow ray from a sphere hit starts
  within ulps of the sphere; the reference's jitted program contracts the
  offset origin's multiply-adds (XLA on the CPU always fuses them) where
  the port rounds twice, so the self-hit root flips on some of those
  lanes (run op by op, jax.disable_jit, the reference gives the port's
  value on 13 of the sphere-light scene's 14 outside lanes, and on 19 of
  plytex's 20 within 1e-4). The quadric-wave gate: the lanes whose path
  never hit a quadric within rel 1e-4 on >= 99% and their mean L within
  1e-3; all lanes on >= 97.5% (measured: plytex 98.05%, 19 of the 20
  lanes outside hit the sphere; the sphere-light scene 98.63%); and every
  shadow ray of the wave that starts on a sphere decides its self-hit as
  the float64 roots of its own origin do.
"""
import os
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from pbrt_tpu import lights as jlgt  # noqa: E402
from pbrt_tpu import scene_core as jsc  # noqa: E402
from pbrt_tpu import scenes as jscenes  # noqa: E402
from pbrt_tpu.ops import intersect as jisect  # noqa: E402
from pbrt_tpu.scene import parser as jparser  # noqa: E402
from pbrt_tpu.utils import color as jcolor  # noqa: E402
from pbrt_tpu_torch import lights as lgt  # noqa: E402
from pbrt_tpu_torch import models  # noqa: E402
from pbrt_tpu_torch import scene_core as sc  # noqa: E402
from pbrt_tpu_torch import scenes  # noqa: E402
from pbrt_tpu_torch.integrators import path as path_mod  # noqa: E402
from pbrt_tpu_torch.ops import bvh8  # noqa: E402
from pbrt_tpu_torch.ops import intersect as isect  # noqa: E402
from pbrt_tpu_torch.ops import tri_intersect as ti  # noqa: E402
from pbrt_tpu_torch.scene import parser  # noqa: E402
from pbrt_tpu_torch.utils import color as pcolor  # noqa: E402

from _jax_export import reference_keeps_spectra  # noqa: E402
from test_torch_lightsampler_bvh import _wave  # noqa: E402

torch.set_num_threads(1)
SCENES = Path(__file__).resolve().parent.parent / "scenes"
N = 4096


def _unit(v):
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _rays(seed, n=N, lo=-3.0, hi=3.0, spread=1.0):
    """Seeded origins in a box and unit directions, some aimed near the
    origin (so the quadrics are hit and grazed)."""
    rs = np.random.default_rng(seed)
    o = rs.uniform(lo, hi, (n, 3)).astype(np.float32)
    target = rs.normal(0, spread, (n, 3))
    d = _unit(np.where(rs.uniform(size=(n, 1)) < 0.7, target - o,
                       rs.normal(size=(n, 3))))
    return o, d


def _f64_roots(a, b, c):
    """The float64 roots of a t^2 + b t + c per lane (nan without)."""
    disc = b * b - 4 * a * c
    s = np.sqrt(np.maximum(disc, 0))
    r0, r1 = (-b - s) / (2 * a), (-b + s) / (2 * a)
    return np.where(disc >= 0, r0, np.nan), np.where(disc >= 0, r1, np.nan)


QUADRIC_CASES = {
    # name: (port call, reference call, float64 quadratic of (o, d) or
    # None for the disk's linear test)
    "sphere": (lambda o, d, t: isect.ray_sphere(o, d, t, torch.tensor(1.3)),
               lambda o, d, t: jisect.ray_sphere(o, d, t, jnp.float32(1.3)),
               lambda o, d: (np.sum(d * d, -1), 2 * np.sum(o * d, -1),
                             np.sum(o * o, -1) - 1.3 ** 2)),
    "ellipsoid": (
        lambda o, d, t: isect.ray_sphere(o * torch.tensor([1.0, 0.5, 2.0]),
                                         d * torch.tensor([1.0, 0.5, 2.0]),
                                         t, torch.tensor(1.0)),
        lambda o, d, t: jisect.ray_sphere(o * jnp.asarray([1.0, 0.5, 2.0]),
                                          d * jnp.asarray([1.0, 0.5, 2.0]),
                                          t, jnp.float32(1.0)),
        None),
    "disk": (lambda o, d, t: isect.ray_disk(o, d, t, torch.tensor(1.5),
                                            height=torch.tensor(0.25),
                                            inner_radius=torch.tensor(0.5),
                                            phi_max=torch.tensor(5.0)),
             lambda o, d, t: jisect.ray_disk(o, d, t, jnp.float32(1.5),
                                             height=jnp.float32(0.25),
                                             inner_radius=jnp.float32(0.5),
                                             phi_max=jnp.float32(5.0)),
             None),
    "partial cylinder": (
        lambda o, d, t: isect.ray_cylinder(o, d, t, torch.tensor(0.9),
                                           torch.tensor(-0.5),
                                           torch.tensor(1.2),
                                           phi_max=torch.tensor(4.0)),
        lambda o, d, t: jisect.ray_cylinder(o, d, t, jnp.float32(0.9),
                                            jnp.float32(-0.5),
                                            jnp.float32(1.2),
                                            phi_max=jnp.float32(4.0)),
        lambda o, d: (d[:, 0] ** 2 + d[:, 1] ** 2,
                      2 * (o[:, 0] * d[:, 0] + o[:, 1] * d[:, 1]),
                      o[:, 0] ** 2 + o[:, 1] ** 2 - 0.9 ** 2)),
}


@pytest.mark.parametrize("name", list(QUADRIC_CASES))
def test_ray_quadric_matches_reference(name):
    port, ref, quad = QUADRIC_CASES[name]
    o, d = _rays(11 + len(name))
    t_max = np.random.default_rng(3).uniform(2.0, 8.0, N).astype(np.float32)
    rp = port(torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(t_max))
    rj = ref(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max))
    hit = rp["hit"].numpy()
    np.testing.assert_array_equal(hit, np.asarray(rj["hit"]))
    assert 0.1 < hit.mean() < 0.9, hit.mean()
    t_p, t_j = rp["t"].numpy()[hit], np.asarray(rj["t"])[hit]
    rel_t = np.abs(t_p - t_j) / np.maximum(np.abs(t_j), 1e-6)
    for k in ("p", "phi"):
        a, b = rp[k].numpy()[hit], np.asarray(rj[k])[hit]
        rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-3)
        assert (rel.reshape(len(a), -1).max(-1)[rel_t < 1e-5] < 1e-5).all(), k
    off = np.nonzero(rel_t >= 1e-5)[0]
    print(f"{name}: {hit.mean():.3f} hit, {len(off)} of {hit.sum()} hit "
          "lanes outside rtol 1e-5 in t")
    if quad is None:
        assert len(off) == 0
        return
    # the cancelling lanes: each package's t against the float64 root of
    # the same quadratic (the nearer of the two to the reference's)
    a, b, c = quad(o.astype(np.float64)[hit], d.astype(np.float64)[hit])
    r0, r1 = _f64_roots(a, b, c)
    exact = np.where(np.abs(r0 - t_j) < np.abs(r1 - t_j), r0, r1)
    err_p = np.abs(t_p - exact)[off]
    err_j = np.abs(t_j - exact)[off]
    assert (err_p <= err_j + 1e-6).all(), (err_p, err_j)


def _quadric_builders():
    """A floor under an ellipsoid, an annulus with a cut and a partial
    cylinder, built by both packages."""
    def build(mod, device=None):
        b = mod.SceneBuilder()
        m0 = b.materials.add_diffuse((0.5, 0.5, 0.5))
        m1 = b.materials.add_diffuse((0.8, 0.2, 0.1))
        b.add_mesh(np.asarray([[-6, 0, -6], [6, 0, -6], [6, 0, 6],
                               [-6, 0, 6]], np.float32), [[0, 1, 2],
                                                          [0, 2, 3]], m0)
        rot = np.eye(4)
        c, s = np.cos(0.4), np.sin(0.4)
        rot[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
        ell = rot @ np.diag([1.2, 0.6, 0.9, 1.0])
        ell[:3, 3] = (-1.5, 1.0, 0.3)
        b.add_quadric_sphere(ell, 1.0, m1)
        disk = np.eye(4)
        disk[:3, 3] = (1.6, 0.8, -0.4)
        disk[:3, :3] = [[1, 0, 0], [0, 0, 1], [0, -1, 0]]
        b.add_disk(disk, 1.1, m0, height=0.2, inner_radius=0.4,
                   phi_max=np.deg2rad(300.0))
        cyl = np.eye(4)
        cyl[:3, 3] = (0.3, 0.0, 1.8)
        cyl[:3, :3] = [[1, 0, 0], [0, 0, 1], [0, -1, 0]]
        b.add_cylinder(cyl, 0.7, -1.5, 0.2, m1, phi_max=np.deg2rad(250.0))
        b.add_uniform_infinite_light(
            pcolor.RGBIlluminantSpectrum((1, 1, 1), b.cs) if device
            else jcolor.RGBIlluminantSpectrum((1, 1, 1), b.cs))
        return b.build(device=device) if device else b.build()
    return build(jsc), build(sc, "cpu")


def _hold_records(rp, rj, label, keys=("t", "p", "ng", "uv", "dpdu",
                                       "dpdv")):
    hit = rp["hit"].numpy()
    np.testing.assert_array_equal(hit, np.asarray(rj["hit"]), err_msg=label)
    np.testing.assert_array_equal(rp["mat"].numpy()[hit],
                                  np.asarray(rj["mat"])[hit], err_msg=label)
    np.testing.assert_array_equal(rp["light"].numpy()[hit],
                                  np.asarray(rj["light"])[hit], err_msg=label)
    for k in keys:
        a, b = rp[k].numpy()[hit], np.asarray(rj[k])[hit]
        # relative to the lane's vector (a component that cancels to ~0 is
        # held to its vector's scale)
        scale = np.abs(b).reshape(len(b), -1).max(-1)
        scale = np.maximum(scale, 1e-6).reshape((-1,) + (1,) * (b.ndim - 1))
        rel = np.abs(a - b) / scale
        assert (rel < 1e-4).all(), (label, k, rel.max(), b[rel >= 1e-4])
    return hit


def _intersect_both(sj, sp, o, d, t_max):
    rj = jsc.intersect(sj, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max))
    rp = sc.intersect(sp, torch.as_tensor(o), torch.as_tensor(d),
                      torch.as_tensor(t_max))
    return rp, rj


def test_builder_quadrics_match_reference():
    sj, sp = _quadric_builders()
    np.testing.assert_array_equal(sp.quadrics.numpy(), np.asarray(sj.quadrics))
    assert sp.quadric_tags == sj.quadric_tags == (0, 1, 2)
    assert sp.n_spheres == sj.n_spheres == 1
    assert sp.scene_radius == float(sj.scene_radius)
    assert sp.mega is None and sj.mega is None
    o, d = _rays(5, lo=-4, hi=4)
    o[:, 1] = np.abs(o[:, 1]) + 0.05
    t_max = np.full(N, 1e30, np.float32)
    rp, rj = _intersect_both(sj, sp, o, d, t_max)
    hit = _hold_records(rp, rj, "quadric builder")
    q = rp["prim"].numpy() < 0
    np.testing.assert_array_equal(rp["prim"].numpy()[q],
                                  np.asarray(rj["prim"])[q])
    for k in range(3):
        assert (rp["prim"].numpy() == -(k + 1)).sum() > 20, k
    assert hit.mean() > 0.3
    t_sh = np.random.default_rng(9).uniform(0.5, 4.0, N).astype(np.float32)
    occ_p = sc.intersect_p(sp, torch.as_tensor(o), torch.as_tensor(d),
                           torch.as_tensor(t_sh)).numpy()
    occ_j = np.asarray(jsc.intersect_p(sj, jnp.asarray(o), jnp.asarray(d),
                                       jnp.asarray(t_sh)))
    np.testing.assert_array_equal(occ_p, occ_j)


@pytest.fixture(scope="module")
def showcase():
    return (jscenes.make_material_showcase(width=32, height=24),
            scenes.make_material_showcase(width=32, height=24,
                                          device="cpu"))


def test_material_showcase_matches_reference(showcase):
    (sj, cj), (sp, cp) = showcase
    for what, got, want in (
            ("quadrics", sp.quadrics, sj.quadrics),
            ("triangles", sp.tri_all, sj.tri_all),
            ("material rows", sp.mat_pool, sj.materials.packed),
            ("light rows", sp.lights_packed, sj.lights.packed),
            ("spectra", sp.spectra_pool, sj.spectra_pool),
            ("env texels", sp.env.texels, sj.env.texels),
            ("env alias rows", sp.env.alias_rows, sj.env.alias_rows)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=what)
    assert sp.use_bvh and sp.mega is None and sj.mega is None
    assert sp.n_spheres == 3 and (cp.width, cp.height) == (32, 24)
    assert models.material_showcase is scenes.make_material_showcase
    assert models.cornell_box is scenes.make_cornell_box


def test_intersect_showcase_matches_reference(showcase):
    (sj, _cj), (sp, cp) = showcase
    pix = torch.arange(32 * 24)
    si = torch.zeros_like(pix)
    from pbrt_tpu_torch import samplers as smp
    sampler = smp.make_sampler("zsobol", spp=1, full_resolution=(32, 24))
    px, py, _swl = path_mod.camera_lanes(cp, sampler, pix, si)
    o, d, _fw = path_mod.camera_rays(cp, sampler,
                                     path_mod.flt.make_filter("gaussian"),
                                     px, py, si)
    o, d = o.numpy(), d.numpy()
    ob, db = _rays(21, lo=-3.5, hi=3.5)
    ob[:, 1] = np.abs(ob[:, 1]) + 0.01
    o = np.concatenate([o, ob])
    d = np.concatenate([d, db])
    rp, rj = _intersect_both(sj, sp, o, d, np.full(len(o), 1e30, np.float32))
    _hold_records(rp, rj, "showcase")
    prim = rp["prim"].numpy()
    assert all((prim == -(k + 1)).sum() > 10 for k in range(3))


@pytest.fixture(scope="module")
def plytex():
    with reference_keeps_spectra():
        dj = jparser.parse_file(SCENES / "plytex.pbrt")
    return dj, parser.parse_file(SCENES / "plytex.pbrt", device="cpu")


def test_parse_plytex_matches_reference(plytex):
    dj, dp = plytex
    sj, sp = dj.scene, dp.scene
    assert sp.n_tris == 5122 and sp.use_bvh and sp.mega is None
    assert sp.quadric_tags == (sc.QUADRIC_SPHERE,) and sp.n_spheres == 1
    for what, got, want in (
            ("quadrics", sp.quadrics, sj.quadrics),
            ("triangles", sp.tri_all, sj.tri_all),
            ("material rows", sp.mat_pool, sj.materials.packed),
            ("light rows", sp.lights_packed, sj.lights.packed)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=what)
    np.testing.assert_allclose(sp.quadrics[0, :12].numpy(),
                               [1, 0, 0, -2.1, 0, 1, 0, -0.8, 0, 0, 1, -1.4],
                               rtol=1e-6)
    assert sp.scene_radius == float(sj.scene_radius)


def test_intersect_plytex_matches_reference(plytex):
    dj, dp = plytex
    o, d = _rays(31, lo=-4, hi=4, spread=1.5)
    o[:, 1] = np.abs(o[:, 1]) + 0.02
    o[: N // 4] = (2.1, 0.8, 1.4) + 3.0 * _unit(
        np.random.default_rng(4).normal(size=(N // 4, 3)))
    d[: N // 4] = _unit((2.1, 0.8, 1.4) - o[: N // 4]
                        + np.random.default_rng(6).normal(0, 0.3,
                                                          (N // 4, 3)))
    rp, rj = _intersect_both(dj.scene, dp.scene, o, d,
                             np.full(N, 1e30, np.float32))
    _hold_records(rp, rj, "plytex")
    assert (rp["prim"].numpy() == -1).sum() > 300
    t_sh = np.full(N, 5.0, np.float32)
    occ_p = sc.intersect_p(dp.scene, torch.as_tensor(o), torch.as_tensor(d),
                           torch.as_tensor(t_sh)).numpy()
    occ_j = np.asarray(jsc.intersect_p(dj.scene, jnp.asarray(o),
                                       jnp.asarray(d), jnp.asarray(t_sh)))
    np.testing.assert_array_equal(occ_p, occ_j)


def _sphere_light_scenes(light_sampler="power"):
    def build(mod, cs_mod, device=None):
        b = mod.SceneBuilder()
        m = b.materials.add_diffuse((0.6, 0.6, 0.6))
        b.add_mesh(np.asarray([[-5, 0, -5], [5, 0, -5], [5, 0, 5],
                               [-5, 0, 5]], np.float32), [[0, 1, 2],
                                                          [0, 2, 3]], m)
        emit = cs_mod.RGBIlluminantSpectrum((6.0, 5.0, 4.0), b.cs)
        b.add_sphere((0.5, 1.2, -0.3), 0.45, m, emission=emit,
                     emission_scale=2.0)
        b.add_mesh(np.asarray([[-1, 0.5, 1], [1, 0.5, 1], [0, 1.5, 1]],
                              np.float32), [[0, 1, 2]], m,
                   emission=cs_mod.RGBIlluminantSpectrum((1, 2, 3), b.cs))
        kw = dict(light_sampler=light_sampler)
        return b.build(device=device, **kw) if device else b.build(**kw)
    return build(jsc, jcolor), build(sc, pcolor, "cpu")


def test_sphere_light_matches_reference():
    sj, sp = _sphere_light_scenes()
    np.testing.assert_array_equal(sp.lights_packed.numpy(),
                                  np.asarray(sj.lights.packed))
    np.testing.assert_array_equal(sp.light_sampler.pmf_table,
                                  np.asarray(sj.light_sampler.pmf_table))
    assert sp.light_tags == (lgt.LIGHT_AREA_TRI, lgt.LIGHT_AREA_SPHERE)
    assert sp.has_area_lights and sp.mega is None
    rs = np.random.default_rng(17)
    n = 2048
    p_ref = rs.uniform(-2, 2, (n, 3)).astype(np.float32)
    p_ref[:, 1] = rs.uniform(0.0, 2.5, n)
    p_ref[:64] = (0.5, 1.2, -0.3) + 0.3 * _unit(rs.normal(size=(64, 3)))
    u2 = rs.uniform(size=(n, 2)).astype(np.float32)
    lam = rs.uniform(360, 830, (n, 4)).astype(np.float32)
    li = np.zeros(n, np.int64)    # the sphere is light 0
    got = lgt.sample_li(sp.lights_packed, torch.as_tensor(li),
                        torch.as_tensor(p_ref), torch.as_tensor(u2),
                        torch.as_tensor(lam), sp.spectra_pool,
                        sp.scene_radius, sp.light_tags)
    want = jlgt.sample_li(sj.lights, jnp.asarray(li, jnp.int32),
                          jnp.asarray(p_ref), None, jnp.asarray(u2),
                          jnp.asarray(lam), sj.spectra_pool, sj.tri_geo,
                          sj.scene_radius)
    for k in ("wi", "L", "pdf"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    # the point on the sphere: within 1e-5 of the lane's vector (its
    # distance subtracts a square root from dc cos_t)
    a, b = got["p_light"].numpy(), np.asarray(want["p_light"])
    assert (np.abs(a - b).max(-1) < 1e-5 * np.abs(b).max(-1)).all()
    np.testing.assert_array_equal(got["valid"].numpy(),
                                  np.asarray(want["valid"]))
    assert (got["pdf"].numpy()[:64] == 0).all()     # inside: no sample
    rows = sp.lights_packed[torch.as_tensor(li)]
    pdf = lgt.pdf_li_sphere(rows, torch.as_tensor(p_ref)).numpy()
    from pbrt_tpu.ops.gather import pool_lookup
    jrows = jlgt.LightRow(pool_lookup(sj.lights.packed,
                                      jnp.asarray(li, jnp.int32)))
    np.testing.assert_allclose(pdf, np.asarray(jlgt.pdf_li_sphere(
        jrows, jnp.asarray(p_ref))), rtol=1e-5)
    np.testing.assert_allclose(pdf, got["pdf"].numpy(), rtol=1e-6)


def test_sphere_light_bounds_match_reference():
    sj, sp = _sphere_light_scenes("bvh")
    ls_p, ls_j = sp.light_sampler, sj.light_sampler
    np.testing.assert_array_equal(ls_p.nodes.numpy(), np.asarray(ls_j.nodes))
    np.testing.assert_array_equal(ls_p.bit_trail.numpy(),
                                  np.asarray(ls_j.bit_trail))


def test_sphere_light_wave_matches_reference(monkeypatch):
    """The general wave lit by the sphere light (and a triangle lamp): the
    emitter hits' MIS weighs the sphere by its cone pdf."""
    text = b'''LookAt 0 1.5 5  0 0.8 0  0 1 0
Camera "perspective" "float fov" [45]
Film "rgb" "integer xresolution" [16] "integer yresolution" [16]
Sampler "zsobol" "integer pixelsamples" [4]
WorldBegin
Material "diffuse" "rgb reflectance" [0.6 0.6 0.6]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point3 P" [-5 0 -5  5 0 -5  5 0 5  -5 0 5]
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [6 5 4]
  Translate 0.5 1.2 -0.3
  Shape "sphere" "float radius" [0.45]
AttributeEnd
Material "conductor" "float roughness" [0.3]
AttributeBegin
  Translate -0.9 0.6 0.4
  Scale 1 1.4 1
  Shape "sphere" "float radius" [0.5]
AttributeEnd
'''
    dj = jparser.parse_string(text)
    dp = parser.parse_string(text, device="cpu")
    assert dp.scene.n_spheres == 2 and dp.scene.has_area_lights
    assert dp.scene.lights_packed[0, 0].item() == lgt.LIGHT_AREA_SPHERE
    assert _hold_quadric_wave(dj, dp, 4, ti.counter, "sphere light",
                              monkeypatch) > 20


def test_parse_quadric_shapes_match_reference():
    text = b'''WorldBegin
LightSource "infinite"
Material "diffuse"
AttributeBegin
  Translate 0 1 0
  Scale 2 2 2
  Shape "sphere" "float radius" [0.5]
AttributeEnd
AttributeBegin
  Translate 2 0.5 0
  Scale 1 2 0.5
  Shape "sphere" "float radius" [0.7]
AttributeEnd
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [3 3 3]
  Translate -2 1 0
  Shape "sphere" "float radius" [0.4] "float zmax" [0.2]
AttributeEnd
AttributeBegin
  Rotate 90 1 0 0
  Shape "disk" "float radius" [1.5] "float innerradius" [0.3]
    "float height" [0.1] "float phimax" [270]
AttributeEnd
AttributeBegin
  Translate 0 0 -2
  Shape "cylinder" "float radius" [0.5] "float zmin" [-0.5]
    "float zmax" [1] "float phimax" [200]
AttributeEnd
'''
    with reference_keeps_spectra():
        dj = jparser.parse_string(text)
    dp = parser.parse_string(text, device="cpu")
    sj, sp = dj.scene, dp.scene
    assert sp.quadric_tags == sj.quadric_tags == (0, 0, 1, 2)
    for what, got, want in (
            ("quadrics", sp.quadrics, sj.quadrics),
            ("triangles", sp.tri_all, sj.tri_all),
            ("light rows", sp.lights_packed, sj.lights.packed)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=what)
    # the emissive partial sphere is an icosphere of subdivision 4
    assert sp.n_tris == 20 * 4 ** 4 and sp.light_sampler.n_lights == 1 + \
        20 * 4 ** 4
    # the uniformly scaled full sphere: add_sphere, radius 1
    np.testing.assert_allclose(sp.quadrics[0, [3, 7, 11, 12]].numpy(),
                               [0, -1, 0, 1])


@pytest.mark.parametrize("snippet, msg", [
    (b'Material "diffuse"\nShape "sphere" "float zmin" [0]',
     "partial spheres"),
    (b'AreaLightSource "diffuse"\nShape "disk"', "area lights on disks"),
    (b'AreaLightSource "diffuse"\nShape "cylinder"',
     "area lights on cylinders"),
    (b'ObjectBegin "a"\nShape "sphere"\nObjectEnd', "slice 3 item 10"),
    (b'Material ""\nShape "sphere"', "meshes only"),
])
def test_quadric_refusals(snippet, msg):
    with pytest.raises(parser.ParseError) as err:
        parser.parse_string(b"WorldBegin\n" + snippet + b"\n", device="cpu")
    assert msg in str(err.value), str(err.value)


def test_megakernel_refuses_quadric_scenes():
    text = (SCENES / "cornell.pbrt").read_bytes()
    assert parser.parse_string(text, device="cpu").scene.mega is not None
    with_sphere = text + b'\nMaterial "diffuse"\nShape "sphere"\n'
    dp = parser.parse_string(with_sphere, device="cpu")
    dj = jparser.parse_string(with_sphere)
    assert dp.scene.mega is None and dj.scene.mega is None
    assert dp.scene.quadric_tags == (sc.QUADRIC_SPHERE,)


@pytest.fixture(scope="module")
def small_plytex():
    text = (SCENES / "plytex.pbrt").read_text().replace(
        '"integer xresolution" [200] "integer yresolution" [200]',
        '"integer xresolution" [16] "integer yresolution" [16]').replace(
        '"integer pixelsamples" [64]', '"integer pixelsamples" [4]')
    with reference_keeps_spectra():
        dj = jparser.parse_string(text, base_dir=str(SCENES))
    return dj, parser.parse_string(text, base_dir=str(SCENES), device="cpu")


def _hold_quadric_wave(dj, dp, depth, counter, label, monkeypatch):
    """One 16x16x4 wave through both general waves (test_torch_lightsampler_
    bvh._wave), every closest and shadow query of the port's recorded. The
    gate: the lanes that never hit a quadric within rel 1e-4 on >= 99%,
    their mean L within 1e-3; all lanes on >= 97.5%; and every shadow ray
    that starts on a sphere quadric decides that sphere's self-hit as the
    float64 roots of its own origin do (the witness for the sphere lanes:
    the reference's jitted program rounds the offset origin once, through
    fused multiply-adds). Returns the number of such shadow rays."""
    closest, shadow = [], []
    inter, inter_p = sc.intersect, sc.intersect_p

    def rec(scene, o, d, t):
        r = inter(scene, o, d, t)
        closest.append(r["prim"].clone())
        return r

    def rec_p(scene, o, d, t):
        r = inter_p(scene, o, d, t)
        shadow.append((o.clone(), d.clone(), t.clone(), r.clone()))
        return r
    monkeypatch.setattr(sc, "intersect", rec)
    monkeypatch.setattr(sc, "intersect_p", rec_p)
    L, L_ref = _wave(dj, dp, np.arange(256), 4, depth, counter)
    touched = np.zeros(len(L), bool)
    for prim in closest:
        touched |= prim.numpy() < 0
    rel = (np.abs(L - L_ref) / np.maximum(np.abs(L_ref), 1e-3)).max(axis=1)
    within = rel < 1e-4
    print(f"{label}: {within.mean():.2%} of {len(L)} lanes within rel 1e-4, "
          f"{within[~touched].mean():.2%} of the {(~touched).sum()} that "
          f"never hit a quadric; {(~within & touched).sum()} quadric lanes "
          "outside")
    assert np.isfinite(L).all()
    assert within[~touched].mean() >= 0.99
    assert within.mean() >= 0.975
    assert abs(float(L[~touched].mean()) / float(L_ref[~touched].mean())
               - 1.0) < 1e-3
    scene = dp.scene
    n_near = 0
    for q, tag in enumerate(scene.quadric_tags):
        if tag != sc.QUADRIC_SPHERE:
            continue
        row = scene.quadrics[q]
        A = row[:12].numpy().astype(np.float64).reshape(3, 4)
        r2 = float(row[12]) ** 2
        for o, d, t, occ in shadow:
            o64 = o.numpy().astype(np.float64) @ A[:, :3].T + A[:, 3]
            d64 = d.numpy().astype(np.float64) @ A[:, :3].T
            cc = np.sum(o64 * o64, -1) - r2
            tm = t.numpy()
            near = (tm > 0) & (np.abs(cc) < 1e-4)
            r0, r1 = _f64_roots(np.sum(d64 * d64, -1),
                                2 * np.sum(o64 * d64, -1), cc)
            hit64 = ((r0 > 1e-7) & (r0 < tm)) | ((r1 > 1e-7) & (r1 < tm))
            o_obj, d_obj = sc._quadric_ray(row, o, d)
            self_hit = sc._quadric_test(tag, row, o_obj, d_obj,
                                        t)["hit"].numpy()
            np.testing.assert_array_equal(self_hit[near], hit64[near])
            assert (occ.numpy() >= self_hit).all()
            n_near += int(near.sum())
    return n_near


def test_general_wave_small_plytex_matches_reference(small_plytex,
                                                     monkeypatch):
    dj, dp = small_plytex
    assert dp.scene.use_bvh and dp.scene.n_spheres == 1
    n_near = _hold_quadric_wave(dj, dp, 5, bvh8.counter, "plytex",
                                monkeypatch)
    assert n_near > 100, n_near
