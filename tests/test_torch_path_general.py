"""Port vs reference: the general path wave.

Two routes of the port's trace_paths against pbrt_tpu's trace_paths with
megakernel=False, lane for lane, on the same pixels, sample indices and
sampler:
- the BVH8 route: a parsed scene of a few hundred triangles (a smooth-
  shaded sphere with per-vertex normals and uvs, a ground quad, an area
  lamp and a uniform infinite light) built with force_bvh=True; the
  reference traces it through its Pallas BVH8 kernel in interpret mode;
- the brute-force route: cornell, the reference through its Pallas
  triangle kernel in interpret mode.
Tolerance: L within rel 1e-4 (floor 1e-3) on >= 99% of lanes and the mean
L within 1e-3 relative: a lane outside it comes from a hit or roulette
decision that flips on a rounding-level difference (XLA on the CPU and
torch round a few transcendental functions an ulp apart). The shares are
printed. The components of the wave (intersect, light sampling, the BSDF,
the offset origin) are also held to the reference on their own.
"""
import functools
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from pbrt_tpu import bxdfs as jbxdfs  # noqa: E402
from pbrt_tpu import filters as jflt  # noqa: E402
from pbrt_tpu import lights as jlgt  # noqa: E402
from pbrt_tpu import lightsamplers as jls  # noqa: E402
from pbrt_tpu import materials as jmtl  # noqa: E402
from pbrt_tpu import scene_core as jsc  # noqa: E402
from pbrt_tpu.integrators import path as jpath  # noqa: E402
from pbrt_tpu.ops import pallas_bvh8 as jb8  # noqa: E402
from pbrt_tpu.scene import parser as jparser  # noqa: E402
from pbrt_tpu_torch import bxdfs  # noqa: E402
from pbrt_tpu_torch import filters as flt  # noqa: E402
from pbrt_tpu_torch import lights as lgt  # noqa: E402
from pbrt_tpu_torch import lightsamplers as lsamp  # noqa: E402
from pbrt_tpu_torch import materials as mtl  # noqa: E402
from pbrt_tpu_torch import scene_core as sc  # noqa: E402
from pbrt_tpu_torch import scenes  # noqa: E402
from pbrt_tpu_torch.integrators import path as path_mod  # noqa: E402
from pbrt_tpu_torch.integrators import render  # noqa: E402
from pbrt_tpu_torch.ops import bvh8  # noqa: E402
from pbrt_tpu_torch.ops import megawave  # noqa: E402
from pbrt_tpu_torch.ops import tri_intersect as ti  # noqa: E402
from pbrt_tpu_torch.scene import parser  # noqa: E402

from _jax_export import export_cornell  # noqa: E402

torch.set_num_threads(1)
W = H = 8
SPP = 2
DEPTH = 4


def _sphere(nu=12, nv=8, r=1.0, c=(0.0, 1.0, 0.0)):
    """A uv sphere as trianglemesh text, with normals and uvs."""
    P, N, UV, idx = [], [], [], []
    for j in range(nv + 1):
        th = np.pi * j / nv
        for i in range(nu + 1):
            ph = 2 * np.pi * i / nu
            n = np.array([np.sin(th) * np.cos(ph), np.cos(th),
                          np.sin(th) * np.sin(ph)])
            P.append(np.asarray(c) + r * n)
            N.append(n)
            UV.append((i / nu, j / nv))
    for j in range(nv):
        for i in range(nu):
            a = j * (nu + 1) + i
            idx += [a, a + nu + 1, a + 1, a + 1, a + nu + 1, a + nu + 2]

    def f(a):
        return " ".join(f"{x:.6g}" for x in np.asarray(a).reshape(-1))
    return (f'Shape "trianglemesh" "integer indices" [{f(idx)}]\n'
            f'  "point3 P" [{f(P)}]\n  "normal N" [{f(N)}]\n'
            f'  "point2 uv" [{f(UV)}]\n')


SCENE = (
    'LookAt 0 2 6  0 0.8 0  0 1 0\nCamera "perspective" "float fov" [45]\n'
    f'Film "rgb" "integer xresolution" [{W}] "integer yresolution" [{H}]\n'
    f'Sampler "zsobol" "integer pixelsamples" [{SPP}]\n'
    f'Integrator "path" "integer maxdepth" [{DEPTH}]\nWorldBegin\n'
    'LightSource "infinite" "rgb L" [0.4 0.45 0.5]\n'
    'Material "diffuse" "rgb reflectance" [0.7 0.3 0.2]\n' + _sphere() +
    'Material "diffuse" "rgb reflectance" [0.5 0.5 0.5]\n'
    'Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]\n'
    '  "point3 P" [-4 0 -4  4 0 -4  4 0 4  -4 0 4]\n'
    'AttributeBegin\n  AreaLightSource "diffuse" "rgb L" [8 8 6]\n'
    '  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]\n'
    '    "point3 P" [-1 3 -1  -1 3 1  1 3 1  1 3 -1]\nAttributeEnd\n')


def _lanes():
    pix = np.tile(np.arange(W * H), SPP)
    si = np.repeat(np.arange(SPP), W * H)
    return pix, si


def _hold(L, L_ref, label):
    rel = (np.abs(L - L_ref) / np.maximum(np.abs(L_ref), 1e-3)).max(axis=1)
    within = float((rel < 1e-4).mean())
    exact = float((L == L_ref).all(axis=1).mean())
    mean_rel = abs(float(L.mean()) / float(L_ref.mean()) - 1.0)
    print(f"{label}: {within:.2%} of {len(L)} lanes within rel 1e-4, "
          f"{1 - within:.2%} outside (a flipped hit or roulette decision), "
          f"{exact:.2%} bit-identical, mean L rel diff {mean_rel:.3g}")
    assert np.all(np.isfinite(L))
    assert within >= 0.99, within
    assert mean_rel < 1e-3, mean_rel


@pytest.fixture(scope="module")
def bvh_scenes():
    dj = jparser.parse_string(SCENE, force_bvh=True)
    s = dj.scene
    lo = np.minimum(np.minimum(s.tri_p0, s.tri_p1), s.tri_p2)
    hi = np.maximum(np.maximum(s.tri_p0, s.tri_p1), s.tri_p2)
    s8 = s.replace(bvh8=jb8.build_bvh8(np.asarray(lo), np.asarray(hi),
                                       np.asarray(s.tri_geo)),
                   use_pallas_bvh8=True)
    return dj, s, s8, parser.parse_string(SCENE, force_bvh=True,
                                          device="cpu")


def test_bvh_route_matches_reference(bvh_scenes, monkeypatch):
    dj, _s, s8, dp = bvh_scenes
    assert dp.scene.use_bvh and dp.scene.n_tris == 196
    assert dp.scene.light_tags == (lgt.LIGHT_AREA_TRI,
                                   lgt.LIGHT_UNIFORM_INFINITE)
    np.testing.assert_array_equal(dp.scene.bvh8.nodes_q.numpy(),
                                  np.asarray(s8.bvh8.nodes_q))
    monkeypatch.setattr(jb8, "bvh8_intersect",
                        functools.partial(jb8.bvh8_intersect, interpret=True))
    pix, si = _lanes()
    L_ref, _swl, fw_ref = jpath.render_wave(
        s8, dj.camera, dj.sampler, jflt.make_filter("gaussian"),
        jnp.asarray(pix), jnp.asarray(si),
        jpath.PathOptions(max_depth=DEPTH, megakernel=False,
                          compaction=False))
    before = (bvh8.counter.plain, ti.counter.plain)
    L, _swl, fw = path_mod.render_wave(
        dp.scene, dp.camera, dp.sampler, flt.make_filter("gaussian"),
        torch.as_tensor(pix), torch.as_tensor(si),
        path_mod.PathOptions(max_depth=DEPTH))
    # one closest and one shadow query per depth, all through the BVH8
    assert bvh8.counter.plain - before[0] == 2 * DEPTH
    assert ti.counter.plain == before[1]
    _hold(L.numpy(), np.asarray(L_ref), "BVH8 route")
    np.testing.assert_allclose(fw.numpy(), np.asarray(fw_ref), rtol=1e-5,
                               atol=1e-6)


@pytest.fixture(scope="module")
def cornell():
    scene_j, cam_j, sampler_j, _arrays, _meta = export_cornell(W, H, SPP)
    scene, cam = scenes.make_cornell_box(W, H, device="cpu")
    return scene_j, cam_j, sampler_j, scene, cam


def _cornell_port_wave(cornell):
    _sj, _cj, _smj, scene, cam = cornell
    pix, si = _lanes()
    sampler = path_mod.smp.make_sampler("zsobol", spp=SPP,
                                        full_resolution=(W, H))
    before = (ti.counter.plain, megawave.counter.plain)
    L, swl, fw = path_mod.render_wave(
        scene, cam, sampler, flt.make_filter("gaussian"),
        torch.as_tensor(pix), torch.as_tensor(si),
        path_mod.PathOptions(max_depth=DEPTH, megakernel=False))
    assert ti.counter.plain - before[0] == 2 * DEPTH
    assert megawave.counter.plain == before[1]
    return L, swl, fw, sampler


def test_cornell_general_wave_matches_reference(cornell):
    scene_j, cam_j, sampler_j, _scene, _cam = cornell
    pix, si = _lanes()
    L_ref, _swl, _fw = jpath.render_wave(
        scene_j.replace(use_pallas=True), cam_j, sampler_j,
        jflt.make_filter("gaussian"), jnp.asarray(pix), jnp.asarray(si),
        jpath.PathOptions(max_depth=DEPTH, megakernel=False,
                          compaction=False))
    L, _swl, _fw, _smp = _cornell_port_wave(cornell)
    _hold(L.numpy(), np.asarray(L_ref), "cornell, triangle kernel route")


def test_cornell_general_wave_matches_megakernel_plain(cornell):
    _sj, _cj, _smj, scene, cam = cornell
    L, swl, fw, sampler = _cornell_port_wave(cornell)
    pix, si = _lanes()
    pix, si = torch.as_tensor(pix), torch.as_tensor(si)
    w = megawave.prepare_full(scene, sampler, cam,
                              flt.make_filter("gaussian"), pix % W, pix // W,
                              si, swl.lam, max_depth=DEPTH)
    L_m, fw_m = megawave.wave_full_plain(w)
    _hold(L.numpy(), L_m.numpy(), "cornell, general wave vs megakernel")
    torch.testing.assert_close(fw, fw_m, rtol=1e-5, atol=1e-6)


def test_render_routes_by_megakernel_option(cornell):
    """render() on an eligible scene takes the megakernel unless
    PathOptions.megakernel is False; both images agree."""
    _sj, _cj, _smj, scene, cam = cornell
    counts = []
    imgs = []
    for mk in ("auto", False):
        before = (megawave.counter.plain, ti.counter.plain)
        img, stats = render.render(scene, cam, spp=SPP, device="cpu",
                                   opts=path_mod.PathOptions(max_depth=3,
                                                             megakernel=mk))
        counts.append((megawave.counter.plain - before[0],
                       ti.counter.plain - before[1]))
        imgs.append(img)
        assert img.shape == (H, W, 3) and np.all(np.isfinite(img))
    assert counts[0][0] >= 1 and counts[1] == (0, 2 * 3)
    np.testing.assert_allclose(imgs[1], imgs[0], rtol=1e-4, atol=1e-6)


def _rays(n, seed, lo, hi):
    rs = np.random.RandomState(seed)
    o = rs.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3))
    return o, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(
        np.float32)


def test_intersect_matches_reference(bvh_scenes):
    """Hit records on the BVH route against the reference's XLA traversal
    (its own plain path on the CPU)."""
    _dj, s, _s8, dp = bvh_scenes
    o, d = _rays(512, 4, (-3, 0.2, -3), (3, 2.5, 3))
    far = np.full(len(o), 1e30, np.float32)
    want = jsc.intersect(s, jnp.asarray(o), jnp.asarray(d), jnp.asarray(far))
    got = sc.intersect(dp.scene, torch.as_tensor(o), torch.as_tensor(d),
                       torch.as_tensor(far))
    hit = np.asarray(want["hit"])
    np.testing.assert_array_equal(got["hit"].numpy(), hit)
    same = hit & (got["prim"].numpy() == np.asarray(want["prim"]))
    assert same.sum() >= 0.99 * hit.sum()
    for k in ("t", "p", "ng", "ns", "uv", "dpdu", "dpdv", "p_err"):
        np.testing.assert_allclose(got[k].numpy()[same],
                                   np.asarray(want[k])[same], rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    for k in ("mat", "light"):
        np.testing.assert_array_equal(got[k].numpy()[same],
                                      np.asarray(want[k])[same], err_msg=k)
    occl = sc.intersect_p(dp.scene, torch.as_tensor(o), torch.as_tensor(d),
                          torch.full((len(o),), 2.0))
    occl_ref = jsc.intersect_p(s, jnp.asarray(o), jnp.asarray(d),
                               jnp.full((len(o),), 2.0))
    np.testing.assert_array_equal(occl.numpy(), np.asarray(occl_ref))
    w = torch.as_tensor(d)
    po = sc.offset_ray_origin_exact(got["p"], got["p_err"], got["ng"], w)
    po_ref = jsc.offset_ray_origin_exact(want["p"], want["p_err"],
                                         want["ng"], jnp.asarray(d))
    np.testing.assert_allclose(po.numpy()[same], np.asarray(po_ref)[same],
                               rtol=1e-5, atol=1e-5)


def test_light_sampling_matches_reference(bvh_scenes):
    """Light pick (power alias table) and sample_li over the area lamp and
    the infinite light, with the same uniforms."""
    _dj, s, _s8, dp = bvh_scenes
    scene = dp.scene
    rs = np.random.RandomState(5)
    n = 1024
    u = rs.uniform(0, 1, n).astype(np.float32)
    u2 = rs.uniform(0, 1, (n, 2)).astype(np.float32)
    p = rs.uniform(-2, 2, (n, 3)).astype(np.float32)
    lam = rs.uniform(360, 830, (n, 4)).astype(np.float32)
    idx_j, pmf_j, _u = jls.sample_light(s.light_sampler, jnp.asarray(u))
    idx, pmf = lsamp.sample_light(scene.light_sampler, torch.as_tensor(u),
                                  scene.alias_rows)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(pmf.numpy(), np.asarray(pmf_j))
    want = jlgt.sample_li(s.lights, idx_j, jnp.asarray(p), None,
                          jnp.asarray(u2), jnp.asarray(lam), s.spectra_pool,
                          s.tri_geo, s.scene_radius)
    got = lgt.sample_li(scene.lights_packed, idx, torch.as_tensor(p),
                        torch.as_tensor(u2), torch.as_tensor(lam),
                        scene.spectra_pool, scene.scene_radius,
                        scene.light_tags)
    for k in ("wi", "L", "pdf", "p_light"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    for k in ("is_delta", "valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


def test_bsdf_matches_reference(bvh_scenes):
    _dj, s, _s8, dp = bvh_scenes
    rs = np.random.RandomState(6)
    n = 1024
    mat = rs.randint(0, 2, n)
    lam = rs.uniform(360, 830, (n, 4)).astype(np.float32)
    wo = rs.normal(size=(n, 3))
    wi = rs.normal(size=(n, 3))
    wo, wi = ((v / np.linalg.norm(v, axis=1, keepdims=True)).astype(
        np.float32) for v in (wo, wi))
    u2 = rs.uniform(0, 1, (n, 2)).astype(np.float32)
    bp_j = jmtl.get_bsdf_params(s.materials, jnp.asarray(mat, jnp.int32),
                                jnp.asarray(lam), s.spectra_pool)
    bp = mtl.get_bsdf_params(dp.scene.mat_pool, torch.as_tensor(mat),
                             torch.as_tensor(lam))
    np.testing.assert_allclose(bp.albedo.numpy(), np.asarray(bp_j.albedo),
                               rtol=1e-6, atol=1e-7)
    args_j = (bp_j, jnp.asarray(wo), jnp.asarray(wi))
    args = (bp, torch.as_tensor(wo), torch.as_tensor(wi))
    np.testing.assert_allclose(bxdfs.bsdf_f(*args).numpy(),
                               np.asarray(jbxdfs.bsdf_f(*args_j)), rtol=1e-6)
    np.testing.assert_allclose(bxdfs.bsdf_pdf(*args).numpy(),
                               np.asarray(jbxdfs.bsdf_pdf(*args_j)),
                               rtol=1e-6)
    bs_j = jbxdfs.bsdf_sample(bp_j, jnp.asarray(wo), jnp.zeros(n),
                              jnp.asarray(u2))
    bs = bxdfs.bsdf_sample(bp, torch.as_tensor(wo), torch.zeros(n),
                           torch.as_tensor(u2))
    for k in ("wi", "f", "pdf"):
        np.testing.assert_allclose(bs[k].numpy(), np.asarray(bs_j[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(bs["valid"].numpy(),
                                  np.asarray(bs_j["valid"]))
    bp.tags_present = (bxdfs.BXDF_DIFFUSE, 5)
    with pytest.raises(NotImplementedError, match="ROADMAP.md slice 3"):
        bxdfs.bsdf_f(*args)
