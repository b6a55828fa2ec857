"""Port vs reference: the patches path (scenes/patches.pbrt).

- `ops/intersect.ray_bilinear_patch` against the reference's on seeded
  rays and patches (planar, twisted, a parallelogram whose quadratic is
  linear, grazing rays): hit flags equal on >= 99.9% of rays (measured:
  all); t, u, v within rtol 1e-5 of the reference on >= 98% of the rays
  both hit (measured 98.3-100%). On the rest the float32 quadratic and
  determinants cancel, XLA on the CPU contracts multiply-adds and torch
  rounds twice, and the two differ by up to 6e-5 (t), 5% (v, grazing):
  there the port is held to the float64 value of the same formula, no
  farther from it than twice the reference is;
- the parser: patches.pbrt's tables bit-equal to the reference parser's,
  the > 64-quad and the N / uv branches triangulated as the reference does;
- `scene_core.intersect` hit records and `intersect_p` on camera and bounce
  rays, within rel 1e-4;
- the general wave lane for lane against the reference's
  trace_paths(megakernel=False) on patches.pbrt at 32x32, 2 spp: every
  lane within rel 1e-4 (floor 1e-3).
"""
import os
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from pbrt_tpu import filters as jflt  # noqa: E402
from pbrt_tpu import scene_core as jsc  # noqa: E402
from pbrt_tpu.integrators import path as jpath  # noqa: E402
from pbrt_tpu.ops import intersect as jisect  # noqa: E402
from pbrt_tpu.scene import parser as jparser  # noqa: E402
from pbrt_tpu_torch import cameras as cam_mod  # noqa: E402
from pbrt_tpu_torch import convert  # noqa: E402
from pbrt_tpu_torch import filters as flt  # noqa: E402
from pbrt_tpu_torch import scene_core as sc  # noqa: E402
from pbrt_tpu_torch.integrators import path as path_mod  # noqa: E402
from pbrt_tpu_torch.integrators import render  # noqa: E402
from pbrt_tpu_torch.ops import intersect as isect  # noqa: E402
from pbrt_tpu_torch.ops import tri_intersect as ti  # noqa: E402
from pbrt_tpu_torch.scene import parser  # noqa: E402

from _jax_export import export  # noqa: E402

torch.set_num_threads(1)
W = H = 32
SPP = 2
DEPTH = 3
TEXT = (Path(__file__).resolve().parent.parent / "scenes"
        / "patches.pbrt").read_bytes()
SMALL = TEXT.replace(b'"integer xresolution" [200] "integer yresolution" '
                     b'[200]', f'"integer xresolution" [{W}] "integer '
                     f'yresolution" [{H}]'.encode()) \
    .replace(b'"integer pixelsamples" [32]',
             f'"integer pixelsamples" [{SPP}]'.encode())
HEAD = (b'Camera "perspective"\nFilm "rgb" "integer xresolution" [8] '
        b'"integer yresolution" [8]\nWorldBegin\nLightSource "infinite"\n')
QUAD = (b'"point3 P" [-1 0 -1  1 0.3 -1  -1 0.2 1  1 -0.4 1] '
        b'"integer indices" [0 1 2 3]')


def _patches(kind, n, rs):
    """n seeded patches (p00, p10, p01, p11), each (n, 3)."""
    base = np.array([[-1, 0, -1], [1, 0, -1], [-1, 0, 1], [1, 0, 1]], float)
    c = base[None] + rs.uniform(-0.2, 0.2, (n, 4, 3)) * [1, 0, 1]
    if kind == "twisted":
        c[:, :, 1] = rs.uniform(-0.8, 0.8, (n, 4))
    elif kind == "parallelogram":
        # p11 = p10 + p01 - p00: the quadratic's leading term vanishes
        c[:, 1, 1] = rs.uniform(-0.5, 0.5, n)
        c[:, 2, 1] = rs.uniform(-0.5, 0.5, n)
        c[:, 3] = c[:, 1] + c[:, 2] - c[:, 0]
    c += rs.uniform(-3, 3, (n, 1, 3))
    return [c[:, i].astype(np.float32) for i in range(4)]


@pytest.mark.parametrize("kind", ["planar", "twisted", "parallelogram",
                                  "grazing"])
def test_ray_bilinear_patch_matches_reference(kind):
    rs = np.random.RandomState(11)
    n = 4096
    corners = _patches("twisted" if kind == "grazing" else kind, n, rs)
    u, v = rs.uniform(-0.1, 1.1, (2, n, 1))
    target = ((1 - v) * ((1 - u) * corners[0] + u * corners[1])
              + v * ((1 - u) * corners[2] + u * corners[3]))
    if kind == "grazing":
        # from beside the patch, nearly in its plane
        o = target + rs.normal(size=(n, 3)) * [4.0, 0.05, 4.0]
    else:
        o = target + rs.normal(size=(n, 3)) * 3.0
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = o.astype(np.float32), d.astype(np.float32)
    t_max = np.where(rs.uniform(size=n) < 0.2, 2.0, 1e30).astype(np.float32)
    want = jisect.ray_bilinear_patch(jnp.asarray(o), jnp.asarray(d),
                                     jnp.asarray(t_max),
                                     *(jnp.asarray(c) for c in corners))
    got = isect.ray_bilinear_patch(torch.as_tensor(o), torch.as_tensor(d),
                                   torch.as_tensor(t_max),
                                   *(torch.as_tensor(c) for c in corners))
    exact = isect.ray_bilinear_patch(
        torch.as_tensor(o).double(), torch.as_tensor(d).double(),
        torch.as_tensor(t_max).double(),
        *(torch.as_tensor(c).double() for c in corners))
    hit_w, hit_g = np.asarray(want["hit"]), got["hit"].numpy()
    agree = float((hit_w == hit_g).mean())
    both = hit_w & hit_g & exact["hit"].numpy()
    print(f"{kind}: hit share {hit_w.mean():.3f}, flags equal on "
          f"{agree:.4%} of {n} rays")
    assert 0.3 < hit_w.mean() < 0.95
    assert agree >= 0.999, agree
    for k in ("t", "u", "v"):
        g, w = got[k].numpy()[both], np.asarray(want[k])[both]
        x = exact[k].numpy()[both]
        rel = np.abs(g - w) / np.maximum(np.abs(w), 1e-3)
        share = float((rel <= 1e-5).mean())
        err_g = np.abs(g - x) / np.maximum(np.abs(x), 1e-3)
        err_w = np.abs(w - x) / np.maximum(np.abs(x), 1e-3)
        q_g, q_w = np.quantile(err_g, 0.99), np.quantile(err_w, 0.99)
        print(f"  {k}: {share:.3%} within rtol 1e-5 of the reference (max "
              f"rel {rel.max():.3g}); rel error to float64, 99th percentile "
              f"and max: port {q_g:.3g}, {err_g.max():.3g}; reference "
              f"{q_w:.3g}, {err_w.max():.3g}")
        # the float32 quadratic and determinants cancel on some rays, and
        # XLA contracts multiply-adds where torch rounds twice: there both
        # sides are as far from the float64 value of the same formula.
        # Measured with this seed: share >= 98.2%; the port's 99th
        # percentile <= 1.4x and its max <= 2.7x the reference's
        assert share >= 0.98, (k, share)
        assert q_g <= 2.0 * q_w, (k, q_g, q_w)
        assert err_g.max() <= 4.0 * err_w.max() + 1e-6, (k, err_g.max(),
                                                         err_w.max())
    assert np.all(np.isinf(got["t"].numpy()[~hit_g]))


def _compare_tables(sj, sp):
    for name, want in (("tri_all", sj.tri_all),
                       ("tri_pallas", sj.tri_pallas),
                       ("mat_pool", sj.materials.packed),
                       ("lights_packed", sj.lights.packed),
                       ("spectra_pool", sj.spectra_pool)):
        a, b = np.asarray(want), getattr(sp, name).numpy()
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8),
                                      err_msg=name)
    assert sp.scene_radius == float(sj.scene_radius)
    np.testing.assert_array_equal(sp.light_sampler.pmf_table,
                                  np.asarray(sj.light_sampler.pmf_table))
    assert sp.mega is None and sj.mega is None
    assert sp.has_blps == sj.has_blps
    if sj.has_blps:
        a, b = np.asarray(sj.blp_rows), sp.blp_rows.numpy()
        assert a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    else:
        assert sp.blp_rows is None


def _many_quads(n):
    """A strip of n quads as bilinearmesh parameters."""
    P = [(x, 0.1 * (x % 3), z) for x in range(n + 1) for z in (0, 1)]
    idx = [i for q in range(n) for i in (2 * q, 2 * q + 2, 2 * q + 1,
                                         2 * q + 3)]
    return ('"point3 P" [' + " ".join(f"{c:g}" for p in P for c in p)
            + '] "integer indices" [' + " ".join(map(str, idx))
            + "]").encode()


@pytest.mark.parametrize("text, n_patches, n_tris", [
    (TEXT, 12, 2),
    (HEAD + b'Translate 0 1 0\nShape "bilinearmesh" ' + QUAD, 1, 1),
    (HEAD + b'Shape "bilinearmesh" ' + _many_quads(64), 64, 1),
    (HEAD + b'Shape "bilinearmesh" ' + _many_quads(65), 0, 130),
    (HEAD + b'Shape "bilinearmesh" ' + QUAD
     + b' "point2 uv" [0 0 1 0 0 1 1 1]', 0, 2),
    (HEAD + b'Shape "bilinearmesh" ' + QUAD
     + b' "normal N" [0 1 0 0 1 0 0 1 0 0 1 0]', 0, 2),
    (HEAD + b'AreaLightSource "diffuse" "rgb L" [1 1 1]\n'
     b'Shape "bilinearmesh" ' + QUAD, 0, 2),
], ids=["patches.pbrt", "one-patch", "64-quads", "65-quads", "uv", "N",
        "emissive"])
def test_parsed_tables_match_reference(text, n_patches, n_tris):
    dj = jparser.parse_string(text)
    dp = parser.parse_string(text, device="cpu")
    _compare_tables(dj.scene, dp.scene)
    assert dp.scene.has_blps == (n_patches > 0)
    if n_patches:
        assert dp.scene.blp_rows.shape == (n_patches, 14)
    # a world of patches only holds the far dummy triangle
    assert dp.scene.n_tris == n_tris


@pytest.mark.parametrize("text, match", [
    (b'ObjectBegin "o"\nShape "bilinearmesh" ' + QUAD + b'\nObjectEnd\n',
     "shape 'bilinearmesh' in an object is not ported yet"),
    (b'Shape "bilinearmesh" ' + QUAD + b' "float alpha" [0.5]',
     "slice 4 item 18"),
    (b'Shape "bilinearmesh" "integer indices" [0 1 2 3]', "needs"),
])
def test_refused_bilinearmesh_raises(text, match):
    with pytest.raises(parser.ParseError, match=match):
        parser.parse_string(HEAD + text, device="cpu")


def test_convert_carries_the_patch_rows():
    dj = jparser.parse_string(SMALL)
    arrays, meta = export(dj.scene, dj.camera, dj.sampler)
    scene, _cam, _smp = convert.from_jax_scene(arrays, meta, device="cpu")
    _compare_tables(dj.scene, scene)


@pytest.fixture(scope="module")
def scenes():
    dj = jparser.parse_string(SMALL)
    return dj, dj.scene.replace(use_pallas=True), \
        parser.parse_string(SMALL, device="cpu")


def _hit_rays(scene, camera, n=512, seed=3):
    """n camera rays through random film points, and n bounce rays from
    their hits (origins offset off the surface, random directions)."""
    rs = np.random.RandomState(seed)
    p_film = torch.as_tensor((rs.uniform(0, 1, (n, 2)) * [W, H]).astype(
        np.float32))
    o, d = cam_mod.generate_ray(camera, p_film)
    o = o.expand(n, 3).contiguous()
    r = sc.intersect(scene, o, d, torch.full((n,), 1e30))
    w = rs.normal(size=(n, 3))
    w = torch.as_tensor((w / np.linalg.norm(w, axis=1, keepdims=True))
                        .astype(np.float32))
    o2 = sc.offset_ray_origin_exact(r["p"], r["p_err"], r["ng"], w)
    o2 = torch.where(r["hit"][:, None], o2, o)
    return torch.cat([o, o2]).numpy(), torch.cat([d, w]).numpy()


def test_hit_records_match_reference(scenes):
    dj, s, dp = scenes
    o, d = _hit_rays(dp.scene, dp.camera)
    far = np.full(len(o), 1e30, np.float32)
    want = jsc.intersect(s, jnp.asarray(o), jnp.asarray(d), jnp.asarray(far))
    got = sc.intersect(dp.scene, torch.as_tensor(o), torch.as_tensor(d),
                       torch.as_tensor(far))
    hit = np.asarray(want["hit"])
    on_patch = hit & (np.asarray(want["mat"]) == 1)
    print(f"{hit.mean():.3f} of {len(o)} camera and bounce rays hit, "
          f"{on_patch.mean():.3f} a patch")
    assert 0.3 < hit.mean() < 0.98 and on_patch.mean() > 0.1
    np.testing.assert_array_equal(got["hit"].numpy(), hit)
    for k in ("mat", "light"):
        np.testing.assert_array_equal(got[k].numpy()[hit],
                                      np.asarray(want[k])[hit], err_msg=k)
    for k in ("t", "p", "ng", "ns", "uv", "dpdu", "dpdv", "p_err"):
        np.testing.assert_allclose(got[k].numpy()[hit],
                                   np.asarray(want[k])[hit], rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    t_sh = np.full(len(o), 3.0, np.float32)
    occl = sc.intersect_p(dp.scene, torch.as_tensor(o), torch.as_tensor(d),
                          torch.as_tensor(t_sh))
    occl_ref = jsc.intersect_p(s, jnp.asarray(o), jnp.asarray(d),
                               jnp.asarray(t_sh))
    assert 0.05 < float(np.asarray(occl_ref).mean()) < 0.95
    np.testing.assert_array_equal(occl.numpy(), np.asarray(occl_ref))


def test_general_wave_matches_reference(scenes):
    dj, s, dp = scenes
    assert dp.scene.has_blps and not dp.scene.use_bvh
    pix = np.tile(np.arange(W * H), SPP)
    si = np.repeat(np.arange(SPP), W * H)
    L_ref, _swl, fw_ref = jpath.render_wave(
        s, dj.camera, dj.sampler, jflt.make_filter("gaussian"),
        jnp.asarray(pix), jnp.asarray(si),
        jpath.PathOptions(max_depth=DEPTH, megakernel=False,
                          compaction=False))
    before = ti.counter.plain
    L, _swl, fw = path_mod.render_wave(
        dp.scene, dp.camera, dp.sampler, flt.make_filter("gaussian"),
        torch.as_tensor(pix), torch.as_tensor(si),
        path_mod.PathOptions(max_depth=DEPTH))
    # one closest and one shadow query per depth through the triangle route
    assert ti.counter.plain - before == 2 * DEPTH
    L, L_ref = L.numpy(), np.asarray(L_ref)
    rel = (np.abs(L - L_ref) / np.maximum(np.abs(L_ref), 1e-3)).max(axis=1)
    within = float((rel < 1e-4).mean())
    exact = float((L == L_ref).all(axis=1).mean())
    mean_rel = abs(float(L.mean()) / float(L_ref.mean()) - 1.0)
    print(f"patches wave: {within:.2%} of {len(L)} lanes within rel 1e-4, "
          f"{1 - within:.2%} outside, {exact:.2%} bit-identical, mean L rel "
          f"diff {mean_rel:.3g}")
    assert np.all(np.isfinite(L)) and L.mean() > 0
    assert within == 1.0, within
    assert mean_rel < 1e-5, mean_rel
    np.testing.assert_allclose(fw.numpy(), np.asarray(fw_ref), rtol=1e-5,
                               atol=1e-6)


def test_render_of_a_patch_scene(scenes):
    _dj, _s, dp = scenes
    img, stats = render.render(dp.scene, dp.camera, sampler=dp.sampler,
                               device="cpu",
                               opts=path_mod.PathOptions(max_depth=DEPTH))
    assert stats["lanes_per_wave"] == W * H * SPP
    assert img.shape == (H, W, 3) and np.all(np.isfinite(img))
    # the patches' red-brown material shows: red over blue in the middle
    mid = img[H // 4:3 * H // 4, W // 4:3 * W // 4].mean(axis=(0, 1))
    assert img.mean() > 0 and mid[0] > 1.2 * mid[2]
