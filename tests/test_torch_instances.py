"""Port vs reference: the instances path.

- Builder and parser: scenes/instances.pbrt and the ObjectBegin snippet of
  tests/test_instancing.py parse in both packages to the same tables,
  array for array and bit for bit: the two-level nodes, the instance
  rows, the BLAS-ordered triangles, the TLAS root, every triangle row, the
  light pool (the infinite light's power from the instance-aware scene
  radius) and the spectrum pool. What the port does not carry raises: an
  emissive object, ActiveTransform, an animated (o2w_end) instance.
- Hit records: scene_core.intersect and intersect_p against the
  reference's on 512 camera and bounce rays, the reference routed through
  its two-level packet traversal (use_pallas_tlas, with the Pallas call
  replaced by its jnp twin two_level_reference, which has the same
  signature). Positions, normals, uvs, derivatives and error bounds within
  rtol 1e-5 / atol 1e-5 (XLA's einsum and the port's written-out sums
  round the instance transforms a few ulp apart), materials exact.
- The general wave at 16x16, 2 spp, depth 3 against the reference's
  render_wave (trace_paths) on that same JAX scene: L within rel 1e-4
  (floor 1e-3) on >= 99% of lanes, mean L within 1e-3 relative; the
  shares are printed. Every closest and shadow query runs the two-level
  plain version.
- Entry points default to the card: without one, parse_string raises.
"""
import functools
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
from pbrt_tpu.ops import pallas_bvh as pbvh  # noqa: E402
from pbrt_tpu.scene import parser as jparser  # noqa: E402
from pbrt_tpu_torch import cameras as cam_mod  # noqa: E402
from pbrt_tpu_torch import convert  # noqa: E402
from pbrt_tpu_torch import filters as flt  # noqa: E402
from pbrt_tpu_torch import scene_core as sc  # noqa: E402
from pbrt_tpu_torch.integrators import path as path_mod  # noqa: E402
from pbrt_tpu_torch.integrators import render  # noqa: E402
from pbrt_tpu_torch.ops import bvh2  # noqa: E402
from pbrt_tpu_torch.ops import bvh8  # noqa: E402
from pbrt_tpu_torch.ops import tri_intersect as ti  # noqa: E402
from pbrt_tpu_torch.scene import parser  # noqa: E402
from pbrt_tpu_torch.utils import transform as tfm  # noqa: E402

from _jax_export import export  # noqa: E402

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
W = H = 16
SPP = 2
DEPTH = 3
TEXT = (ROOT / "scenes" / "instances.pbrt").read_bytes()
SMALL = TEXT.replace(b'"integer xresolution" [200] "integer yresolution" '
                     b'[200]', f'"integer xresolution" [{W}] "integer '
                     f'yresolution" [{H}]'.encode()) \
    .replace(b'"integer pixelsamples" [32]',
             f'"integer pixelsamples" [{SPP}]'.encode())
SNIPPET = b'''
Camera "perspective"
Film "rgb" "integer xresolution" [8] "integer yresolution" [8]
WorldBegin
LightSource "infinite"
ObjectBegin "block"
  Material "diffuse" "rgb reflectance" [.7 .3 .3]
  Shape "trianglemesh" "point3 P" [-1 -1 0  1 -1 0  1 1 0  -1 1 0]
      "integer indices" [0 1 2 0 2 3]
ObjectEnd
AttributeBegin
  Translate 0 0 -3
  ObjectInstance "block"
AttributeEnd
AttributeBegin
  Translate 4 0 -3
  ObjectInstance "block"
AttributeEnd
'''


def _compare_tables(sj, sp):
    assert sp.has_instances and sj.has_instances
    assert sp.tlas_root == sj.tlas_root
    for name, want in (("tlas_nodes", sj.tlas_nodes),
                       ("inst_rows", sj.inst_rows),
                       ("tri_geo_tlas", sj.tri_geo_tlas),
                       ("tri_all", sj.tri_all),
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


@pytest.mark.parametrize("text", [TEXT, SNIPPET],
                         ids=["instances.pbrt", "snippet"])
def test_parsed_tables_match_reference(text):
    dj = jparser.parse_string(text)
    dp = parser.parse_string(text, device="cpu")
    _compare_tables(dj.scene, dp.scene)
    # the snippet's world holds no triangles: both add the far dummy
    assert dp.scene.inst_rows.shape[0] == \
        {TEXT: 26, SNIPPET: 3}[text]


def test_convert_carries_the_two_level_tables():
    dj = jparser.parse_string(SMALL)
    arrays, meta = export(dj.scene, dj.camera, dj.sampler)
    scene, _cam, _smp = convert.from_jax_scene(arrays, meta, device="cpu")
    _compare_tables(dj.scene, scene)
    assert scene.tlas_depth == parser.parse_string(
        SMALL, device="cpu").scene.tlas_depth


@pytest.mark.parametrize("text, exc, match", [
    (b'ObjectBegin "o"\nAreaLightSource "diffuse" "rgb L" [1 1 1]\n'
     b'Shape "trianglemesh" "point3 P" [0 0 0 1 0 0 0 1 0] '
     b'"integer indices" [0 1 2]\nObjectEnd\nObjectInstance "o"\n',
     parser.ParseError, "emissive instanced geometry"),
    (b'ActiveTransform EndTime\n', parser.ParseError,
     "slice 3 item 10 \\(animated instances\\)"),
    (b'ObjectInstance "nothing"\n', parser.ParseError, "unknown object"),
])
def test_refused_instancing_raises(text, exc, match):
    with pytest.raises(exc, match=match):
        parser.parse_string(b"WorldBegin\n" + text, device="cpu")


def test_animated_instance_raises():
    b = sc.SceneBuilder()
    proto = b.new_prototype()
    b.add_proto_mesh(proto, [[0, 0, 0], [1, 0, 0], [0, 1, 0]], [[0, 1, 2]],
                     b.materials.add_diffuse((0.5, 0.5, 0.5)))
    b.add_instance(proto, tfm.identity(),
                   object_to_world_end=tfm.translate((1, 0, 0)))
    with pytest.raises(NotImplementedError,
                       match="slice 3 item 10 \\(animated instances\\)"):
        b.build(device="cpu")


def test_entry_points_default_to_the_card():
    """Without a card, an entry point called without a device raises
    rather than carrying on on the CPU."""
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="cuda"):
        parser.parse_string(SNIPPET)


@pytest.fixture(scope="module")
def scenes():
    dj = jparser.parse_string(SMALL)
    s = dj.scene.replace(
        use_pallas_tlas=True,
        tris_tlas_dense=pbvh.pad_tris_for_bvh(np.asarray(
            dj.scene.tri_geo_tlas)))
    return dj, s, parser.parse_string(SMALL, device="cpu")


def _hit_rays(scene, camera, n=256, seed=3):
    """n camera rays through random film points, and n bounce rays from
    their hits (origins offset off the surface, random directions)."""
    rs = np.random.RandomState(seed)
    p_film = torch.as_tensor((rs.uniform(0, 1, (n, 2)) * [W, H]).astype(
        np.float32))
    o, d = cam_mod.generate_ray(camera, p_film)
    o = o.expand(n, 3).contiguous()
    far = torch.full((n,), 1e30)
    r = sc.intersect(scene, o, d, far)
    w = rs.normal(size=(n, 3))
    w = torch.as_tensor((w / np.linalg.norm(w, axis=1, keepdims=True))
                        .astype(np.float32))
    o2 = sc.offset_ray_origin_exact(r["p"], r["p_err"], r["ng"], w)
    o2 = torch.where(r["hit"][:, None], o2, o)
    return torch.cat([o, o2]).numpy(), torch.cat([d, w]).numpy()


def test_hit_records_match_reference(scenes, monkeypatch):
    dj, s, dp = scenes
    monkeypatch.setattr(pbvh, "two_level_intersect_pallas",
                        pbvh.two_level_reference)
    o, d = _hit_rays(dp.scene, dp.camera)
    far = np.full(len(o), 1e30, np.float32)
    want = jsc.intersect(s, jnp.asarray(o), jnp.asarray(d), jnp.asarray(far))
    before = bvh2.counter_two_level.plain
    got = sc.intersect(dp.scene, torch.as_tensor(o), torch.as_tensor(d),
                       torch.as_tensor(far))
    assert bvh2.counter_two_level.plain == before + 1
    hit = np.asarray(want["hit"])
    print(f"{hit.mean():.3f} of {len(o)} camera and bounce rays hit")
    assert 0.3 < hit.mean() < 0.98
    np.testing.assert_array_equal(got["hit"].numpy(), hit)
    for k in ("prim", "mat", "light"):
        np.testing.assert_array_equal(got[k].numpy()[hit],
                                      np.asarray(want[k])[hit], err_msg=k)
    for k in ("t", "p", "ng", "ns", "uv", "dpdu", "dpdv", "p_err"):
        np.testing.assert_allclose(got[k].numpy()[hit],
                                   np.asarray(want[k])[hit], rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    t_sh = np.full(len(o), 3.0, np.float32)
    occl = sc.intersect_p(dp.scene, torch.as_tensor(o), torch.as_tensor(d),
                          torch.as_tensor(t_sh))
    occl_ref = jsc.intersect_p(s, jnp.asarray(o), jnp.asarray(d),
                               jnp.asarray(t_sh))
    assert 0.05 < float(np.asarray(occl_ref).mean()) < 0.95
    np.testing.assert_array_equal(occl.numpy(), np.asarray(occl_ref))


def test_general_wave_matches_reference(scenes, monkeypatch):
    dj, s, dp = scenes
    monkeypatch.setattr(pbvh, "two_level_intersect_pallas",
                        pbvh.two_level_reference)
    pix = np.tile(np.arange(W * H), SPP)
    si = np.repeat(np.arange(SPP), W * H)
    L_ref, _swl, fw_ref = jpath.render_wave(
        s, dj.camera, dj.sampler, jflt.make_filter("gaussian"),
        jnp.asarray(pix), jnp.asarray(si),
        jpath.PathOptions(max_depth=DEPTH, megakernel=False,
                          compaction=False))
    before = (bvh2.counter_two_level.plain, bvh8.counter.plain,
              ti.counter.plain)
    L, _swl, fw = path_mod.render_wave(
        dp.scene, dp.camera, dp.sampler, flt.make_filter("gaussian"),
        torch.as_tensor(pix), torch.as_tensor(si),
        path_mod.PathOptions(max_depth=DEPTH))
    # one closest and one shadow query per depth, all two-level
    assert bvh2.counter_two_level.plain - before[0] == 2 * DEPTH
    assert (bvh8.counter.plain, ti.counter.plain) == before[1:]
    L, L_ref = L.numpy(), np.asarray(L_ref)
    rel = (np.abs(L - L_ref) / np.maximum(np.abs(L_ref), 1e-3)).max(axis=1)
    within = float((rel < 1e-4).mean())
    exact = float((L == L_ref).all(axis=1).mean())
    mean_rel = abs(float(L.mean()) / float(L_ref.mean()) - 1.0)
    print(f"instances wave: {within:.2%} of {len(L)} lanes within rel "
          f"1e-4, {1 - within:.2%} outside, {exact:.2%} bit-identical, "
          f"mean L rel diff {mean_rel:.3g}")
    assert np.all(np.isfinite(L)) and L.mean() > 0
    assert within >= 0.99, within
    assert mean_rel < 1e-3, mean_rel
    np.testing.assert_allclose(fw.numpy(), np.asarray(fw_ref), rtol=1e-5,
                               atol=1e-6)


def test_render_tiles_four_sample_indices_per_wave(scenes):
    """render() at the golden's 200x200 takes 4 sample indices per
    160,000-lane wave; here at 16x16 all 2 samples fit one wave."""
    _dj, _s, dp = scenes
    assert render.MAX_WAVE_LANES // (200 * 200) >= 4 > \
        render.MAX_WAVE_LANES // (200 * 200 * 2)
    before = bvh2.counter_two_level.plain
    img, stats = render.render(dp.scene, dp.camera, sampler=dp.sampler,
                               device="cpu",
                               opts=path_mod.PathOptions(max_depth=DEPTH))
    assert stats["lanes_per_wave"] == W * H * SPP
    assert bvh2.counter_two_level.plain - before == 2 * DEPTH
    assert img.shape == (H, W, 3) and np.all(np.isfinite(img))
    assert img.mean() > 0
