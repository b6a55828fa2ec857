"""Port vs reference: curve shapes (pbrt_tpu_torch/ops/curves.py and the
curve parts of scene_core and the parser).

- split_curve: rows and boxes bit-equal to the reference's for flat,
  cylinder and ribbon curves.
- segment_test against the reference's _segment_test on seeded rays aimed
  near seeded segments: hit exact, t, u, v and n within rel 1e-5 (atol
  1e-5 for the components near 0).
- The plain traversal (curves_intersect_plain) with the re-test
  (intersect_curves) against the reference's XLA traversal
  bvh_intersect_curves on seeded rays through a seeded fur patch: hit and
  curve id exact, any-hit hit exact, t and u within rel 1e-5 (atol 1e-5),
  v and n within atol 5e-3 (the worst printed): v - 1/2 is the ray's
  distance from the axis over the width, a rounding-level quantity for a
  ray aimed at the axis, which the XLA loop rounds differently from its
  own _segment_test, and where the ray passes through the joint of two
  segments the two traversals may take either; the reference's
  _segment_test on the port's winning rows gives the port's u and v bit
  for bit and n within 2 ulp (its normalisations round apart). A tree
  deeper than the stack is refused.
- The curve kernel's own node table (wide_nodes): every child box, ref and
  axis bit-equal to the reference-layout rows it was derived from, in
  their order; the kernel's walk over it, emulated a ray at a time
  in float32, gives the plain version's t and segment bit for bit.
- SceneBuilder and the parser: every curve table (nodes, leaf-ordered
  segments, curve materials), the triangle rows, the material, light and
  spectrum pools and the scene radius bit-equal to the reference's; the
  reference's ParseErrors.
- scene_core.intersect and intersect_p on a scene of triangles and curves
  against the reference's (its XLA curve traversal): every field within
  rel 1e-5 (atol 1e-5), p_err included (a curve hit keeps the triangle
  query's p_err under the gamma(7) |p| floor, in both), except a curve
  hit's v and normals (ng, ns, dpdv), within atol 5e-3 as above; the
  shadow query exact.
"""
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from pbrt_tpu import scene_core as jsc  # noqa: E402
from pbrt_tpu.ops import curves as jcrv  # noqa: E402
from pbrt_tpu.scene import parser as jparser  # noqa: E402
from pbrt_tpu.utils import spectrum as jspc  # noqa: E402
from pbrt_tpu_torch import convert  # noqa: E402
from pbrt_tpu_torch import scene_core as sc  # noqa: E402
from pbrt_tpu_torch.ops import curves as crv  # noqa: E402
from pbrt_tpu_torch.scene import parser  # noqa: E402
from pbrt_tpu_torch.utils import spectrum as spc  # noqa: E402

from _jax_export import export  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
from hair_scene import hair_scene_text  # noqa: E402

torch.set_num_threads(1)
RTOL = 1e-5


def _seeded_curves(n, seed):
    """n cubic Bezier control polygons (4, 3) scattered in a 4 x 2 x 4 box,
    widths and types seeded."""
    rs = np.random.RandomState(seed)
    base = rs.uniform([-2, 0, -2], [2, 1, 2], (n, 1, 3))
    cps = base + np.cumsum(rs.normal(scale=0.25, size=(n, 4, 3)), axis=1)
    w0 = rs.uniform(0.01, 0.06, n)
    w1 = rs.uniform(0.005, 0.03, n)
    types = rs.choice(["flat", "cylinder", "ribbon"], n)
    normals = rs.normal(size=(n, 2, 3))
    return cps.astype(np.float32), w0, w1, types, normals


def _build_pair(n_curves=60, seed=0, with_mesh=True):
    """The same triangles and curves through both builders (CPU)."""
    cps, w0, w1, types, normals = _seeded_curves(n_curves, seed)
    scenes = []
    for mod, spc_mod in ((jsc, jspc), (sc, spc)):
        b = mod.SceneBuilder()
        if with_mesh:
            m = b.materials.add_diffuse((0.5, 0.45, 0.4))
            b.add_mesh([[-3, 0, -3], [-3, 0, 3], [3, 0, 3], [3, 0, -3]],
                       [[0, 1, 2], [0, 2, 3]], m)
        hair = b.materials.add_hair(sigma_a=(0.3, 0.5, 1.7))
        for i in range(n_curves):
            nrm = tuple(normals[i]) if types[i] == "ribbon" else None
            b.add_curve(cps[i], w0[i], w1[i], hair, curve_type=types[i],
                        normals=nrm)
        b.add_uniform_infinite_light(spc_mod.PiecewiseLinearSpectrum(
            np.asarray([360.0, 830.0]), np.asarray([0.5, 0.5])))
        scenes.append(b)
    return scenes


@pytest.mark.parametrize("ctype", ["flat", "cylinder", "ribbon"])
def test_split_curve_rows_match_reference(ctype):
    rs = np.random.RandomState({"flat": 1, "cylinder": 2, "ribbon": 3}[ctype])
    cp = rs.normal(size=(4, 3)).astype(np.float32)
    kw = dict(ctype={"flat": 0, "cylinder": 1, "ribbon": 2}[ctype],
              curve_id=7)
    if ctype == "ribbon":
        kw.update(normal0=rs.normal(size=3), normal1=rs.normal(size=3))
    for depth in (0, 3):
        want = jcrv.split_curve(cp, 0.03, 0.011, depth, **kw)
        got = crv.split_curve(cp, 0.03, 0.011, depth, **kw)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def _aimed_rays(rows, rs):
    """One ray per row, from a seeded origin toward a point near the row's
    chord (some inside the width, some outside), with unnormalised
    directions."""
    n = len(rows)
    w = rs.uniform(0, 1, (n, 1))
    target = rows[:, 0:3] + w * (rows[:, 3:6] - rows[:, 0:3]) \
        + rs.normal(scale=0.02, size=(n, 3))
    o = target + rs.normal(size=(n, 3)) * 2.0
    d = (target - o) * rs.uniform(0.5, 2.0, (n, 1))
    return o.astype(np.float32), d.astype(np.float32)


def test_segment_test_matches_reference():
    rs = np.random.RandomState(4)
    cps, w0, w1, types, normals = _seeded_curves(64, 5)
    rows = np.concatenate([
        crv.split_curve(cps[i], w0[i], w1[i], 3,
                        ctype={"flat": 0, "cylinder": 1, "ribbon": 2}[t],
                        normal0=normals[i, 0], normal1=normals[i, 1],
                        curve_id=i)[0] for i, t in enumerate(types)])
    o, d = _aimed_rays(rows, rs)
    t_max = rs.uniform(0.5, 10.0, len(rows)).astype(np.float32)
    want = jcrv._segment_test(jnp.asarray(o), jnp.asarray(d),
                              jnp.asarray(t_max), jnp.asarray(rows))
    got = crv.segment_test(torch.as_tensor(o), torch.as_tensor(d),
                           torch.as_tensor(t_max), torch.as_tensor(rows))
    hit = np.asarray(want["hit"])
    print(f"segment_test: {hit.mean():.3f} of {len(rows)} rays hit")
    assert 0.2 < hit.mean() < 0.9
    np.testing.assert_array_equal(got["hit"].numpy(), hit)
    for k in ("t", "u", "v", "n"):
        a, b = got[k].numpy(), np.asarray(want[k])
        a, b = (a[hit], b[hit]) if k == "t" else (a, b)
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-5, err_msg=k)


def _patch_tables():
    """A fur patch of 96 strands (768 spans, 6,144 segments) through the
    port's parser, and the same text through the reference's."""
    text = hair_scene_text(96, 2, 8, 8, 1)
    return parser.parse_string(text, device="cpu").scene, \
        jparser.parse_string(text).scene


def _patch_rays(n, seed, segs=None):
    """Rays from the patch's box (+-0.2 around it): normally distributed
    directions, or, given segment rows, half of them aimed at seeded
    points of seeded segments (a fur patch is thin: few box rays hit)."""
    rs = np.random.RandomState(seed)
    o = rs.uniform([-1.4, -0.2, -1.4], [1.4, 1.2, 1.4], (n, 3))
    d = rs.normal(size=(n, 3))
    if segs is not None:
        segs = np.asarray(segs)
        r = segs[rs.randint(0, len(segs), n // 2)]
        w = rs.uniform(0, 1, (n // 2, 1))
        d[:n // 2] = r[:, 0:3] + w * (r[:, 3:6] - r[:, 0:3]) - o[:n // 2]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def test_traversal_matches_reference():
    sp, sj = _patch_tables()
    o, d = _patch_rays(2048, 8, sp.curve_segs)
    nodes, segs = sp.curve_nodes, sp.curve_segs
    far = np.full(len(o), 1e30, np.float32)
    want = jcrv.bvh_intersect_curves(sj.curve_nodes, sj.curve_segs,
                                     jnp.asarray(o), jnp.asarray(d),
                                     jnp.asarray(far))
    before = crv.counter.plain
    got = crv.intersect_curves(nodes, segs, torch.as_tensor(o),
                               torch.as_tensor(d), torch.as_tensor(far),
                               depth=sp.curve_depth)
    assert crv.counter.plain == before + 1 and crv.counter.launches == 0
    hit = np.asarray(want["hit"])
    print(f"curve traversal: {hit.mean():.3f} of {len(o)} rays hit, tree "
          f"depth {sp.curve_depth}, work {crv.counter.work}")
    assert 0.1 < hit.mean() < 0.9
    np.testing.assert_array_equal(got["hit"].numpy(), hit)
    np.testing.assert_array_equal(got["curve_id"].numpy(),
                                  np.asarray(want["curve_id"]))
    worst = {}
    for k, atol in (("t", 1e-5), ("u", 1e-5), ("v", 5e-3), ("n", 5e-3)):
        a, b = got[k].numpy()[hit], np.asarray(want[k])[hit]
        worst[k] = float(np.abs(a - b).max())
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=atol, err_msg=k)
    print(f"worst absolute difference: {worst}")
    # the re-test itself: the reference's _segment_test on the port's
    # winning rows gives the port's u, v, n bit for bit
    t, seg = crv.curves_intersect(nodes, segs, torch.as_tensor(o),
                                  torch.as_tensor(d), torch.as_tensor(far),
                                  depth=sp.curve_depth)
    rows = segs.numpy()[np.maximum(seg.numpy(), 0)]
    bound = np.where(seg.numpy() >= 0, t.numpy() * 1.0001 + 1e-5, 0.0)
    r = jcrv._segment_test(jnp.asarray(o), jnp.asarray(d),
                           jnp.asarray(bound.astype(np.float32)),
                           jnp.asarray(rows))
    for k in ("u", "v"):
        np.testing.assert_array_equal(got[k].numpy()[hit],
                                      np.asarray(r[k])[hit], err_msg=k)
    np.testing.assert_allclose(got["n"].numpy()[hit], np.asarray(r["n"])[hit],
                               rtol=0, atol=2.5e-7)
    t_sh = np.full(len(o), 0.7, np.float32)
    want_any = jcrv.bvh_intersect_curves(sj.curve_nodes, sj.curve_segs,
                                         jnp.asarray(o), jnp.asarray(d),
                                         jnp.asarray(t_sh), any_hit=True)
    t_any, seg_any = crv.curves_intersect(nodes, segs, torch.as_tensor(o),
                                          torch.as_tensor(d),
                                          torch.as_tensor(t_sh), True,
                                          depth=sp.curve_depth)
    hit_any = np.asarray(want_any["hit"])
    assert 0.05 < hit_any.mean() < 0.95
    np.testing.assert_array_equal(seg_any.numpy() >= 0, hit_any)
    assert np.all(t_any.numpy()[hit_any] < 0.7)


def test_depth_refusal(monkeypatch):
    """The wrapper refuses a tree deeper than its stack, and so does the
    builder (the reference's XLA traversal overruns its 40-entry stack
    instead)."""
    sp, _sj = _patch_tables()
    o, d = (torch.as_tensor(a) for a in _patch_rays(4, 1))
    with pytest.raises(ValueError, match="64-entry traversal stack"):
        crv.curves_intersect(sp.curve_nodes, sp.curve_segs, o, d, 1e30,
                             depth=crv.MAX_DEPTH + 1)
    monkeypatch.setattr(crv, "MAX_DEPTH", sp.curve_depth - 1)
    with pytest.raises(NotImplementedError, match="curve BVH is"):
        parser.parse_string(hair_scene_text(96, 2, 8, 8, 1), device="cpu")


def _compare_tables(sp, sj):
    assert sp.has_curves and sj.has_curves
    for name, want in (("curve_nodes", sj.curve_nodes),
                       ("curve_segs", sj.curve_segs),
                       ("tri_all", sj.tri_all),
                       ("mat_pool", sj.materials.packed),
                       ("lights_packed", sj.lights.packed),
                       ("spectra_pool", sj.spectra_pool)):
        a, b = np.asarray(want), getattr(sp, name).numpy()
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8),
                                      err_msg=name)
    np.testing.assert_array_equal(sp.curve_mats.numpy(),
                                  np.asarray(sj.curve_mats))
    assert sp.scene_radius == float(sj.scene_radius)
    assert sp.bxdf_tags == sj.materials.bxdf_tags_present
    assert sp.mega is None and sj.mega is None


SNIPPET = b'''
LookAt 0 1 4  0 0.5 0  0 1 0
Camera "perspective" "float fov" [40]
Film "rgb" "integer xresolution" [8] "integer yresolution" [8]
WorldBegin
LightSource "infinite" "rgb L" [0.4 0.4 0.4]
Material "hair" "rgb sigma_a" [0.8 1.9 3.1] "float beta_m" [0.2]
    "float beta_n" [0.5] "float eta" [1.6]
AttributeBegin
  Translate 0.1 0 0
  Scale 1 1.5 1
  Shape "curve" "point3 P" [0 0 0  0.2 0.3 0  0.1 0.6 0.1  0 0.9 0
      -0.1 1.2 0  0 1.4 0.1  0.2 1.5 0] "float width" [0.05]
      "string type" "ribbon" "normal N" [0 0 1  1 0 0]
AttributeEnd
Shape "curve" "point3 P" [0.5 0 0  0.6 0.2 0  0.5 0.4 0  0.6 0.6 0]
    "float width0" [0.04] "float width1" [0.01]
Material "diffuse"
Shape "curve" "point3 P" [-0.5 0 0  -0.6 0.2 0  -0.5 0.4 0  -0.6 0.6 0]
    "string type" "cylinder" "float width" [0.03]
'''


@pytest.mark.parametrize("text", [SNIPPET,
                                  hair_scene_text(24, 3, 8, 8, 1).encode()],
                         ids=["snippet", "hair_scene"])
def test_parsed_curve_tables_match_reference(text):
    sp = parser.parse_string(text, device="cpu").scene
    sj = jparser.parse_string(text).scene
    _compare_tables(sp, sj)


def test_builder_curve_tables_match_reference():
    jb, pb = _build_pair()
    _compare_tables(pb.build(device="cpu"), jb.build())


def test_convert_carries_the_curve_tables():
    text = hair_scene_text(24, 3, 8, 8, 1)
    dj = jparser.parse_string(text)
    arrays, meta = export(dj.scene, dj.camera, dj.sampler)
    scene, _cam, _smp = convert.from_jax_scene(arrays, meta, device="cpu")
    _compare_tables(scene, dj.scene)
    own = parser.parse_string(text, device="cpu").scene
    assert scene.curve_depth == own.curve_depth
    assert torch.equal(scene.curve_wide, own.curve_wide)


@pytest.mark.parametrize("shape", [
    b'Shape "curve" "point3 P" [0 0 0 1 0 0 1 1 0 0 1 1] "string basis" '
    b'"bspline"',
    b'Shape "curve" "point3 P" [0 0 0 1 0 0 1 1 0 0 1 1] "integer degree" '
    b'[2]',
    b'Shape "curve" "point3 P" [0 0 0 1 0 0 1 1 0]',
    b'AreaLightSource "diffuse" "rgb L" [1 1 1]\n'
    b'Shape "curve" "point3 P" [0 0 0 1 0 0 1 1 0 0 1 1]',
], ids=["bspline", "degree2", "three_points", "emissive"])
def test_curve_parse_errors_match_reference(shape):
    text = b"WorldBegin\n" + shape + b"\n"
    with pytest.raises(jparser.ParseError) as ej:
        jparser.parse_string(text)
    with pytest.raises(parser.ParseError) as ep:
        parser.parse_string(text, device="cpu")
    # the same line and message (the column of a bare string value differs
    # by its quote between the two tokenizers' offsets)
    loc_p, msg_p = str(ep.value).split(": ", 1)
    loc_j, msg_j = str(ej.value).split(": ", 1)
    assert msg_p == msg_j and loc_p.split(":")[1] == loc_j.split(":")[1]


@pytest.fixture(scope="module")
def mixed():
    """Triangles (a ground quad, a lamp) and curves through both builders:
    the reference's CPU route runs its XLA curve traversal."""
    text = hair_scene_text(48, 4, 16, 16, 1)
    return parser.parse_string(text, device="cpu"), \
        jparser.parse_string(text)


def _mixed_rays(desc, n=1024, seed=9):
    """Camera rays and rays from the patch box toward the ground and up."""
    rs = np.random.RandomState(seed)
    o1 = np.tile(np.asarray(desc.camera.c2w_m)[:3, 3], (n // 2, 1))
    tgt = rs.uniform([-1.2, 0, -1.2], [1.2, 0.8, 1.2], (n // 2, 3))
    o2, d2 = _patch_rays(n // 2, seed + 1, desc.scene.curve_segs)
    o = np.concatenate([o1, o2]).astype(np.float32)
    d = np.concatenate([tgt - o1, d2]).astype(np.float32)
    return o, d


def test_intersect_with_curves_matches_reference(mixed):
    dp, dj = mixed
    o, d = _mixed_rays(dp)
    far = np.full(len(o), 1e30, np.float32)
    want = jsc.intersect(dj.scene, jnp.asarray(o), jnp.asarray(d),
                         jnp.asarray(far))
    got = sc.intersect(dp.scene, torch.as_tensor(o), torch.as_tensor(d),
                       torch.as_tensor(far))
    hit = np.asarray(want["hit"])
    on_curve = hit & (np.asarray(want["prim"]) <= -1000000)
    print(f"{hit.mean():.3f} of {len(o)} rays hit, {on_curve.mean():.3f} on "
          "a curve")
    assert on_curve.mean() > 0.1 and (hit & ~on_curve).mean() > 0.1
    np.testing.assert_array_equal(got["hit"].numpy(), hit)
    for k in ("prim", "mat", "light"):
        np.testing.assert_array_equal(got[k].numpy()[hit],
                                      np.asarray(want[k])[hit], err_msg=k)
    for k in ("t", "p", "ng", "ns", "uv", "dpdu", "dpdv", "p_err"):
        a, b = got[k].numpy()[hit], np.asarray(want[k])[hit]
        # on a curve, v and the normals (ng, ns and so dpdv) within the
        # atol of test_traversal_matches_reference
        atol = np.full(a.shape, 1e-5)
        if k in ("ng", "ns", "dpdv"):
            atol[on_curve[hit]] = 5e-3
        elif k == "uv":
            atol[on_curve[hit], 1] = 5e-3
        assert np.all(np.abs(a - b) <= atol + RTOL * np.abs(b)), k
    t_sh = np.full(len(o), 0.9, np.float32)
    occl = sc.intersect_p(dp.scene, torch.as_tensor(o), torch.as_tensor(d),
                          torch.as_tensor(t_sh))
    occl_ref = jsc.intersect_p(dj.scene, jnp.asarray(o), jnp.asarray(d),
                               jnp.asarray(t_sh))
    assert 0.05 < float(np.asarray(occl_ref).mean()) < 0.95
    np.testing.assert_array_equal(occl.numpy(), np.asarray(occl_ref))


# ---------------------------------------------------------------------------
# The curve kernel's own node table (curves.wide_nodes) and its walk

def _curve_tables(which):
    if which == "patch":
        return _patch_tables()[0]
    if which == "seeded60":
        return _build_pair()[1].build(device="cpu")
    if which == "snippet":
        return parser.parse_string(SNIPPET, device="cpu").scene
    return parser.parse_string(hair_scene_text(24, 3, 8, 8, 1),
                               device="cpu").scene


@pytest.mark.parametrize("which", ["patch", "seeded60", "snippet", "hair24"])
def test_wide_nodes_match_the_rows_they_come_from(which):
    """Every interior node has one wide row; its child boxes, refs and axis
    are bit-equal to the reference-layout rows of its children (left: the
    next row, right: row roff); a leaf child's ref keeps roff and nprim;
    the rows are in the node table's own (depth-first) order."""
    s = _curve_tables(which)
    nodes = s.curve_nodes.numpy()
    wide = s.curve_wide.numpy()
    assert np.array_equal(wide, crv.wide_nodes(s.curve_nodes).numpy())
    roff = np.round(nodes[:, 6]).astype(np.int64)
    meta = np.round(nodes[:, 7]).astype(np.int64)
    nprim, axis = meta >> 2, meta & 3
    interior = np.flatnonzero(nprim == 0)
    assert wide.dtype == np.int32 and wide.shape == (len(interior),
                                                     crv.WIDE_COLS)
    assert len(interior) > 1 and nprim.max() <= crv.MAX_LEAF
    # walk the table from row 0 and recover the node each row stands for
    node_of = np.full(len(wide), -1, np.int64)
    node_of[0] = 0
    seen_leaves = 0
    for w in range(len(wide)):       # depth-first: parents come first
        i = node_of[w]
        assert i >= 0 and nprim[i] == 0
        assert wide[w, 14] == axis[i] and wide[w, 15] == 0
        for child, cols, ref in ((i + 1, slice(0, 6), wide[w, 12]),
                                 (roff[i], slice(6, 12), wide[w, 13])):
            np.testing.assert_array_equal(
                wide[w, cols], nodes[child, :6].view(np.int32))
            if nprim[child] == 0:
                assert ref > w and node_of[ref] == -1
                node_of[ref] = child
            else:
                assert ref < 0
                assert (~ref >> 3, ~ref & 7) == (roff[child], nprim[child])
                seen_leaves += 1
    assert sorted(node_of) == sorted(interior)
    assert seen_leaves == (nprim > 0).sum()
    # the table's order is the node table's
    np.testing.assert_array_equal(node_of, interior)
    # an interior left child is the next row
    left_interior = wide[:, 12] >= 0
    np.testing.assert_array_equal(wide[left_interior, 12],
                                  np.flatnonzero(left_interior) + 1)


def test_wide_nodes_of_a_single_leaf():
    nodes = torch.tensor([[0, 0, 0, 1, 1, 1, 0, 3 << 2]], dtype=torch.float32)
    assert crv.wide_nodes(nodes).shape == (0, crv.WIDE_COLS)


def _slab32(box, o, inv, t_best):
    """ops/bvh8._slab on one box, in float32, with the entry distance."""
    f = np.float32
    t0 = (box[0:3] - o) * inv
    t1 = (box[3:6] - o) * inv
    tmin = max(max(min(t0[0], t1[0]), min(t0[1], t1[1])),
               max(min(t0[2], t1[2]), f(0)))
    tmax = min(min(max(t0[0], t1[0]), max(t0[1], t1[1])),
               min(max(t0[2], t1[2]), t_best))
    return bool(tmin <= tmax * f(1.0000004)), f(tmin)


def _wide_walk(scene, o, d, t_max, any_hit):
    """The curve kernel's walk (csrc/curves.cu), one ray at a time in
    float32: the root's box from the node rows, then the wide table; a far
    child is pushed with its entry distance and tested again when popped
    (entry <= t_best * 1.0000004)."""
    f = np.float32
    nodes = scene.curve_nodes.numpy()
    wide = scene.curve_wide.numpy()
    boxes = wide[:, :12].copy().view(np.float32)
    segs = scene.curve_segs
    t_out = np.full(len(o), np.inf, np.float32)
    seg_out = np.full(len(o), -1, np.int32)
    root_nprim = int(round(float(nodes[0, 7]))) >> 2
    root = 0 if root_nprim == 0 else ~(int(round(float(nodes[0, 6]))) << 3
                                       | root_nprim)
    with np.errstate(all="ignore"):
        for r in range(len(o)):
            inv = f(1) / np.where(d[r] == 0, f(1e-20), d[r])
            t_best, seg, stack = f(t_max[r]), -1, []
            if not _slab32(nodes[0, :6], o[r], inv, t_best)[0]:
                continue
            cur = root
            while cur is not None:
                nxt = None
                if cur >= 0:
                    hl, tl = _slab32(boxes[cur, 0:6], o[r], inv, t_best)
                    hr, tr = _slab32(boxes[cur, 6:12], o[r], inv, t_best)
                    neg = d[r, wide[cur, 14]] < 0
                    near, far = ((wide[cur, 13], hr), (wide[cur, 12], hl, tl)) \
                        if neg else ((wide[cur, 12], hl), (wide[cur, 13], hr,
                                                           tr))
                    if near[1]:
                        if far[1]:
                            stack.append((int(far[0]), far[2]))
                        nxt = int(near[0])
                    elif far[1]:
                        nxt = int(far[0])
                else:
                    roff, m = ~cur >> 3, ~cur & 7
                    orr = torch.as_tensor(o[r:r + 1])
                    fr = crv._ray_frame(torch.as_tensor(d[r:r + 1]))
                    for k in range(m):
                        t, inside = crv._segment_core(
                            segs[roff + k:roff + k + 1], orr, *fr)[:2]
                        t = f(t.item())
                        if bool(inside) and t > f(crv.T_MIN) and t < t_best:
                            t_best, seg = t, roff + k
                            if any_hit:
                                break
                    if any_hit and seg >= 0:
                        break
                while nxt is None and stack:
                    ref, tmin = stack.pop()
                    if tmin <= t_best * f(1.0000004):
                        nxt = ref
                cur = nxt
            if seg >= 0:
                t_out[r], seg_out[r] = t_best, seg
    return t_out, seg_out


@pytest.mark.parametrize("any_hit", [False, True])
def test_wide_walk_matches_plain(any_hit):
    """The kernel's walk over the wide table gives the plain version's t
    and segment bit for bit, closest and any hit."""
    s = _patch_tables()[0]
    o, d = _patch_rays(384, 21, s.curve_segs)
    t_max = np.full(len(o), 2.0 if any_hit else 1e30, np.float32)
    t_p, seg_p = crv.curves_intersect_plain(
        s.curve_nodes, s.curve_segs, torch.as_tensor(o), torch.as_tensor(d),
        torch.as_tensor(t_max), any_hit)
    t_w, seg_w = _wide_walk(s, o, d, t_max, any_hit)
    assert 0.1 < (seg_p.numpy() >= 0).mean() < 0.9
    np.testing.assert_array_equal(seg_w, seg_p.numpy())
    np.testing.assert_array_equal(t_w.view(np.uint32),
                                  t_p.numpy().view(np.uint32))
