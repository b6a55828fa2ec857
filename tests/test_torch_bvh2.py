"""Port vs reference: the plain versions of the binary BVH kernels.

Single level (the kernel of pbrt_tpu/ops/pallas_bvh.py::_bvh_kernel):
`bvh2_intersect_plain` against the reference's `traverse_reference` (the
same traversal body as its Pallas kernel, in jnp) on seeded triangle
soups, over the reference's own trees (`bvh.build_bvh`,
`pad_tris_for_bvh`). Closest hit: hit equal, t within rtol 1e-6, prim
equal except where two prims tie in t (the reference pushes children by
its ray block's majority direction, the port by each ray's own). Any hit:
hit equal, t below t_max.

Two levels (_bvh2_kernel): `two_level_plain` on the 25-cube scene of
tests/test_pallas_bvh2.py at 400 rays, against `two_level_reference`
(hit equal; prim and inst equal where hit; t within rtol 1e-6) and
against the per-lane XLA traversal `tlas.two_level_intersect`, whose
triangle test differs from the kernel's (t within rtol 2e-4, as that file
holds it).
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from pbrt_tpu import scene_core as jsc  # noqa: E402
from pbrt_tpu.ops import bvh as jbvh  # noqa: E402
from pbrt_tpu.ops import pallas_bvh as pbvh  # noqa: E402
from pbrt_tpu.ops import tlas as jtlas  # noqa: E402
from pbrt_tpu.utils import spectrum as jspc  # noqa: E402
from pbrt_tpu.utils import transform as jtfm  # noqa: E402
from pbrt_tpu_torch import scene_core as sc  # noqa: E402
from pbrt_tpu_torch.ops import bvh as bvh_mod  # noqa: E402
from pbrt_tpu_torch.ops import bvh2  # noqa: E402
from pbrt_tpu_torch.ops import tlas  # noqa: E402
from pbrt_tpu_torch.utils import spectrum as spc  # noqa: E402
from pbrt_tpu_torch.utils import transform as tfm  # noqa: E402

torch.set_num_threads(1)


def _soup(T, seed):
    rs = np.random.RandomState(seed)
    c = rs.uniform(-5, 5, (T, 3))
    return [(c + rs.normal(0, 0.5, (T, 3))).astype(np.float32)
            for _ in range(3)]


def _rays(n, seed, lo=-7.0, hi=7.0):
    rs = np.random.RandomState(seed)
    o = rs.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d, rs.uniform(0, 10, n).astype(np.float32)


@pytest.fixture(scope="module", params=[(300, 0), (600, 1)],
                ids=["soup300", "soup600"])
def soup(request):
    T, seed = request.param
    p0, p1, p2 = _soup(T, seed)
    lo = np.minimum(np.minimum(p0, p1), p2)
    hi = np.maximum(np.maximum(p0, p1), p2)
    b = jbvh.build_bvh(lo, hi)
    rows = np.asarray(jbvh.pack_tri_geo(p0, p1, p2,
                                        order=np.asarray(b.prim_indices)))
    o, d, t_any = _rays(512, seed + 3)
    return dict(nodes=np.asarray(b.nodes), rows=rows, o=o, d=d, t_any=t_any,
                depth=bvh_mod.bvh_max_depth(b.nodes))


@pytest.mark.parametrize("any_hit", [False, True])
def test_single_level_plain_matches_reference(soup, any_hit):
    o, d = soup["o"], soup["d"]
    t_max = soup["t_any"] if any_hit else np.full(len(o), 1e30, np.float32)
    want = pbvh.traverse_reference(
        jnp.asarray(soup["nodes"]), pbvh.pad_tris_for_bvh(soup["rows"]),
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max), any_hit=any_hit)
    want = {k: np.asarray(v) for k, v in want.items()}
    before = bvh2.counter_bvh2.plain
    got = bvh2.bvh2_intersect(torch.as_tensor(soup["nodes"]),
                              torch.as_tensor(soup["rows"]),
                              torch.as_tensor(o), torch.as_tensor(d),
                              torch.as_tensor(t_max), any_hit,
                              depth=soup["depth"])
    assert bvh2.counter_bvh2.plain == before + 1
    assert bvh2.counter_bvh2.work["node_visits"] > 0
    got = {k: v.numpy() for k, v in got.items()}
    hit = want["hit"]
    print(f"any_hit={any_hit}: {hit.mean():.3f} of {len(o)} rays hit")
    assert 0.05 < hit.mean() < 0.95
    np.testing.assert_array_equal(got["hit"], hit)
    assert np.all(got["t"][hit] < t_max[hit])
    assert np.all(np.isinf(got["t"][~hit])) and np.all(got["prim"][~hit] ==
                                                       -1)
    if not any_hit:
        np.testing.assert_allclose(got["t"][hit], want["t"][hit], rtol=1e-6)
        differ = got["prim"] != want["prim"]
        np.testing.assert_allclose(got["t"][differ], want["t"][differ],
                                   rtol=1e-6)
        # XLA on the CPU rounds the barycentrics' products a few ulp apart
        np.testing.assert_allclose(got["b1"][~differ], want["b1"][~differ],
                                   rtol=1e-4, atol=1e-5)


def _cube_scene(builder, spectrum, transform):
    """The 25-cube scene of tests/test_pallas_bvh2.py in either package."""
    b = builder()
    m = b.materials.add_diffuse((0.7, 0.3, 0.3))
    mg = b.materials.add_diffuse((0.5,) * 3)
    b.add_mesh([[-10, -1, -10], [10, -1, -10], [10, -1, 10], [-10, -1, 10]],
               [[0, 1, 2], [0, 2, 3]], mg)
    s_ = 0.5
    V = np.asarray([[-s_, -s_, -s_], [s_, -s_, -s_], [s_, s_, -s_],
                    [-s_, s_, -s_], [-s_, -s_, s_], [s_, -s_, s_],
                    [s_, s_, s_], [-s_, s_, s_]], np.float32)
    F = np.asarray([[0, 1, 2], [0, 2, 3], [4, 6, 5], [4, 7, 6],
                    [0, 4, 5], [0, 5, 1], [3, 2, 6], [3, 6, 7],
                    [0, 3, 7], [0, 7, 4], [1, 5, 6], [1, 6, 2]])
    proto = b.new_prototype()
    b.add_proto_mesh(proto, V, F, m)
    for gx in range(-2, 3):
        for gz in range(-2, 3):
            b.add_instance(proto, transform.translate((gx * 2.0, 0, gz * 2.0))
                           @ transform.rotate(15 * gx, (0, 1, 0)))
    b.add_uniform_infinite_light(spectrum.PiecewiseLinearSpectrum(
        np.asarray([360.0, 830.0]), np.asarray([1.0, 1.0])))
    return b


@pytest.fixture(scope="module")
def cubes():
    sj = _cube_scene(jsc.SceneBuilder, jspc, jtfm).build(force_bvh=False)
    sp = _cube_scene(sc.SceneBuilder, spc, tfm).build(device="cpu")
    return sj, sp


def test_cube_scene_tables_match_reference(cubes):
    sj, sp = cubes
    for name in ("tlas_nodes", "inst_rows", "tri_geo_tlas", "tri_all"):
        a, b = np.asarray(getattr(sj, name)), getattr(sp, name).numpy()
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8),
                                      err_msg=name)
    assert sp.tlas_root == sj.tlas_root and sp.has_instances
    assert sp.tlas_depth == tlas.stack_depth(np.asarray(sj.tlas_nodes),
                                             np.asarray(sj.inst_rows),
                                             sj.tlas_root)
    assert sp.tlas_depth <= bvh2.MAX_DEPTH_TWO_LEVEL


def _cube_rays(n=400, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("ref", ["two_level_reference", "xla"])
def test_two_level_plain_matches_reference(cubes, ref, any_hit):
    sj, sp = cubes
    o, d = _cube_rays()
    t_max = np.full(len(o), 1e30, np.float32)
    args = (jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max))
    if ref == "xla":
        want = jtlas.two_level_intersect(sj.tlas_nodes, sj.inst_rows,
                                         sj.tri_geo_tlas, sj.tlas_root,
                                         *args, any_hit=any_hit)
        rtol = 2e-4
    else:
        want = pbvh.two_level_reference(
            sj.tlas_nodes, sj.inst_rows,
            pbvh.pad_tris_for_bvh(np.asarray(sj.tri_geo_tlas)),
            sj.tlas_root, *args, any_hit=any_hit)
        rtol = 1e-6
    want = {k: np.asarray(v) for k, v in want.items()}
    before = bvh2.counter_two_level.plain
    rays = (torch.as_tensor(a) for a in (o, d, t_max))
    got = bvh2.two_level_intersect(sp.tlas_nodes, sp.inst_rows,
                                   sp.tri_geo_tlas, sp.tlas_root, *rays,
                                   any_hit, depth=sp.tlas_depth)
    assert bvh2.counter_two_level.plain == before + 1
    got = {k: v.numpy() for k, v in got.items()}
    hit = want["hit"]
    print(f"{ref}, any_hit={any_hit}: {hit.mean():.3f} of {len(o)} rays "
          f"hit; plain-version work {bvh2.counter_two_level.work}")
    assert 0.05 < hit.mean() < 0.95
    np.testing.assert_array_equal(got["hit"], hit)
    assert np.all(got["inst"][~hit] == -1)
    if not any_hit:
        for k in ("prim", "inst"):
            np.testing.assert_array_equal(got[k][hit], want[k][hit],
                                          err_msg=k)
        np.testing.assert_allclose(got["t"][hit], want["t"][hit], rtol=rtol)
        np.testing.assert_allclose(got["b1"][hit], want["b1"][hit],
                                   rtol=1e-3, atol=1e-4)


def test_wrappers_check_depth_shapes_and_broadcast_t_max(cubes):
    _sj, sp = cubes
    o, d = (torch.as_tensor(a) for a in _cube_rays(64, seed=5))
    tables = (sp.tlas_nodes, sp.inst_rows, sp.tri_geo_tlas, sp.tlas_root)
    a = bvh2.two_level_intersect(*tables, o, d, 3.0, True,
                                 depth=sp.tlas_depth)
    b = bvh2.two_level_intersect(*tables, o, d, torch.full((64,), 3.0), True,
                                 depth=sp.tlas_depth)
    assert torch.equal(a["prim"], b["prim"]) and torch.equal(a["t"], b["t"])
    assert bool((a["t"][a["hit"]] < 3.0).all())
    dead = bvh2.two_level_intersect(*tables, o, d, -1.0, depth=sp.tlas_depth)
    assert not bool(dead["hit"].any())
    with pytest.raises(ValueError, match="stack"):
        bvh2.two_level_intersect(*tables, o, d, 1.0,
                                 depth=bvh2.MAX_DEPTH_TWO_LEVEL + 1)
    with pytest.raises(ValueError, match="stack"):
        bvh2.bvh2_intersect(sp.tlas_nodes, sp.tri_geo_tlas, o, d, 1.0,
                            depth=bvh2.MAX_DEPTH + 1)
    with pytest.raises(ValueError, match=r"\(N, 3\)"):
        bvh2.two_level_intersect(*tables, o[:, :2], d, 1.0,
                                 depth=sp.tlas_depth)
