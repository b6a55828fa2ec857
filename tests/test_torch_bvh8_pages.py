"""Port vs reference: the paged big-mesh BVH8 traversal (forest and binned).

Builders: `build_bvh8_chunked` and `build_bvh8_forest` give the reference's
tables array for array, at the same explicit budgets, on a seeded soup
(tools/exp_binned.py `rand_scene`) and on a 20,000-triangle terrain
(tools/terrain_rays.py, the copy of tools/exp_1m.py's); the subtree ranges
come from the native sweep where the reference's forest loops in Python.

Traversals: the plain versions (what the wrappers run on CPU tensors)
against the reference's kernels in Pallas interpret mode, on 1,024 rays
aimed at triangle centroids over 300 triangles in K >= 4 pages, with two
pages per round so that the rounds loop runs more than once. Closest hit:
the hit flag equal on every ray; the triangle equal on every ray but exact
t ties, which are counted and printed, and where it differs the
reference's triangle, re-tested by the port's triangle test on the same
ray, gives the port's t bit for bit; where the triangle is equal, t within
rtol 1e-5 of the reference's, because XLA's CPU code contracts multiplies
and adds into FMAs in the triangle test and torch (like the card's
-fmad=false kernels) does not. The test shows that cause: both sides lie
within 3e-5 of the float64 t of the same float32 rows (on these rays at
most 1.7e-5 for the reference and 2.4e-5 for the port, on grazing hits;
the two differ by at most 7.7e-6). Any hit: the hit flag equal on every
ray. Against the port's own whole-tree BVH8 plain version, which rounds
the same way, t is bit-equal where the triangle is equal.
"""
import dataclasses
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from pbrt_tpu.ops import bvh as jbvh  # noqa: E402
from pbrt_tpu.ops import pallas_bvh8 as jb8  # noqa: E402
from pbrt_tpu_torch import native  # noqa: E402
from pbrt_tpu_torch.ops import bvh as bvh_mod  # noqa: E402
from pbrt_tpu_torch.ops import bvh8  # noqa: E402
from pbrt_tpu_torch.ops import bvh8_pages as bp  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
import exp_1m  # noqa: E402
import terrain_rays  # noqa: E402
from exp_binned import rand_scene  # noqa: E402

torch.set_num_threads(1)
N_RAYS = 1024
BUDGET = 8 * 1024
PER_ROUND = 2


def _tables_equal(want, got, names):
    for name in names:
        a, b = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8),
                                      err_msg=name)


SCENES = {"soup3000": lambda: rand_scene(3000, seed=3000),
          "terrain101": lambda: terrain_rays.terrain_triangles(101)}


def test_subtree_ranges_match_reference_loop():
    lo, hi, _tri = SCENES["soup3000"]()
    nb = bvh_mod.build_bvh(lo, hi).nodes
    roff = np.round(nb[:, 6]).astype(np.int64)
    nprim = np.round(nb[:, 7]).astype(np.int64) >> 2
    start = np.zeros(len(nb), np.int64)
    count = np.zeros(len(nb), np.int64)
    for i in range(len(nb) - 1, -1, -1):     # pallas_bvh8.py:535-542
        if nprim[i] > 0:
            start[i], count[i] = roff[i], nprim[i]
        else:
            l, r = i + 1, roff[i]
            start[i] = min(start[l], start[r])
            count[i] = count[l] + count[r]
    got = native.subtree_ranges(nb)
    np.testing.assert_array_equal(got[0], start)
    np.testing.assert_array_equal(got[1], count)


def test_chunk_collapse_from_its_subtree_matches_collapse_from_root():
    """The builders collapse each chunk from a copy of its subtree; that
    gives the rows of the native collapse run from the chunk's root on the
    whole tree, and of the reference's collapse."""
    lo, hi, _tri = SCENES["terrain101"]()
    nb = np.ascontiguousarray(bvh_mod.build_bvh(lo, hi).nodes)
    roots, start, _count, _, _ = bvh8.partition_chunk_roots(nb, 16 * 1024)
    assert len(roots) > 8
    for s in roots[::len(roots) // 8]:
        got = bvh8._collapse_chunk(nb, s, int(start[s]), bvh8.MAX_LEAF)
        want = native.collapse_bvh8(nb, bvh8.MAX_LEAF, root=s,
                                    prim_base=int(start[s]))
        ref = jb8.collapse_to_bvh8(nb, bvh8.MAX_LEAF, root=s,
                                   prim_base=int(start[s]))
        assert got[1] == want[1] == ref[1]
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[0], np.asarray(ref[0]))


@pytest.mark.parametrize("scene,budget", [("soup3000", 64 * 1024),
                                          ("soup3000", 16 * 1024),
                                          ("terrain101", 64 * 1024)])
def test_chunked_build_matches_reference(scene, budget):
    lo, hi, tri = SCENES[scene]()
    want = jb8.build_bvh8_chunked(lo, hi, tri, budget=budget)
    got = bvh8.build_bvh8_chunked(lo, hi, tri, budget=budget, device="cpu")
    assert got.n_chunks == want.n_chunks > 1
    assert (got.n_tris, got.depth) == (want.n_tris, want.depth)
    _tables_equal(want, got, ("nodes_f", "nodes_q", "tris", "page_start",
                              "prim_indices"))
    assert got.page_bytes <= budget


@pytest.mark.parametrize("scene,budget", [("soup3000", 64 * 1024),
                                          ("soup3000", 32 * 1024),
                                          ("terrain101", 64 * 1024)])
def test_forest_build_matches_reference(scene, budget):
    lo, hi, tri = SCENES[scene]()
    want = jb8.build_bvh8_forest(lo, hi, tri, page_budget=budget)
    got = bvh8.build_bvh8_forest(lo, hi, tri, page_budget=budget,
                                 device="cpu")
    assert got.n_chunks == want.n_chunks > 1
    assert (got.rows, got.n_tris, got.depth) == \
        (want.rows, want.n_tris, want.depth)
    _tables_equal(want, got, ("meta", "pages", "prim_indices"))
    np.testing.assert_array_equal(
        bvh8.pack_tris_flat10(tri), np.asarray(jb8.pack_tris_flat10(tri)))


def test_default_budgets_fit_a_block():
    """At the defaults, both builds' pages fit one block's shared memory."""
    lo, hi, tri = SCENES["terrain101"]()
    c = bvh8.build_bvh8_chunked(lo, hi, tri, device="cpu")
    f = bvh8.build_bvh8_forest(lo, hi, tri, device="cpu")
    assert c.page_bytes <= bvh8.SMEM_BYTES and f.page_bytes <= bvh8.SMEM_BYTES
    assert c.n_chunks > 1 and f.n_chunks > 1


def test_terrain_rays_match_exp_1m():
    V, F = terrain_rays.make_terrain(64)
    Vr, Fr = exp_1m.make_terrain(64)
    np.testing.assert_array_equal(V, Vr)
    np.testing.assert_array_equal(F, Fr)
    for kind in ("raster", "camera", "bounce"):
        for a, b in zip(terrain_rays.gen_rays(V, kind, 4096),
                        exp_1m.gen_rays(Vr, kind, 4096)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def paged():
    """300 seeded triangles in K >= 4 pages of both kinds, and 1,024 rays
    aimed at triangle centroids."""
    lo, hi, tri = rand_scene(300, seed=300)
    rng = np.random.default_rng(3)
    ctr = (tri[:, 0:3] + tri[:, 3:6] + tri[:, 6:9]) / 3
    o = (rng.random((N_RAYS, 3)) * 12 - 1).astype(np.float32)
    d = ctr[rng.integers(0, len(tri), N_RAYS)] - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    f = bvh8.build_bvh8_forest(lo, hi, tri, page_budget=BUDGET, device="cpu")
    c = bvh8.build_bvh8_chunked(lo, hi, tri, budget=BUDGET, device="cpu")
    assert f.n_chunks >= 4 and c.n_chunks >= 4
    return dict(lo=lo, hi=hi, tri=tri, o=o, d=d, f=f, c=c,
                jf=jb8.build_bvh8_forest(lo, hi, tri, page_budget=BUDGET),
                jc=jb8.build_bvh8_chunked(lo, hi, tri, budget=BUDGET))


def _t_max(any_hit):
    return np.full(N_RAYS, 8.0 if any_hit else 1e30, np.float32)


def _t64(tri, o, d):
    """Moeller-Trumbore t in float64 on the float32 rows [p0, e1, e2] the
    tables hold: the t that both float32 triangle tests round."""
    r = bvh8.pack_tris_flat(tri).reshape(-1, 9).astype(np.float64)
    p0, e1, e2 = r[:, 0:3], r[:, 3:6], r[:, 6:9]
    o, d = o.astype(np.float64), d.astype(np.float64)
    pv = np.cross(d, e2)
    tv = o - p0
    return np.einsum("ij,ij->i", e2, np.cross(tv, e1)) / \
        np.einsum("ij,ij->i", e1, pv)


def _hold_to_reference(got, want, any_hit, label, paged):
    """Closest hit: the triangle and t against the reference's, t against
    the float64 t of the reference's triangle, and every differing
    triangle an exact tie for the port's own triangle test."""
    got = {k: v.numpy() for k, v in got.items() if torch.is_tensor(v)}
    want = {k: np.asarray(v) for k, v in want.items()}
    hit = want["hit"]
    print(f"[{label}] any_hit={any_hit}: {hit.mean():.3f} of {N_RAYS} rays "
          "hit")
    np.testing.assert_array_equal(got["hit"], hit)
    assert np.all(np.isinf(got["t"][~hit])) and np.all(got["prim"][~hit] ==
                                                       -1)
    if any_hit:
        return
    same = hit & (got["prim"] == want["prim"])
    ties = hit & ~same
    # the cause of the t differences: XLA's CPU code contracts multiplies
    # and adds into FMAs, torch does not; both round the same float64 t
    t64 = _t64(paged["tri"][want["prim"][same]], paged["o"][same],
               paged["d"][same])
    dev_ref = np.abs(want["t"][same] - t64) / t64
    dev_got = np.abs(got["t"][same] - t64) / t64
    bit = (got["t"] == want["t"])[same].mean()
    print(f"[{label}] triangle equal on {same.sum()} of {hit.sum()} hits, "
          f"{int(ties.sum())} exact-t ties; t bit-equal on {bit:.3f} of the "
          f"equal ones; relative to the float64 t: reference "
          f"{dev_ref.max():.3g}, port {dev_got.max():.3g}")
    assert dev_ref.max() <= 3e-5 and dev_got.max() <= 3e-5
    np.testing.assert_allclose(got["t"][same], want["t"][same], rtol=1e-5)
    # a differing triangle is a tie: the reference's triangle, re-tested
    # with the port's own test on the same ray, gives the port's t exactly
    if ties.any():
        rows = torch.as_tensor(bvh8.pack_tris_flat(
            paged["tri"][want["prim"][ties]]).reshape(-1, 9))
        t, _u, _v, valid = bvh8._tri_test(
            rows, torch.as_tensor(paged["o"][ties]),
            torch.as_tensor(paged["d"][ties]))
        assert bool(valid.all())
        np.testing.assert_array_equal(t.numpy(), got["t"][ties])


@pytest.mark.parametrize("any_hit", [False, True])
def test_forest_plain_matches_reference(paged, any_hit):
    o, d, t_max = paged["o"], paged["d"], _t_max(any_hit)
    want = jb8.forest_intersect(paged["jf"], jnp.asarray(o), jnp.asarray(d),
                                jnp.asarray(t_max), any_hit=any_hit,
                                interpret=True)
    before = (bp.counter_forest.plain, bp.counter_forest.launches)
    got = bp.forest_intersect(paged["f"], torch.as_tensor(o),
                              torch.as_tensor(d), torch.as_tensor(t_max),
                              any_hit)
    assert (bp.counter_forest.plain, bp.counter_forest.launches) == \
        (before[0] + 1, before[1])
    assert bp.counter_forest.work["root_tests"] > 0
    _hold_to_reference(got, want, any_hit, "forest", paged)


@pytest.mark.parametrize("any_hit", [False, True])
def test_binned_plain_matches_reference(paged, any_hit):
    o, d, t_max = paged["o"], paged["d"], _t_max(any_hit)
    want = jb8.binned_intersect(paged["jc"], jnp.asarray(o), jnp.asarray(d),
                                jnp.asarray(t_max), any_hit=any_hit,
                                interpret=True, pages_per_round=PER_ROUND)
    before = (bp.counter_binned.plain, bp.counter_binned.launches)
    got = bp.binned_intersect(paged["c"], torch.as_tensor(o),
                              torch.as_tensor(d), torch.as_tensor(t_max),
                              any_hit, pages_per_round=PER_ROUND)
    assert (bp.counter_binned.plain, bp.counter_binned.launches) == \
        (before[0] + 1, before[1])
    print(f"[binned] {got['rounds']} rounds of {PER_ROUND} pages over "
          f"{paged['c'].n_chunks} pages")
    assert got["rounds"] > 1
    _hold_to_reference(got, want, any_hit, "binned", paged)


def test_page_entries_and_schedule_match_reference(paged):
    """The pre-pass and the first round's schedule, array for array."""
    o, d = paged["o"], paged["d"]
    te = np.full(N_RAYS, 1e30, np.float32)
    want = np.asarray(jb8._page_entries(
        paged["jc"], jnp.asarray(o), jnp.asarray(d), jnp.asarray(te),
        N_RAYS // bp.BLOCK, bp.BLOCK))
    got = bp.page_entries(paged["c"], torch.as_tensor(o), torch.as_tensor(d),
                          torch.as_tensor(te))
    np.testing.assert_array_equal(got.numpy(), want)
    served = torch.zeros(got.shape, dtype=torch.bool)
    sched, valid = bp.schedule(got, served, PER_ROUND)
    idx = np.argsort(want, axis=1, kind="stable")[:, :PER_ROUND]
    np.testing.assert_array_equal(sched.numpy(), idx)
    np.testing.assert_array_equal(valid.numpy().astype(bool),
                                  np.take_along_axis(want, idx, 1) < bp.BIG)
    assert int(served.sum()) == int(valid.sum())


@pytest.mark.parametrize("any_hit", [False, True])
def test_paged_plain_versions_match_whole_tree(paged, any_hit):
    """Forest and binned against the port's whole-tree BVH8 plain version
    on the same rays and triangles, which rounds the same way: hit equal,
    t bit-equal where the triangle is equal, the triangle equal but for
    exact t ties (closest hit)."""
    o, d = torch.as_tensor(paged["o"]), torch.as_tensor(paged["d"])
    t_max = torch.as_tensor(_t_max(any_hit))
    whole = bvh8.bvh8_intersect(
        bvh8.build_bvh8(paged["lo"], paged["hi"], paged["tri"],
                        device="cpu"), o, d, t_max, any_hit)
    for got in (bp.forest_intersect(paged["f"], o, d, t_max, any_hit),
                bp.binned_intersect(paged["c"], o, d, t_max, any_hit,
                                    pages_per_round=PER_ROUND)):
        assert torch.equal(got["hit"], whole["hit"])
        if any_hit:
            continue
        same = got["prim"] == whole["prim"]
        assert torch.equal(got["t"][same], whole["t"][same])
        assert torch.equal(got["t"][~same], whole["t"][~same])  # ties
        assert int((~same).sum()) <= 0.01 * N_RAYS


def test_wrappers_refuse_pages_past_shared_memory_and_f32_ids(paged):
    o, d = torch.as_tensor(paged["o"][:8]), torch.as_tensor(paged["d"][:8])
    lo, hi, tri = paged["lo"], paged["hi"], paged["tri"]
    big_f = bvh8.build_bvh8_forest(lo, hi, tri, page_budget=1 << 20,
                                   device="cpu")
    big_c = bvh8.build_bvh8_chunked(lo, hi, tri, budget=1 << 20,
                                    device="cpu")
    pad = (bvh8.SMEM_BYTES // 4 // bvh8.LANES + 1) * bvh8.LANES
    big_f = dataclasses.replace(big_f, pages=torch.zeros(
        (big_f.n_chunks, pad // bvh8.LANES, bvh8.LANES)),
        rows=pad // bvh8.LANES)
    big_c = dataclasses.replace(big_c, tris=torch.zeros(
        (big_c.n_chunks, pad)))
    with pytest.raises(ValueError, match="shared memory"):
        bp.forest_intersect(big_f, o, d, 1e30)
    with pytest.raises(ValueError, match="shared memory"):
        bp.binned_intersect(big_c, o, d, 1e30)
    with pytest.raises(ValueError, match="exact up to"):
        bp.forest_intersect(dataclasses.replace(paged["f"],
                                                n_tris=(1 << 24) + 1),
                            o, d, 1e30)
    with pytest.raises(ValueError, match=r"\(N, 3\)"):
        bp.binned_intersect(paged["c"], o[:, :2], d, 1e30)


def test_paged_builders_default_to_the_card(paged):
    assert not torch.cuda.is_available()
    for build in (bvh8.build_bvh8_forest, bvh8.build_bvh8_chunked):
        with pytest.raises(RuntimeError, match="cuda"):
            build(paged["lo"], paged["hi"], paged["tri"])


def test_binary_build_matches_reference(paged):
    """The paged builds start from the same binary SAH tree as the
    reference's."""
    b = bvh_mod.build_bvh(paged["lo"], paged["hi"])
    jb = jbvh.build_bvh(paged["lo"], paged["hi"])
    np.testing.assert_array_equal(b.nodes, np.asarray(jb.nodes))
    np.testing.assert_array_equal(b.prim_indices,
                                  np.asarray(jb.prim_indices))
