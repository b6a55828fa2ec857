"""Port vs reference: the BVH8 host build and the plain BVH8 traversal.

The port's build (native SAH + native collapse + quantisation, numpy) must
give the reference's tables bit for bit. The plain traversal is held to
the reference's Pallas kernel run in interpret mode: closest hit -> hit
equal, t within rtol 1e-6 (the interpreter's XLA arithmetic and torch's
round a few products differently), prim equal except where two prims tie
in t; any hit -> hit equal (which prim an any-hit query reports depends on
the traversal order: per ray in the port, per ray block in the reference).
Closest hits are also held to a brute-force scan of the same triangles.
The port's copies of the native builder's sources are held byte for byte
to the reference's.
"""
import os
import shutil
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
from pbrt_tpu_torch.ops import tri_intersect as ti  # noqa: E402
from pbrt_tpu_torch.scene import parser  # noqa: E402

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent


def _soup(T, seed=0):
    rs = np.random.RandomState(seed)
    c = rs.uniform(-5, 5, (T, 3))
    return [(c + rs.normal(0, 0.5, (T, 3))).astype(np.float32)
            for _ in range(3)]


def _meshfield():
    tri = parser.parse_file(ROOT / "scenes" / "meshfield.pbrt",
                             device="cpu").scene \
        .tri_all.numpy()
    return [tri[:, 0:3], tri[:, 3:6], tri[:, 6:9]]


def _boxes(p0, p1, p2):
    return (np.minimum(np.minimum(p0, p1), p2),
            np.maximum(np.maximum(p0, p1), p2))


@pytest.mark.parametrize("tris", ["soup600", "soup4000", "meshfield"])
def test_build_matches_reference(tris):
    p0, p1, p2 = {"soup600": lambda: _soup(600),
                  "soup4000": lambda: _soup(4000, seed=1),
                  "meshfield": _meshfield}[tris]()
    lo, hi = _boxes(p0, p1, p2)
    tg = bvh_mod.pack_tri_geo(p0, p1, p2)
    np.testing.assert_array_equal(tg, np.asarray(jbvh.pack_tri_geo(p0, p1,
                                                                   p2)))
    want = jb8.build_bvh8(lo, hi, tg)
    got = bvh8.build_bvh8(lo, hi, tg, device="cpu")
    for name in ("nodes_f", "nodes_q", "tris", "prim_indices"):
        a, b = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8),
                                      err_msg=name)
    assert (got.n_nodes, got.n_tris, got.depth) == \
        (want.n_nodes, want.n_tris, want.depth)
    assert got.depth * 7 + 1 <= bvh8.STACK
    b = bvh_mod.build_bvh(lo, hi)
    assert bvh_mod.bvh_max_depth(b.nodes) == \
        jbvh.bvh_max_depth(jbvh.build_bvh(lo, hi).nodes)


@pytest.fixture(scope="module")
def soup():
    p0, p1, p2 = _soup(600)
    lo, hi = _boxes(p0, p1, p2)
    tg = bvh_mod.pack_tri_geo(p0, p1, p2)
    rs = np.random.RandomState(3)
    n = 512
    o = rs.uniform(-7, 7, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return dict(p=(p0, p1, p2), j=jb8.build_bvh8(lo, hi, tg),
                t=bvh8.build_bvh8(lo, hi, tg, device="cpu"), o=o, d=d,
                t_any=rs.uniform(0, 10, n).astype(np.float32))


@pytest.mark.parametrize("any_hit", [False, True])
def test_plain_traversal_matches_reference(soup, any_hit):
    o, d = soup["o"], soup["d"]
    t_max = soup["t_any"] if any_hit else np.full(len(o), 1e30, np.float32)
    want = jb8.bvh8_intersect(soup["j"], jnp.asarray(o), jnp.asarray(d),
                              jnp.asarray(t_max), any_hit=any_hit,
                              interpret=True)
    want = {k: np.asarray(v) for k, v in want.items()}
    before = bvh8.counter.plain
    got = bvh8.bvh8_intersect(soup["t"], torch.as_tensor(o),
                              torch.as_tensor(d), torch.as_tensor(t_max),
                              any_hit=any_hit)
    assert bvh8.counter.plain == before + 1
    got = {k: v.numpy() for k, v in got.items()}
    hit = want["hit"]
    print(f"any_hit={any_hit}: {hit.mean():.3f} of {len(o)} rays hit")
    np.testing.assert_array_equal(got["hit"], hit)
    assert np.all(got["t"][hit] < t_max[hit])
    assert np.all(np.isinf(got["t"][~hit])) and np.all(got["prim"][~hit] ==
                                                       -1)
    if not any_hit:
        np.testing.assert_allclose(got["t"][hit], want["t"][hit], rtol=1e-6)
        differ = got["prim"] != want["prim"]
        # a differing prim must tie in t with the reference's
        np.testing.assert_allclose(got["t"][differ], want["t"][differ],
                                   rtol=1e-6)
        np.testing.assert_allclose(got["b1"][~differ], want["b1"][~differ],
                                   rtol=1e-5, atol=1e-6)


def test_closest_hits_match_brute_force(soup):
    """The traversal finds the brute-force closest hit: same triangle test,
    every triangle of every pierced leaf, no subtree skipped."""
    p0, p1, p2 = soup["p"]
    pool = torch.as_tensor(ti.pad_triangles(np.concatenate([p0, p1, p2], 1)))
    o, d = torch.as_tensor(soup["o"]), torch.as_tensor(soup["d"])
    far = torch.full((o.shape[0],), 1e30)
    t_bf, prim_bf, _b1, _b2 = ti.tri_intersect_plain(pool, o, d, far, 600,
                                                     any_hit=False)
    got = bvh8.bvh8_intersect(soup["t"], o, d, 1e30)
    assert torch.equal(got["prim"], prim_bf)
    hit = prim_bf >= 0
    assert torch.equal(got["t"][hit], t_bf[hit])


def test_wrapper_broadcasts_scalar_t_max_and_checks_shapes(soup):
    o, d = torch.as_tensor(soup["o"]), torch.as_tensor(soup["d"])
    a = bvh8.bvh8_intersect(soup["t"], o, d, 3.0, any_hit=True)
    b = bvh8.bvh8_intersect(soup["t"], o, d, torch.full((o.shape[0],), 3.0),
                            any_hit=True)
    assert torch.equal(a["prim"], b["prim"]) and torch.equal(a["t"], b["t"])
    assert bool((a["t"][a["hit"]] < 3.0).all())
    dead = bvh8.bvh8_intersect(soup["t"], o, d, -1.0)
    assert not bool(dead["hit"].any())
    with pytest.raises(ValueError):
        bvh8.bvh8_intersect(soup["t"], o[:, :2], d, 1.0)


def test_native_build_raises_without_gxx(monkeypatch, tmp_path):
    """No Python fallback: without a compiler the host builder raises."""
    monkeypatch.setattr(native, "library_path",
                        lambda: tmp_path / "libmissing.so")
    monkeypatch.setattr(shutil, "which", lambda name: None)
    native.load_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            native.build_bvh(np.zeros((1, 3)), np.ones((1, 3)))
    finally:
        native.load_library.cache_clear()


@pytest.mark.parametrize("name", native.SOURCES)
def test_native_sources_are_the_references(name):
    """The port builds its own copies of the reference's C++ builders, byte
    for byte the same, so both packages build bit-identical trees; it no
    longer reads pbrt_tpu/native/."""
    root = Path(__file__).resolve().parent.parent
    assert native.NATIVE_DIR == root / "pbrt_tpu_torch" / "csrc" / "host"
    assert (native.NATIVE_DIR / name).read_bytes() == \
        (root / "pbrt_tpu" / "native" / name).read_bytes()
