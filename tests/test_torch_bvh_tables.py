"""The BVH8 and two-level kernels' own tables, and their walks, on the CPU.

The two-level kernel (csrc/bvh2.cu's two-level entry) reads two tables
derived from the scene's at build time (ops/bvh2.kernel_tables): 64 B
instance rows and 48 B triangle rows [p0, p1 - p0, p2 - p0, id]. Each is
held to the rows it comes from, and convert.from_jax_scene carries them.
A numpy walk in each kernel's own order, in float32 a ray at a time, is
held bit for bit to the plain version, closest and any hit: for the BVH8
kernel, a node's interior children pushed before its leaves are tested;
for the two-level kernel, the node rows' walk with ENTER and RETURN on the
derived rows.
"""
import os
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from pbrt_tpu_torch import convert  # noqa: E402
from pbrt_tpu_torch.ops import bvh as bvh_mod  # noqa: E402
from pbrt_tpu_torch.ops import bvh2  # noqa: E402
from pbrt_tpu_torch.ops import bvh8  # noqa: E402
from pbrt_tpu_torch.scene import parser  # noqa: E402
from pbrt_tpu_torch.scene_core import SceneBuilder  # noqa: E402
from pbrt_tpu_torch.utils import transform as tfm  # noqa: E402

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
F = np.float32


def _soup(T, seed):
    rs = np.random.RandomState(seed)
    c = rs.uniform(-5, 5, (T, 3))
    return [(c + rs.normal(0, 0.5, (T, 3))).astype(F) for _ in range(3)]


def _rays(n, seed, lo, hi):
    rs = np.random.RandomState(seed)
    o = rs.uniform(lo, hi, (n, 3)).astype(F)
    d = rs.normal(size=(n, 3))
    return o, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(F)


def _bvh8_soup(T=600, seed=0):
    p0, p1, p2 = _soup(T, seed)
    lo = np.minimum(np.minimum(p0, p1), p2)
    hi = np.maximum(np.maximum(p0, p1), p2)
    return bvh8.build_bvh8(lo, hi, bvh_mod.pack_tri_geo(p0, p1, p2),
                           device="cpu")


def _instanced(n_side, seed):
    """A seeded soup as one prototype, instanced on an n_side x n_side grid
    each turned by a seeded angle, a second prototype (a quad) on the
    diagonal, and a ground quad in the world."""
    b = SceneBuilder()
    m = b.materials.add_diffuse((0.5, 0.5, 0.5))
    p0, p1, p2 = _soup(60, seed)
    tri = np.stack([p0, p1, p2], 1).reshape(-1, 3) * F(0.15)
    soup = b.new_prototype()
    b.add_proto_mesh(soup, tri, np.arange(len(tri)).reshape(-1, 3), m)
    quad = b.new_prototype()
    b.add_proto_mesh(quad, [[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]],
                     [[0, 1, 2], [0, 2, 3]], m)
    angles = np.random.default_rng(seed).uniform(0, 360, n_side * n_side)
    for k, a in enumerate(angles):
        gx, gz = k % n_side, k // n_side
        b.add_instance(soup, tfm.translate((gx * 2.0, 0, gz * 2.0))
                       @ tfm.rotate(a, (0, 1, 0)))
        if gx == gz:
            b.add_instance(quad, tfm.translate((gx * 2.0, 1.0, gz * 2.0)))
    b.add_mesh([[-2, -1, -2], [2 * n_side, -1, -2], [2 * n_side, -1,
                                                      2 * n_side],
                [-2, -1, 2 * n_side]], [[0, 1, 2], [0, 2, 3]], m)
    return b.build(device="cpu")


def _two_level_scene(which):
    if which == "instances.pbrt":
        return parser.parse_file(ROOT / "scenes" / "instances.pbrt",
                                 device="cpu").scene
    return _instanced(6, 3)


# ---------------------------------------------------------------------------
# The derived tables

@pytest.mark.parametrize("which", ["instances.pbrt", "grid6"])
def test_two_level_instance_rows_match_the_instance_rows(which):
    """Each 64 B instance row: the w2o floats bit for bit, then its BLAS
    root's node row (column 24) and the instance id (column 25) as int32
    bits, then 0, 0."""
    s = _two_level_scene(which)
    rows = s.inst_rows.numpy()
    insts = s.tlas_kernel.insts.numpy()
    assert insts.shape == (rows.shape[0], 16) and insts.dtype == np.float32
    np.testing.assert_array_equal(insts[:, :12].view(np.uint32),
                                  rows[:, :12].view(np.uint32))
    ints = insts[:, 12:].view(np.int32)
    np.testing.assert_array_equal(ints[:, 0], np.round(rows[:, 24]))
    np.testing.assert_array_equal(ints[:, 1], np.round(rows[:, 25]))
    assert not ints[:, 2:].any()
    # each BLAS root lies below the TLAS's rows
    assert (ints[:, 0] < s.tlas_root).all()


@pytest.mark.parametrize("which", ["instances.pbrt", "grid6"])
def test_two_level_triangle_rows_round_as_the_test(which):
    """Each 48 B triangle row is [p0, p1 - p0, p2 - p0, id, 0, 0], the
    edges one float32 subtraction each, so the test on it (the kernel's)
    gives the bits of the test on the raw rows, which subtracts them
    itself (bvh2._tri_test): t, b1, b2 and the verdict."""
    s = _two_level_scene(which)
    raw = s.tri_geo_tlas.numpy()
    rows = s.tlas_kernel.rows.numpy()
    assert rows.shape == (raw.shape[0], 12)
    np.testing.assert_array_equal(rows[:, 0:3], raw[:, 0:3])
    for k in (1, 2):
        e = (raw[:, 3 * k:3 * k + 3] - raw[:, 0:3]).astype(F)
        np.testing.assert_array_equal(rows[:, 3 * k:3 * k + 3].view(np.uint32),
                                      e.view(np.uint32))
    np.testing.assert_array_equal(rows[:, 9], raw[:, 9])
    assert not rows[:, 10:].any()
    # every triangle against rays aimed at it
    T = raw.shape[0]
    rng = np.random.default_rng(1)
    target = raw[:, 0:3] + 0.3 * (raw[:, 3:6] - raw[:, 0:3]) \
        + 0.3 * (raw[:, 6:9] - raw[:, 0:3])
    o = (target + rng.normal(size=(T, 3)) * 3).astype(F)
    d = (target - o).astype(F)
    t_raw, b1_raw, b2_raw, ok_raw = bvh2._tri_test(
        torch.as_tensor(raw), torch.as_tensor(o), torch.as_tensor(d))
    got = [_tri_edges(rows[i], o[i], d[i], tol=False) for i in range(T)]
    t_k = np.asarray([g[0] for g in got], F)
    np.testing.assert_array_equal(t_k.view(np.uint32),
                                  t_raw.numpy().view(np.uint32))
    np.testing.assert_array_equal(np.asarray([g[1] for g in got], F),
                                  b1_raw.numpy())
    np.testing.assert_array_equal(np.asarray([g[2] for g in got], F),
                                  b2_raw.numpy())
    np.testing.assert_array_equal(np.asarray([g[3] for g in got]),
                                  ok_raw.numpy())
    assert ok_raw.float().mean() > 0.5


def test_convert_carries_the_kernel_tables():
    """from_jax_scene derives the two-level kernel's three tables from the
    exported ones, equal to those SceneBuilder.build derives."""
    from _jax_export import export
    from pbrt_tpu.scene import parser as jparser
    text = (ROOT / "scenes" / "instances.pbrt").read_bytes()
    dj = jparser.parse_string(text)
    arrays, meta = export(dj.scene, dj.camera, dj.sampler)
    own = parser.parse_string(text, device="cpu").scene
    got, _cam, _smp = convert.from_jax_scene(arrays, meta, device="cpu")
    for field in ("insts", "rows"):
        a = getattr(got.tlas_kernel, field)
        b = getattr(own.tlas_kernel, field)
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), field


# ---------------------------------------------------------------------------
# The kernels' walks, a ray at a time in float32

def _inv(d):
    return F(1) / np.where(d == 0, F(1e-20), d).astype(F)


def _slabs(lo, hi, o, inv, t_best):
    """ops/bvh8._slab on boxes lo, hi (k, 3) in float32: (hit (k,), entry
    distance (k,))."""
    with np.errstate(all="ignore"):
        t0 = (lo - o) * inv
        t1 = (hi - o) * inv
        tn, tf = np.minimum(t0, t1), np.maximum(t0, t1)
        tmin = np.maximum(np.maximum(tn[:, 0], tn[:, 1]),
                          np.maximum(tn[:, 2], F(0)))
        tmax = np.minimum(np.minimum(tf[:, 0], tf[:, 1]),
                          np.minimum(tf[:, 2], F(t_best)))
        return tmin <= tmax * F(1.0000004), tmin


def _tri_edges(r, o, d, tol, t_min=F(1e-5)):
    """Moeller-Trumbore on [p0, e1, e2] in the kernels' operation order:
    (t, b1, b2, accepted without the t_best bound)."""
    p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z = (F(x) for x in r[:9])
    ox, oy, oz = (F(x) for x in o)
    dx, dy, dz = (F(x) for x in d)
    with np.errstate(all="ignore"):
        pvx = dy * e2z - dz * e2y
        pvy = dz * e2x - dx * e2z
        pvz = dx * e2y - dy * e2x
        det = e1x * pvx + e1y * pvy + e1z * pvz
        s = F(-1) if det < 0 else F(1)
        det_a = det * s
        tx, ty, tz = ox - p0x, oy - p0y, oz - p0z
        u_n = (tx * pvx + ty * pvy + tz * pvz) * s
        qvx = ty * e1z - tz * e1y
        qvy = tz * e1x - tx * e1z
        qvz = tx * e1y - ty * e1x
        v_n = (dx * qvx + dy * qvy + dz * qvz) * s
        t_n = (e2x * qvx + e2y * qvy + e2z * qvz) * s
        tl = F(1e-6) * det_a if tol else F(0)
        inv_det = F(1) / (F(1) if det_a == 0 else det_a)
        t = t_n * inv_det
        ok = (det_a > F(1e-12) and u_n >= -tl and v_n >= -tl
              and u_n + v_n <= det_a + tl and t > t_min)
        return t, u_n * inv_det, v_n * inv_det, bool(ok)


def _bvh8_walk(b8, o, d, t_max, any_hit):
    """csrc/bvh8.cu's walk: the root box, then each popped node's eight
    child boxes against the t_best of its visit; its interior children hit
    pushed (the near side last) before its hit leaves' triangles are
    tested, in slot order, from their 9-float rows."""
    nf = b8.nodes_f.numpy()
    nq = b8.nodes_q.numpy().reshape(-1, 8, 3)
    rows = b8.tris.numpy().reshape(-1, 9)
    pidx = b8.prim_indices.numpy()
    N = len(o)
    out = (np.full(N, np.inf, F), np.full(N, -1, np.int32), np.zeros(N, F),
           np.zeros(N, F))
    for r in range(N):
        inv = _inv(d[r])
        t_best, slot, b1, b2 = F(t_max[r]), -1, F(0), F(0)
        if not _slabs(nf[None, 0:3], nf[None, 3:6], o[r], inv, t_best)[0][0]:
            continue
        stack = [0]
        while stack:
            cur = stack.pop()
            fr = nf[8 + 8 * cur:16 + 8 * cur]
            w0, w1, first = nq[cur, :, 0], nq[cur, :, 1], nq[cur, :, 2]
            q = lambda w: np.stack([(w >> (8 * c)) & 255 for c in range(3)],
                                   1).astype(F)
            lo = fr[0:3] + q(w0) * fr[3:6]
            hi = fr[0:3] + q(w1) * fr[3:6]
            hit = _slabs(lo.astype(F), hi.astype(F), o[r], inv, t_best)[0]
            cnt = (w0 >> 24) & 255
            neg = d[r, int(round(float(fr[6])))] < 0
            slots = range(8) if neg else range(7, -1, -1)
            stack += [int(first[c]) for c in slots if hit[c] and cnt[c] == 0]
            done = False
            for c in range(8):
                if not hit[c] or cnt[c] == 0 or cnt[c] == 255:
                    continue
                for s in range(first[c], first[c] + cnt[c]):
                    t, u, v, ok = _tri_edges(rows[s], o[r], d[r], tol=True)
                    if ok and t < t_best:
                        t_best, slot, b1, b2 = t, s, u, v
                        done = any_hit
                    if done:
                        break
                if done:
                    break
            if done:
                break
        if slot >= 0:
            out[0][r], out[1][r] = t_best, pidx[slot]
            out[2][r], out[3][r] = b1, b2
    return out


def _two_level_walk(s, o, d, t_max, any_hit):
    """csrc/bvh2.cu's two-level walk on the kernel's own rows: from the
    TLAS root, a node row's box against the running t_best, an interior
    node's far child pushed and its near one next; a TLAS leaf pushes ENTER
    for its instances, first to last; ENTER maps the world ray through the
    64 B instance row, pushes RETURN and goes to the BLAS root's node row; a
    BLAS leaf's triangles in order from the 48 B rows."""
    kt = s.tlas_kernel
    nodes = s.tlas_nodes.numpy()
    insts = kt.insts.numpy()
    iints = insts[:, 12:].view(np.int32)
    rows = kt.rows.numpy()
    N = len(o)
    out = (np.full(N, np.inf, F), np.full(N, -1, np.int32), np.zeros(N, F),
           np.zeros(N, F), np.full(N, -1, np.int32))
    RET = "return"
    for r in range(N):
        wo, wd = o[r], d[r]
        co, cd = wo, wd
        inv = _inv(wd)
        t_best = F(t_max[r])
        prim = inst = cur_inst = -1
        b1 = b2 = F(0)
        stack = []
        cur = s.tlas_root
        done = False
        while cur is not None and not done:
            row = nodes[cur]
            roff = int(round(float(row[6])))
            nprim, axis = int(round(float(row[7]))) >> 2, \
                int(round(float(row[7]))) & 3
            if _slabs(row[None, 0:3], row[None, 3:6], co, inv, t_best)[0][0]:
                if nprim == 0:
                    near, far = (roff, cur + 1) if wd[axis] < 0 else \
                        (cur + 1, roff)
                    stack.append(far)
                    cur = near
                    continue
                m = min(nprim, 4)
                if cur >= s.tlas_root:          # a TLAS leaf
                    stack += [("enter", roff + k) for k in range(m)]
                else:                           # a BLAS leaf
                    for k in range(roff, roff + m):
                        t, u, v, ok = _tri_edges(rows[k], co, cd, tol=False)
                        if ok and t < t_best:
                            t_best, b1, b2 = t, u, v
                            prim = int(round(float(rows[k, 9])))
                            inst = cur_inst
                            if any_hit:
                                done = True
                                break
            cur = None
            while stack and not done:
                tok = stack.pop()
                if tok == RET:
                    co, cd, inv, cur_inst = wo, wd, _inv(wd), -1
                elif isinstance(tok, tuple):    # ENTER
                    a = insts[tok[1]]
                    m3 = a[:12].reshape(3, 4)
                    co = np.asarray([m3[k, 0] * wo[0] + m3[k, 1] * wo[1]
                                     + m3[k, 2] * wo[2] + m3[k, 3]
                                     for k in range(3)], F)
                    cd = np.asarray([m3[k, 0] * wd[0] + m3[k, 1] * wd[1]
                                     + m3[k, 2] * wd[2] for k in range(3)], F)
                    inv = _inv(cd)
                    cur_inst = int(iints[tok[1], 1])
                    stack.append(RET)
                    cur = int(iints[tok[1], 0])
                    break
                else:
                    cur = tok
                    break
        if prim >= 0:
            out[0][r], out[1][r], out[2][r], out[3][r], out[4][r] = \
                t_best, prim, b1, b2, inst
    return out


def _same_bits(got, want, any_hit, names):
    want = [w.numpy() for w in want]
    np.testing.assert_array_equal(got[1] >= 0, want[1] >= 0)
    if any_hit:
        return
    for g, w, name in zip(got, want, names):
        np.testing.assert_array_equal(np.asarray(g).view(np.uint32),
                                      np.asarray(w).view(np.uint32),
                                      err_msg=name)


@pytest.mark.parametrize("any_hit", [False, True])
def test_bvh8_kernel_walk_matches_plain(any_hit):
    """The BVH8 kernel's order on a 600-triangle soup, 256 seeded rays:
    t, prim, b1, b2 bit-equal to bvh8_intersect_plain (the hit flag at any
    hit)."""
    b8 = _bvh8_soup()
    o, d = _rays(256, 4, -7, 7)
    t_max = np.full(256, 6.0 if any_hit else 1e30, F)
    t_max[::17] = -1.0      # dead lanes, as a wave's finished paths
    want = bvh8.bvh8_intersect_plain(b8, torch.as_tensor(o),
                                     torch.as_tensor(d),
                                     torch.as_tensor(t_max), any_hit)
    got = _bvh8_walk(b8, o, d, t_max, any_hit)
    assert 0.1 < (want[1] >= 0).float().mean() < 0.9
    _same_bits(got, want, any_hit, ("t", "prim", "b1", "b2"))


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("which", ["instances.pbrt", "grid6"])
def test_two_level_kernel_walk_matches_plain(which, any_hit):
    """The two-level kernel's order on the instances golden's tables and a
    seeded 6x6 grid of two prototypes, 192 seeded rays from the TLAS box:
    t, prim, b1, b2 and inst bit-equal to two_level_plain (the hit flag at
    any hit)."""
    s = _two_level_scene(which)
    box = s.tlas_nodes[s.tlas_root, :6].numpy()
    o, d = _rays(192, 5, box[:3] - 1, box[3:] + 1)
    t_max = np.full(192, 3.0 if any_hit else 1e30, F)
    t_max[::13] = -1.0
    want = bvh2.two_level_plain(s.tlas_nodes, s.inst_rows, s.tri_geo_tlas,
                                s.tlas_root, torch.as_tensor(o),
                                torch.as_tensor(d), torch.as_tensor(t_max),
                                any_hit)
    got = _two_level_walk(s, o, d, t_max, any_hit)
    assert 0.1 < (want[1] >= 0).float().mean() < 0.9
    _same_bits(got, want, any_hit, ("t", "prim", "b1", "b2", "inst"))
