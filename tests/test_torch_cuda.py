"""CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and nvcc (marker `cuda`) and skip
elsewhere. The file imports no jax, so on a machine without it run it
without the suite's conftest:
    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pbrt_tpu_torch import filters as flt
from pbrt_tpu_torch import samplers as smp
from pbrt_tpu_torch import scenes
from pbrt_tpu_torch.ops import bvh8
from pbrt_tpu_torch.ops import megawave
from pbrt_tpu_torch.ops import tri_intersect as ti
from pbrt_tpu_torch.scene import parser
from pbrt_tpu_torch.utils import spectrum as spc

W = H = 64
SPP = 16


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True])
def test_tri_intersect_kernel_matches_plain(cuda_device, any_hit):
    scene, _cam = scenes.make_cornell_box(W, H, device=cuda_device)
    rs = np.random.RandomState(7)
    n = 1 << 16
    o = rs.uniform([-50, -50, -900], [600, 600, 600], (n, 3))
    d = rs.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = rs.uniform(0, 1500, n) if any_hit else np.full(n, 1e30)
    args = [torch.as_tensor(a, dtype=torch.float32, device=cuda_device)
            for a in (o, d, t_max)]
    before = ti.counter.launches
    got = ti.tri_intersect(scene.tri_pallas, *args, scene.mega.n_tris,
                           any_hit)
    torch.cuda.synchronize()
    assert ti.counter.launches == before + 1
    want = ti.tri_intersect_plain(scene.tri_pallas, *args,
                                  scene.mega.n_tris, any_hit)
    same = got[1] == want[1]
    assert same.float().mean().item() >= 0.9999
    torch.testing.assert_close(got[0][same], want[0][same], rtol=1e-5,
                               atol=0)


def _big_pool(which, device):
    """Pools above one shared-memory tile: a subdivision-3 icosphere through
    SceneBuilder with the default force_bvh=None (1,280 triangles: the
    brute-force route), or a seeded soup of 4,096 triangles, both inside the
    box +-1. Returns (pool, n_real)."""
    from pbrt_tpu_torch.scene_core import BVH_MIN_TRIS, SceneBuilder
    if which == "sphere1280":
        b = SceneBuilder()
        v, f, nrm = scenes.make_sphere_mesh((0.0, 0.0, 0.0), 1.0, subdiv=3)
        b.add_mesh(v, f, b.materials.add_diffuse((0.5, 0.5, 0.5)),
                   normals=nrm)
        b.add_uniform_infinite_light(spc.ConstantSpectrum(1.0))
        scene = b.build(light_sampler="uniform", device=device)
        assert scene.n_tris == 1280 and scene.tri_pallas is not None
        return scene.tri_pallas, scene.n_tris
    rs = np.random.RandomState(31)
    p0 = rs.uniform(-1, 1, (BVH_MIN_TRIS, 1, 3))
    tri = (p0 + rs.normal(scale=0.05, size=(BVH_MIN_TRIS, 3, 3))).reshape(
        BVH_MIN_TRIS, 9)
    return torch.as_tensor(ti.pad_triangles(tri), device=device), BVH_MIN_TRIS


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("which", ["sphere1280", "soup4096"])
def test_tri_intersect_kernel_above_one_tile(cuda_device, which, any_hit):
    """Pools of 1,280 and 4,096 triangles, which a scene built with the
    default force_bvh sends to the triangle kernel: the launch succeeds and
    t, prim, b1 and b2 are bit-equal to the plain version."""
    pool, n_real = _big_pool(which, cuda_device)
    n = 1 << 14
    o, d = _box_rays((-2, -2, -2), (2, 2, 2), n, 33, cuda_device)
    t_max = torch.full((n,), 1.5 if any_hit else 1e30, device=cuda_device)
    before = ti.counter.launches
    got = ti.tri_intersect(pool, o, d, t_max, n_real, any_hit)
    torch.cuda.synchronize()
    assert ti.counter.launches == before + 1
    want = ti.tri_intersect_plain(pool, o, d, t_max, n_real, any_hit)
    assert 0.05 < (want[1] >= 0).float().mean().item() < 0.95
    for g, w, name in zip(got, want, ("t", "prim", "b1", "b2")):
        assert torch.equal(g, w), name


@pytest.mark.cuda
@pytest.mark.parametrize("light_sampler", ["power", "uniform"])
def test_megakernel_matches_plain(cuda_device, light_sampler):
    scene, cam = scenes.make_cornell_box(W, H, device=cuda_device)
    if light_sampler == "uniform":
        scene = scenes.make_uniform_light_box(cuda_device)
        assert scene.mega.ls_uniform
    sampler = smp.make_sampler("zsobol", spp=SPP, full_resolution=(W, H))
    pix = torch.arange(W * H, device=cuda_device).repeat(SPP)
    si = torch.arange(W * H * SPP, device=cuda_device) // (W * H)
    px, py = pix % W, pix // W
    lam = spc.sample_visible_wavelengths(
        smp.sample_1d(sampler, px, py, si, 5)).lam
    w = megawave.prepare_full(scene, sampler, cam,
                              flt.make_filter("gaussian"), px, py, si, lam,
                              max_depth=5)
    before = megawave.counter.launches
    L, fw = megawave.wave_full(w)
    torch.cuda.synchronize()
    assert megawave.counter.launches == before + 1
    L_p, fw_p = megawave.wave_full_plain(w)
    rel = ((L - L_p).abs() / L_p.abs().clamp(min=1e-3)).amax(dim=1)
    assert (rel < 1e-4).float().mean().item() >= 0.999
    assert abs(L.mean().item() / L_p.mean().item() - 1) < 1e-3
    torch.testing.assert_close(fw, fw_p, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True])
def test_bvh8_kernel_matches_plain(cuda_device, any_hit):
    """meshfield's BVH8, 2^16 seeded rays from the world box +-1."""
    from pathlib import Path
    root = Path(__file__).resolve().parent.parent
    scene = parser.parse_file(root / "scenes" / "meshfield.pbrt",
                              device=cuda_device).scene
    tri = scene.tri_all[:, :9].reshape(-1, 3)
    lo = tri.amin(dim=0).cpu().numpy() - 1.0
    hi = tri.amax(dim=0).cpu().numpy() + 1.0
    rs = np.random.RandomState(11)
    n = 1 << 16
    o = rs.uniform(lo, hi, (n, 3))
    d = rs.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = (torch.as_tensor(a, dtype=torch.float32, device=cuda_device)
            for a in (o, d))
    t_max = 30.0 if any_hit else 1e30
    before = bvh8.counter.launches
    got = bvh8.bvh8_intersect(scene.bvh8, o, d, t_max, any_hit)
    torch.cuda.synchronize()
    assert bvh8.counter.launches == before + 1
    t_vec = torch.full((n,), t_max, device=cuda_device)
    want = dict(zip(("t", "prim", "b1", "b2"), bvh8.bvh8_intersect_plain(
        scene.bvh8, o, d, t_vec, any_hit)))
    assert (got["hit"] == (want["prim"] >= 0)).float().mean().item() \
        >= 0.9999
    same = got["prim"] == want["prim"]
    assert same.float().mean().item() >= 0.9999
    assert torch.equal(got["t"][same], want["t"][same])


def _box_rays(lo, hi, n, seed, device):
    rs = np.random.RandomState(seed)
    o = rs.uniform(lo, hi, (n, 3))
    d = rs.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.as_tensor(a, dtype=torch.float32, device=device)
            for a in (o, d))


def _hold_bvh2(got, want, any_hit):
    """Kernel vs plain: hit equal on >= 99.99% of rays; closest hit: prim
    equal on >= 99.99%, t (and inst) equal where prim is equal."""
    hit_p = want["prim"] >= 0
    assert (got["hit"] == hit_p).float().mean().item() >= 0.9999
    if any_hit:
        return
    same = got["prim"] == want["prim"]
    assert same.float().mean().item() >= 0.9999
    assert torch.equal(got["t"][same], want["t"][same])
    if "inst" in want:
        assert torch.equal(got["inst"][same], want["inst"][same])


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True])
def test_bvh2_kernel_matches_plain(cuda_device, any_hit):
    """Single level: meshfield's binary BVH, 2^16 seeded box rays."""
    from pathlib import Path
    from pbrt_tpu_torch.ops import bvh as bvh_mod
    from pbrt_tpu_torch.ops import bvh2
    root = Path(__file__).resolve().parent.parent
    tri = parser.parse_file(root / "scenes" / "meshfield.pbrt",
                            device="cpu").scene.tri_all.numpy()
    p0, p1, p2 = tri[:, 0:3], tri[:, 3:6], tri[:, 6:9]
    b = bvh_mod.build_bvh(np.minimum(np.minimum(p0, p1), p2),
                          np.maximum(np.maximum(p0, p1), p2))
    nodes = torch.as_tensor(b.nodes, device=cuda_device)
    rows = torch.as_tensor(bvh_mod.pack_tri_geo(p0, p1, p2,
                                                order=b.prim_indices),
                           device=cuda_device)
    depth = bvh_mod.bvh_max_depth(b.nodes)
    o, d = _box_rays(p0.min(axis=0) - 1, p0.max(axis=0) + 1, 1 << 16, 11,
                     cuda_device)
    t_max = torch.full((1 << 16,), 30.0 if any_hit else 1e30,
                       device=cuda_device)
    before = bvh2.counter_bvh2.launches
    got = bvh2.bvh2_intersect(nodes, rows, o, d, t_max, any_hit, depth=depth)
    torch.cuda.synchronize()
    assert bvh2.counter_bvh2.launches == before + 1
    want = dict(zip(("t", "prim"), bvh2.bvh2_intersect_plain(
        nodes, rows, o, d, t_max, any_hit)))
    _hold_bvh2(got, want, any_hit)


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True])
def test_two_level_kernel_matches_plain(cuda_device, any_hit):
    """Two levels: the instances golden's tables, 2^16 seeded box rays;
    on the card the wrapper raises without the scene's kernel tables."""
    from pathlib import Path
    from pbrt_tpu_torch.ops import bvh2
    root = Path(__file__).resolve().parent.parent
    s = parser.parse_file(root / "scenes" / "instances.pbrt",
                          device=cuda_device).scene
    o, d = _box_rays((-6, -2, -6), (6, 2, 6), 1 << 16, 12, cuda_device)
    t_max = torch.full((1 << 16,), 30.0 if any_hit else 1e30,
                       device=cuda_device)
    tables = (s.tlas_nodes, s.inst_rows, s.tri_geo_tlas, s.tlas_root)
    with pytest.raises(ValueError, match="kernel"):
        bvh2.two_level_intersect(*tables, o, d, t_max, any_hit,
                                 depth=s.tlas_depth)
    before = bvh2.counter_two_level.launches
    got = bvh2.two_level_intersect(*tables, o, d, t_max, any_hit,
                                   depth=s.tlas_depth, kernel=s.tlas_kernel)
    torch.cuda.synchronize()
    assert bvh2.counter_two_level.launches == before + 1
    want = dict(zip(("t", "prim", "b1", "b2", "inst"), bvh2.two_level_plain(
        *tables, o, d, t_max, any_hit)))
    _hold_bvh2(got, want, any_hit)


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True])
def test_curve_kernel_matches_plain(cuda_device, any_hit):
    """The curve kernel on a 512-strand fur patch (32,768 segments), 2^16
    seeded rays from its box: t and seg bit-equal to the plain version in
    closest-hit mode, the hit flag in any-hit mode; u, v, n and the curve id
    through intersect_curves."""
    import sys
    from pathlib import Path
    from pbrt_tpu_torch.ops import curves
    root = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root / "tools"))
    from hair_scene import hair_scene_text
    s = parser.parse_string(hair_scene_text(512, 1, 8, 8, 1),
                            device=cuda_device).scene
    o, d = _box_rays((-1.2, -0.1, -1.2), (1.2, 1.0, 1.2), 1 << 16, 14,
                     cuda_device)
    t_max = torch.full((1 << 16,), 0.5 if any_hit else 1e30,
                       device=cuda_device)
    tables = (s.curve_nodes, s.curve_segs)
    before = curves.counter.launches
    t, seg = curves.curves_intersect(*tables, o, d, t_max, any_hit,
                                     depth=s.curve_depth)
    torch.cuda.synchronize()
    assert curves.counter.launches == before + 1
    t_p, seg_p = curves.curves_intersect_plain(*tables, o, d, t_max, any_hit)
    assert (seg_p >= 0).float().mean().item() > 0.01
    assert torch.equal(seg >= 0, seg_p >= 0)
    if any_hit:
        return
    assert torch.equal(seg, seg_p) and torch.equal(t, t_p)
    got = curves.intersect_curves(*tables, o, d, t_max, depth=s.curve_depth)
    rows = s.curve_segs[seg_p.clamp(min=0).long()]
    want = curves.segment_test(o, d, torch.where(
        seg_p >= 0, t_p * 1.0001 + 1e-5, 0.0), rows)
    for k in ("u", "v", "n"):
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(got["curve_id"], torch.where(
        seg_p >= 0, rows[:, 14].round().long(), -1))


@pytest.mark.cuda
def test_curve_kernel_matches_plain_on_a_wave_s_rays(cuda_device):
    """The curve queries of one hair wave (a 512-strand patch, 64x64, depth
    3): the camera rays' and every bounce's closest-hit query and the
    shadow rays' any-hit queries, as the wave hands them to the kernel,
    bit-equal to the plain version (the hit flag at any hit)."""
    import sys
    from pathlib import Path
    from pbrt_tpu_torch.integrators import path as path_mod
    from pbrt_tpu_torch.ops import curves
    root = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root / "tools"))
    from hair_scene import hair_scene_text
    desc = parser.parse_string(hair_scene_text(512, 1, 64, 64, 1),
                               device=cuda_device)
    s = desc.scene
    queries = []
    kernel = curves.curves_intersect

    def recording(nodes, segs, o, d, t_max, any_hit=False, **kw):
        queries.append((o, d, t_max, any_hit))
        return kernel(nodes, segs, o, d, t_max, any_hit, **kw)
    curves.curves_intersect = recording
    try:
        pix = torch.arange(64 * 64, device=cuda_device)
        path_mod.render_wave(s, desc.camera, desc.sampler,
                             flt.make_filter("gaussian"), pix,
                             torch.zeros_like(pix),
                             path_mod.PathOptions(max_depth=3))
    finally:
        curves.curves_intersect = kernel
    closest = [q for q in queries if not q[3]]
    assert len(closest) >= 3 and len(queries) > len(closest)
    for o, d, t_max, any_hit in queries:
        t, seg = kernel(s.curve_nodes, s.curve_segs, o, d, t_max, any_hit,
                        depth=s.curve_depth, wide=s.curve_wide)
        t_p, seg_p = curves.curves_intersect_plain(
            s.curve_nodes, s.curve_segs, o, d,
            torch.as_tensor(t_max, device=cuda_device).expand(o.shape[0]),
            any_hit)
        assert torch.equal(seg >= 0, seg_p >= 0)
        if not any_hit:
            assert torch.equal(seg, seg_p) and torch.equal(t, t_p)
    # the bounce rays do hit the fur
    assert (kernel(s.curve_nodes, s.curve_segs, *closest[1][:3],
                   depth=s.curve_depth)[1] >= 0).float().mean().item() > 0.01


def _wave_queries(module, name, desc, depth, device, n_pix=64 * 64):
    """The queries one wave of desc's scene (its first n_pix pixels, one
    sample each) hands module.name, as (o, d, t_max (N,), any_hit): the
    scene passes o, d, t_max and any_hit as the wrapper's last four
    positional arguments."""
    from pbrt_tpu_torch.integrators import path as path_mod
    queries = []
    kernel = getattr(module, name)

    def recording(*a, **k):
        o, d, t_max, any_hit = a[-4:]
        t_max = torch.as_tensor(t_max, dtype=torch.float32, device=device)
        queries.append((o, d, t_max.expand(o.shape[0]).contiguous(),
                        bool(any_hit)))
        return kernel(*a, **k)
    setattr(module, name, recording)
    try:
        pix = torch.arange(n_pix, device=device)
        path_mod.render_wave(desc.scene, desc.camera, desc.sampler,
                             flt.make_filter("gaussian"), pix,
                             torch.zeros_like(pix),
                             path_mod.PathOptions(max_depth=depth))
    finally:
        setattr(module, name, kernel)
    return queries


def _bit_equal(got, want, any_hit, names):
    """The hit flag; at closest hit every output bit for bit."""
    assert torch.equal(got[1] >= 0, want[1] >= 0)
    if not any_hit:
        for g, w, name in zip(got, want, names):
            assert torch.equal(g, w), name


@pytest.mark.cuda
def test_bvh8_kernel_bit_equal_on_a_wave_s_queries(cuda_device):
    """The BVH8 queries of one meshfield wave (64x64 lanes, depth 4): the
    camera rays, each bounce and each shadow query, t, prim, b1 and b2
    bit-equal to the plain version (the hit flag at any hit)."""
    desc = parser.parse_file(Path(__file__).resolve().parent.parent
                             / "scenes" / "meshfield.pbrt",
                             device=cuda_device)
    b8 = desc.scene.bvh8
    queries = _wave_queries(bvh8, "bvh8_intersect", desc, 4, cuda_device)
    assert sum(not q[3] for q in queries) >= 3 and \
        any(q[3] for q in queries)
    for o, d, t_max, any_hit in queries:
        got = bvh8._launch(b8, o, d, t_max, any_hit)
        want = bvh8.bvh8_intersect_plain(b8, o, d, t_max, any_hit)
        _bit_equal(got, want, any_hit, ("t", "prim", "b1", "b2"))


@pytest.mark.cuda
def test_two_level_kernel_bit_equal_on_a_wave_s_queries(cuda_device):
    """The two-level queries of one instances wave (64x64 lanes, depth 3):
    t, prim, b1, b2 and inst bit-equal to the plain version (the hit flag
    at any hit)."""
    from pbrt_tpu_torch.ops import bvh2
    desc = parser.parse_file(Path(__file__).resolve().parent.parent
                             / "scenes" / "instances.pbrt",
                             device=cuda_device)
    s = desc.scene
    tables = (s.tlas_nodes, s.inst_rows, s.tri_geo_tlas, s.tlas_root)
    queries = _wave_queries(bvh2, "two_level_intersect", desc, 3,
                            cuda_device)
    assert sum(not q[3] for q in queries) >= 3 and \
        any(q[3] for q in queries)
    for o, d, t_max, any_hit in queries:
        got = bvh2._launch_two_level(s.tlas_nodes, s.tlas_kernel,
                                     s.tlas_root, o, d, t_max, any_hit)
        want = bvh2.two_level_plain(*tables, o, d, t_max, any_hit)
        _bit_equal(got, want, any_hit, ("t", "prim", "b1", "b2", "inst"))


def _persistent_sizes(size, resident):
    if size.startswith("resident"):
        return resident + (1 if size.endswith("+1") else -1)
    return int(size)


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("size", ["1", "31", "33", "resident-1",
                                  "resident+1", "160000"])
def test_bvh8_kernel_writes_every_ray_once(cuda_device, size, any_hit):
    """The persistent grid: with every output filled with NaN (prim with
    -7) first, every ray is written, bit-equal to the plain version, at
    sizes around a warp's chunk and around the threads the card holds at
    once; every fifth ray is dead (t_max -1), as a wave's finished
    paths."""
    desc = parser.parse_file(Path(__file__).resolve().parent.parent
                             / "scenes" / "meshfield.pbrt",
                             device=cuda_device)
    b8 = desc.scene.bvh8
    n = _persistent_sizes(size, bvh8.grid(1 << 20, cuda_device)
                          ["resident_lanes"])
    tri = desc.scene.tri_all[:, :9].reshape(-1, 3)
    o, d = _box_rays(tri.amin(0).cpu().numpy() - 1,
                     tri.amax(0).cpu().numpy() + 1, n, 19, cuda_device)
    t_max = torch.full((n,), 30.0 if any_hit else 1e30, device=cuda_device)
    t_max[::5] = -1.0
    out = tuple(torch.full((n,), v, dtype=dt, device=cuda_device)
                for v, dt in ((float("nan"), torch.float32),
                              (-7, torch.int32),
                              (float("nan"), torch.float32),
                              (float("nan"), torch.float32)))
    before = bvh8.counter.launches
    got = bvh8._launch(b8, o, d, t_max, any_hit, out=out)
    torch.cuda.synchronize()
    assert bvh8.counter.launches == before + 1 and got[0] is out[0]
    assert not any(bool(torch.isnan(x).any()) for x in out[::2])
    assert not bool((out[1] == -7).any())
    want = bvh8.bvh8_intersect_plain(b8, o, d, t_max, any_hit)
    _bit_equal(got, want, any_hit, ("t", "prim", "b1", "b2"))


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("n", [1, 31, 33, 127, 129, 160000])
def test_two_level_kernel_writes_every_ray_once(cuda_device, n, any_hit):
    """test_bvh8_kernel_writes_every_ray_once for the two-level kernel (a
    thread a ray, 128 a block) on the instances golden's tables (inst
    filled with -7 too), at sizes around a warp and a block."""
    from pbrt_tpu_torch.ops import bvh2
    s = parser.parse_file(Path(__file__).resolve().parent.parent
                          / "scenes" / "instances.pbrt",
                          device=cuda_device).scene
    box = s.tlas_nodes[s.tlas_root, :6].cpu().numpy()
    o, d = _box_rays(box[:3] - 1, box[3:] + 1, n, 20, cuda_device)
    t_max = torch.full((n,), 3.0 if any_hit else 1e30, device=cuda_device)
    t_max[::5] = -1.0
    nan, neg = (float("nan"), torch.float32), (-7, torch.int32)
    out = tuple(torch.full((n,), v, dtype=dt, device=cuda_device)
                for v, dt in (nan, neg, nan, nan, neg))
    before = bvh2.counter_two_level.launches
    got = bvh2._launch_two_level(s.tlas_nodes, s.tlas_kernel, s.tlas_root, o,
                                 d, t_max, any_hit, out=out)
    torch.cuda.synchronize()
    assert bvh2.counter_two_level.launches == before + 1 and got[0] is out[0]
    assert not any(bool(torch.isnan(x).any()) for x in (out[0], out[2],
                                                        out[3]))
    assert not bool((out[1] == -7).any() or (out[4] == -7).any())
    want = bvh2.two_level_plain(s.tlas_nodes, s.inst_rows, s.tri_geo_tlas,
                                s.tlas_root, o, d, t_max, any_hit)
    _bit_equal(got, want, any_hit, ("t", "prim", "b1", "b2", "inst"))


@pytest.mark.cuda
def test_megakernel_rays_in_matches_plain(cuda_device):
    """Megakernel v1 (camera rays given, from the general wave's front
    end): L bit for bit against the plain version."""
    from pbrt_tpu_torch.integrators import path as path_mod
    scene, cam = scenes.make_cornell_box(W, H, device=cuda_device)
    sampler = smp.make_sampler("zsobol", spp=SPP, full_resolution=(W, H))
    pix = torch.arange(W * H, device=cuda_device).repeat(SPP)
    si = torch.arange(W * H * SPP, device=cuda_device) // (W * H)
    px, py, swl = path_mod.camera_lanes(cam, sampler, pix, si)
    o, d, _w = path_mod.camera_rays(cam, sampler, flt.make_filter("gaussian"),
                                    px, py, si)
    w = megawave.prepare_rays(scene, sampler, px, py, si, o, d, swl.lam,
                              max_depth=5)
    before = megawave.counter.launches
    L, fw = megawave.wave_full(w)
    torch.cuda.synchronize()
    assert megawave.counter.launches == before + 1 and fw is None
    L_p, fw_p = megawave.wave_full_plain(w)
    assert fw_p is None and torch.equal(L, L_p)


def _cornell_wave(entry, n, device):
    """n lanes of the main path's cornell wave (400x400, 64 spp, sample
    index 37, one sample more a pass over the pixels), camera rays made in
    the kernel or given from the general wave's front end."""
    from pbrt_tpu_torch.integrators import path as path_mod
    scene, cam = scenes.make_cornell_box(400, 400, device=device)
    sampler = smp.make_sampler("zsobol", spp=64, full_resolution=(400, 400))
    filt = flt.make_filter("gaussian")
    lane = torch.arange(n, device=device)
    pix, si = lane % (400 * 400), 37 + lane // (400 * 400)
    px, py, swl = path_mod.camera_lanes(cam, sampler, pix, si)
    if entry == "camera":
        return megawave.prepare_full(scene, sampler, cam, filt, px, py, si,
                                     swl.lam, max_depth=5)
    o, d, _w = path_mod.camera_rays(cam, sampler, filt, px, py, si)
    return megawave.prepare_rays(scene, sampler, px, py, si, o, d, swl.lam,
                                 max_depth=5)


@pytest.mark.cuda
@pytest.mark.parametrize("size", ["1", "127", "129", "resident-1",
                                  "resident+1", "160000"])
@pytest.mark.parametrize("entry", ["camera", "rays"])
def test_megakernel_writes_every_lane_once(cuda_device, entry, size):
    """The persistent grid: with L (and the filter weight) filled with NaN
    first, every lane is written, L equal to the plain version bit for bit
    and the filter weight within test_megakernel_matches_plain's tolerance
    (its exp rounds apart from torch's), at sizes around a block and around
    the threads the card holds at once (a lane the counter hands out after
    the grid's first ones)."""
    if size.startswith("resident"):
        resident = megawave.grid(_cornell_wave(entry, 160000, cuda_device))
        n = resident["resident_lanes"] + (1 if size.endswith("+1") else -1)
    else:
        n = int(size)
    w = _cornell_wave(entry, n, cuda_device)
    g = megawave.grid(w)
    assert g["blocks"] * g["threads"] >= min(n, g["resident_lanes"])
    L = torch.full((n, 4), float("nan"), device=cuda_device)
    fw = None if entry == "rays" else torch.full((n,), float("nan"),
                                                 device=cuda_device)
    before = megawave.counter.launches
    got = megawave._launch(w, out=(L, fw))
    torch.cuda.synchronize()
    assert megawave.counter.launches == before + 1 and got[0] is L
    assert not bool(torch.isnan(L).any())
    L_p, fw_p = megawave.wave_full_plain(w)
    assert torch.equal(L, L_p)
    if fw is not None:
        assert not bool(torch.isnan(fw).any())
        torch.testing.assert_close(fw, fw_p, rtol=1e-5, atol=1e-6)


def _front(device, width, height, m, seed=11):
    """A cornell render's front (ops/megafront.prepare) on device, 8 spp,
    waves of m sample indices, its film's accumulator seeded (the film
    kernel adds in place)."""
    from pbrt_tpu_torch import film as film_mod
    from pbrt_tpu_torch.ops import megafront
    scene, cam = scenes.make_cornell_box(width, height, device=device)
    sampler = smp.make_sampler("zsobol", 8, seed,
                               full_resolution=(width, height))
    film = film_mod.make_film(width, height, device)
    film.accum.copy_(torch.rand(film.accum.shape,
                                generator=torch.Generator().manual_seed(3)))
    return megafront.prepare(scene, cam, sampler, flt.make_filter("gaussian"),
                             film_mod.make_pixel_sensor(), film, m)


FRONT_FILMS = [(64, 48, 1), (16, 16, 4), (400, 400, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("width, height, m", FRONT_FILMS)
def test_lanes_kernel_bit_equal_to_plain(cuda_device, width, height, m):
    """The lanes kernel's mi, lam and le bit for bit against its plain
    version on the card, for the first and the last wave."""
    from pbrt_tpu_torch.ops import megafront
    front = _front(cuda_device, width, height, m)
    w = front.full
    for s in (0, 8 - m):
        w.mi.fill_(-7)
        w.lam.fill_(float("nan"))
        w.le.fill_(float("nan"))
        before = megafront.lanes_counter.launches
        megafront.lanes(front, s)
        torch.cuda.synchronize()
        assert megafront.lanes_counter.launches == before + 1
        got = [x.clone() for x in (w.mi, w.lam, w.le)]
        megafront.lanes_plain(front, s)
        for g, want, name in zip(got, (w.mi, w.lam, w.le),
                                 ("mi", "lam", "le")):
            assert torch.equal(g.view(torch.int32), want.view(torch.int32)), \
                name


@pytest.mark.cuda
@pytest.mark.parametrize("width, height, m", FRONT_FILMS)
def test_film_kernel_matches_plain(cuda_device, width, height, m):
    """The film kernel's accumulator against its plain version's on the
    card, after the megakernel's wave: bit for bit at m = 1 (one row a
    pixel: the same operations in the same order), within 1e-6 relative at
    m > 1 (the plain version sums a pixel's m rows in torch's reduction
    order)."""
    import dataclasses
    from pbrt_tpu_torch import film as film_mod
    from pbrt_tpu_torch.ops import megafront
    front = _front(cuda_device, width, height, m)
    plain = dataclasses.replace(front, film=film_mod.Film(
        front.film.accum.clone(), width, height))
    for s in (0, 8 - m):
        megafront.lanes(front, s)
        megawave.launch(front.mega_args)
        before = megafront.film_counter.launches
        megafront.film(front)
        torch.cuda.synchronize()
        assert megafront.film_counter.launches == before + 1
        megafront.film_plain(plain)
        got, want = front.film.accum, plain.film.accum
        if m == 1:
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        else:
            torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("width, height", [(1920, 1080), (333, 77)])
def test_film_readout_kernel_bit_equal_to_plain(cuda_device, width, height):
    """The readout kernel's image bit for bit against its plain version on
    the card, on the accumulator of a megakernel wave added by the film
    kernel, some pixels' weight sums zeroed; film.get_image returns that
    image as fresh, writable host arrays."""
    from pbrt_tpu_torch import film as film_mod
    from pbrt_tpu_torch.ops import film_readout, megafront
    from pbrt_tpu_torch.utils import color as pcolor
    front = _front(cuda_device, width, height, 1)
    megafront.lanes(front, 0)
    megawave.launch(front.mega_args)
    megafront.film(front)
    accum = front.film.accum
    accum[::97, 3] = 0.0
    args = (accum, height, width, front.sensor.xyz_from_sensor_rgb,
            pcolor.srgb().rgb_from_xyz)
    c = film_readout.counter
    before = (c.launches, c.plain)
    got = film_readout.film_readout(*args)
    torch.cuda.synchronize()
    assert (c.launches, c.plain) == (before[0] + 1, before[1])
    want = film_readout.film_readout_plain(*args)
    assert got.shape == (height, width, 3) and got.dtype == torch.float32
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    a = film_mod.get_image(front.film, front.sensor)
    b = film_mod.get_image(front.film, front.sensor)
    assert np.array_equal(a.view(np.uint32), got.cpu().numpy().view(
        np.uint32))
    assert np.array_equal(a, b) and not np.shares_memory(a, b)
    assert a.flags.writeable and b.flags.writeable


@pytest.mark.cuda
def test_cornell_render_launches_each_kernel_once_a_wave(cuda_device):
    """render.render on cornell 512x512 at 4 spp (four waves of one sample
    index): the lanes kernel, the megakernel and the film kernel once a
    wave, the readout kernel once a render, no plain version, and the image
    equal to the chain of path.render_wave, film.sensor_to_sensor_rgb and
    film.add_samples on the card, read out by the kernel and by its plain
    version."""
    from pbrt_tpu_torch import film as film_mod
    from pbrt_tpu_torch.integrators import path as path_mod
    from pbrt_tpu_torch.integrators import render
    from pbrt_tpu_torch.ops import film_readout, megafront
    from pbrt_tpu_torch.utils import color as pcolor
    size, spp = 512, 4
    scene, cam = scenes.make_cornell_box(size, size, device=cuda_device)
    sampler = smp.make_sampler("zsobol", spp, 5,
                               full_resolution=(size, size))
    counters = (megafront.lanes_counter, megawave.counter,
                megafront.film_counter)
    before = [(c.launches, c.plain)
              for c in (*counters, film_readout.counter)]
    img, st = render.render(scene, cam, spp, device=cuda_device,
                            sampler=sampler)
    assert st["lanes_per_wave"] == size * size
    for c, (launches, plain), k in zip(
            (*counters, film_readout.counter), before, (spp,) * 3 + (1,)):
        assert (c.launches, c.plain) == (launches + k, plain)
    sensor = film_mod.make_pixel_sensor()
    film = film_mod.make_film(size, size, cuda_device)
    pix = torch.arange(size * size, device=cuda_device)
    for s in range(spp):
        L, swl, fw = path_mod.render_wave(
            scene, cam, sampler, flt.make_filter("gaussian"), pix,
            torch.full_like(pix, s), path_mod.PathOptions())
        rgb = film_mod.sensor_to_sensor_rgb(sensor, L, swl)
        film_mod.add_samples(film, pix, rgb, fw, identity=True)
    want = film_mod.get_image(film, sensor)
    assert np.array_equal(img, want)
    plain = film_readout.film_readout_plain(
        film.accum, size, size, sensor.xyz_from_sensor_rgb,
        pcolor.srgb().rgb_from_xyz)
    assert np.array_equal(img, plain.cpu().numpy())


@pytest.mark.cuda
def test_general_wave_launches_neither_front_kernel(cuda_device):
    """cornell through the general wave (PathOptions(megakernel=False))
    and envlit (outside the megakernel): the lanes and film kernels never
    launch."""
    from pbrt_tpu_torch.integrators import path as path_mod
    from pbrt_tpu_torch.integrators import render
    from pbrt_tpu_torch.ops import megafront
    scene, cam = scenes.make_cornell_box(32, 32, device=cuda_device)
    desc = _envlit(cuda_device, size=16, spp=4)
    before = (megafront.lanes_counter.launches,
              megafront.film_counter.launches, megawave.counter.launches)
    render.render(scene, cam, 4, device=cuda_device,
                  opts=path_mod.PathOptions(megakernel=False))
    render.render(desc.scene, desc.camera, sampler=desc.sampler,
                  device=cuda_device)
    assert (megafront.lanes_counter.launches,
            megafront.film_counter.launches,
            megawave.counter.launches) == before


def _terrain(device, n=101, n_rays=1 << 14):
    """tools/terrain_rays.py's terrain (20,000 triangles at n = 101), its
    three builds, and raster and bounce rays."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
    import terrain_rays
    from pbrt_tpu_torch.ops import bvh as bvh_mod
    lo, hi, tri = terrain_rays.terrain_triangles(n)
    b = bvh_mod.build_bvh(lo, hi)
    V, _F = terrain_rays.make_terrain(n)
    rays = [tuple(torch.as_tensor(a, device=device)
                  for a in terrain_rays.gen_rays(V, kind, n_rays))
            for kind in ("raster", "bounce")]
    return (bvh8.build_bvh8_forest(lo, hi, tri, binary_bvh=b, device=device),
            bvh8.build_bvh8_chunked(lo, hi, tri, binary_bvh=b,
                                    device=device), rays)


def _hold_paged(got, want, any_hit):
    """Kernel vs plain: the hit flag equal; closest hit: t, prim, b1 and b2
    bit for bit."""
    assert torch.equal(got["hit"], want[1] >= 0)
    if not any_hit:
        for k, v in zip(("t", "prim", "b1", "b2"), want):
            assert torch.equal(got[k], v), k


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True])
def test_forest_kernel_matches_plain(cuda_device, any_hit):
    from pbrt_tpu_torch.ops import bvh8_pages as bp
    forest, _c, rays = _terrain(cuda_device)
    assert forest.n_chunks > 1
    for o, d in rays:
        t_max = torch.full((o.shape[0],), 30.0 if any_hit else 1e30,
                           device=cuda_device)
        before = bp.counter_forest.launches
        got = bp.forest_intersect(forest, o, d, t_max, any_hit)
        torch.cuda.synchronize()
        assert bp.counter_forest.launches == before + 1
        _hold_paged(got, bp.forest_intersect_plain(forest, o, d, t_max,
                                                   any_hit), any_hit)


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True])
def test_binned_kernel_matches_plain(cuda_device, any_hit):
    """Two pages a round, so that the rounds loop runs several launches."""
    from pbrt_tpu_torch.ops import bvh8_pages as bp
    _f, chunked, rays = _terrain(cuda_device)
    assert chunked.n_chunks > 2
    for o, d in rays:
        t_max = torch.full((o.shape[0],), 30.0 if any_hit else 1e30,
                           device=cuda_device)
        before = bp.counter_binned.launches
        got = bp.binned_intersect(chunked, o, d, t_max, any_hit,
                                  pages_per_round=2)
        torch.cuda.synchronize()
        assert got["rounds"] > 1
        assert bp.counter_binned.launches == before + got["rounds"]
        *want, rounds, copies = bp.binned_intersect_plain(
            chunked, o, d, t_max, any_hit, pages_per_round=2)
        assert (rounds, copies) == (got["rounds"], got["page_copies"])
        _hold_paged(got, want, any_hit)


sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
import torch_dma_probe as tool  # noqa: E402  (imports no jax)

PROBES = tool.configurations()


@pytest.mark.cuda
@pytest.mark.parametrize("copy", ["ld", "cp_async", "bulk"])
@pytest.mark.parametrize("probe, which", PROBES,
                         ids=[f"{p}-{w}" for p, w in PROBES])
def test_dma_probe_kernel_matches_plain(cuda_device, probe, which, copy):
    """Every probe configuration of the TPU tools on every copy path, at
    the tools' size: bit-equal to the plain version and to the numbers
    numpy expects."""
    from pbrt_tpu_torch.ops import dma_probe as dp
    counters = (dp.counter_var, dp.counter_pipelined, dp.counter_manual,
                dp.counter_ladder)
    before = sum(c.launches for c in counters)
    out, got, exp = tool.run_probe(probe, which, copy, device=cuda_device)
    torch.cuda.synchronize()
    assert sum(c.launches for c in counters) == before + 1
    want = tool.run_plain(probe, which, device=cuda_device)
    assert torch.equal(out, want)
    assert (got == exp[:, None]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("copy", ["ld", "cp_async", "bulk"])
@pytest.mark.parametrize("R, mode", [(226, "pipelined"), (298, "manual"),
                                     (378, "manual")])
def test_dma_probe_kernel_matches_plain_at_page_sizes(cuda_device, R, mode,
                                                      copy):
    """Whole pages summed at the paged kernels' page sizes, 420 pages, 64
    blocks of 20 seeded entries, and the ladder's stage 4 on a schedule
    with empty entries."""
    from pbrt_tpu_torch.ops import dma_probe as dp
    K, B, P = 420, 64, 20
    pages = dp.make_pages(K, R, cuda_device, fill="small")
    x = torch.ones((B * 8, 128), device=cuda_device)
    sched = dp.probe_schedule("seeded", B, P, K, cuda_device, seed=R)
    got = dp.dma_sched(pages, x, sched, P, mode=mode, copy=copy,
                       reduce="sum")
    assert torch.equal(got, dp.dma_sched_plain(pages, x, sched, P, "sum"))
    if mode == "manual":
        lad = dp.probe_schedule("min", B, P, K, cuda_device)
        got = dp.dma_ladder(pages, x, lad, P, 4, copy=copy, reduce="sum")
        assert torch.equal(got, dp.dma_ladder_plain(pages, x, lad, P, 4,
                                                    "sum"))


def _envlit(device, size=64, spp=16):
    """scenes/envlit.pbrt parsed on device at size x size and spp."""
    text = (Path(__file__).resolve().parent.parent / "scenes"
            / "envlit.pbrt").read_text().replace(
        '"integer xresolution" [200] "integer yresolution" [200]',
        f'"integer xresolution" [{size}] "integer yresolution" [{size}]'
    ).replace('"integer pixelsamples" [64]',
              f'"integer pixelsamples" [{spp}]')
    return parser.parse_string(text, base_dir=Path(__file__).resolve()
                               .parent.parent / "scenes", device=device)


@pytest.mark.cuda
def test_tri_intersect_bit_equal_on_envlit_wave_queries(cuda_device):
    """The triangle-kernel queries of one envlit wave (64x64 lanes, depth
    5; 1,538 triangles, six 256-row tiles): the camera rays, each bounce
    and each shadow query, t, prim, b1 and b2 bit-equal to the plain
    version (the hit flag at any hit)."""
    desc = _envlit(cuda_device)
    s = desc.scene
    assert s.n_tris == 1538 and not s.use_bvh
    queries = []
    kernel = ti.tri_intersect

    def recording(tri, o, d, t_max, n_real, any_hit=False):
        t_max = torch.as_tensor(t_max, dtype=torch.float32,
                                device=cuda_device).expand(o.shape[0])
        queries.append((o, d, t_max.contiguous(), bool(any_hit)))
        return kernel(tri, o, d, t_max, n_real, any_hit)
    ti.tri_intersect = recording
    try:
        from pbrt_tpu_torch.integrators import path as path_mod
        pix = torch.arange(64 * 64, device=cuda_device)
        path_mod.render_wave(s, desc.camera, desc.sampler,
                             flt.make_filter("gaussian"), pix,
                             torch.zeros_like(pix),
                             path_mod.PathOptions(max_depth=5))
    finally:
        ti.tri_intersect = kernel
    assert sum(not q[3] for q in queries) == 5 and \
        sum(q[3] for q in queries) == 5
    for o, d, t_max, any_hit in queries:
        got = ti._launch(s.tri_pallas, o.contiguous(), d.contiguous(), t_max,
                         s.n_tris, any_hit)
        want = ti.tri_intersect_plain(s.tri_pallas, o, d, t_max, s.n_tris,
                                      any_hit)
        _bit_equal(got, want, any_hit, ("t", "prim", "b1", "b2"))


@pytest.mark.cuda
def test_envlit_renders_through_the_general_wave(cuda_device):
    """envlit (an image light, a conductor, a dielectric) is outside the
    megakernel: render takes the general wave, every query through the
    triangle kernel, and the image is finite and lit."""
    from pbrt_tpu_torch.integrators import path as path_mod
    from pbrt_tpu_torch.integrators import render
    desc = _envlit(cuda_device, size=32, spp=4)
    assert desc.scene.mega is None and desc.scene.env is not None
    before = (ti.counter.launches, megawave.counter.launches,
              ti.counter.plain)
    img, _st = render.render(desc.scene, desc.camera, sampler=desc.sampler,
                             device=cuda_device,
                             opts=path_mod.PathOptions(max_depth=5))
    assert ti.counter.launches - before[0] == 2 * 5
    assert megawave.counter.launches == before[1]
    assert ti.counter.plain == before[2]
    assert img.shape == (32, 32, 3) and np.isfinite(img).all()
    assert img.mean() > 0.01


def _golden_scene(name, device, size=64, spp=4):
    """scenes/<name>.pbrt parsed on device at size x size and spp."""
    import re
    text = (Path(__file__).resolve().parent.parent / "scenes"
            / f"{name}.pbrt").read_text().replace(
        '"integer xresolution" [200] "integer yresolution" [200]',
        f'"integer xresolution" [{size}] "integer yresolution" [{size}]')
    text = re.sub(r'"integer pixelsamples" \[\d+\]',
                  f'"integer pixelsamples" [{spp}]', text)
    return parser.parse_string(text, base_dir=Path(__file__).resolve()
                               .parent.parent / "scenes", device=device)


def _record(module, name, run):
    """The positional and keyword arguments of every call of module.name
    during run()."""
    calls = []
    fn = getattr(module, name)

    def recording(*a, **k):
        calls.append((a, k))
        return fn(*a, **k)
    setattr(module, name, recording)
    try:
        run()
    finally:
        setattr(module, name, fn)
    return calls


GOLDEN_WAVES = [("manylight", "tri_intersect", 3),
                ("manylight16k", "bvh8", 3), ("killeroo", "bvh8", 5),
                ("plytex", "bvh8", 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("name, route, depth", GOLDEN_WAVES)
def test_kernels_bit_equal_on_golden_rung_wave_queries(cuda_device, name,
                                                       route, depth):
    """The kernel queries of one wave (64x64 lanes) of manylight (triangle
    kernel), manylight16k, killeroo and plytex (BVH8 kernel; plytex's
    sphere merged in tensor code): the camera rays,
    each bounce and each shadow query, t, prim, b1 and b2 bit-equal to
    the plain version (the hit flag at any hit)."""
    from pbrt_tpu_torch.integrators import path as path_mod
    desc = _golden_scene(name, cuda_device)
    s = desc.scene
    module, fn_name, arg = ((ti, "tri_intersect", 5) if route ==
                            "tri_intersect" else (bvh8, "bvh8_intersect", 4))
    pix = torch.arange(64 * 64, device=cuda_device)
    calls = _record(module, fn_name, lambda: path_mod.render_wave(
        s, desc.camera, desc.sampler, flt.make_filter("gaussian"), pix,
        torch.zeros_like(pix), path_mod.PathOptions(max_depth=depth)))
    assert sum(not a[arg] for a, _k in calls) == depth
    assert sum(bool(a[arg]) for a, _k in calls) == depth
    for a, _k in calls:
        # (pool, o, d, t_max, n_real, any_hit) or (b8, o, d, t_max, any_hit)
        o, d = a[1].contiguous(), a[2].contiguous()
        t_max = torch.as_tensor(a[3], dtype=torch.float32,
                                device=cuda_device).expand(o.shape[0])
        t_max = t_max.contiguous()
        any_hit = bool(a[arg])
        if route == "tri_intersect":
            got = ti._launch(s.tri_pallas, o, d, t_max, s.n_tris, any_hit)
            want = ti.tri_intersect_plain(s.tri_pallas, o, d, t_max,
                                          s.n_tris, any_hit)
        else:
            got = bvh8._launch(s.bvh8, o, d, t_max, any_hit)
            want = bvh8.bvh8_intersect_plain(s.bvh8, o, d, t_max, any_hit)
        _bit_equal(got, want, any_hit, ("t", "prim", "b1", "b2"))


@pytest.mark.cuda
@pytest.mark.parametrize("name, route, depth", GOLDEN_WAVES)
def test_golden_rungs_render_through_the_general_wave(cuda_device, name,
                                                      route, depth):
    """manylight and manylight16k (the bvh light sampler), killeroo (a
    texture) and plytex (a quadric) are outside the megakernel: render
    takes the general wave,
    every query through the rung's kernel, and the image is finite and
    lit."""
    from pbrt_tpu_torch.integrators import path as path_mod
    from pbrt_tpu_torch.integrators import render
    desc = _golden_scene(name, cuda_device, size=32)
    assert desc.scene.mega is None
    counter = (ti if route == "tri_intersect" else bvh8).counter
    before = (counter.launches, megawave.counter.launches, counter.plain)
    img, _st = render.render(desc.scene, desc.camera, sampler=desc.sampler,
                             device=cuda_device,
                             opts=path_mod.PathOptions(max_depth=depth))
    assert counter.launches - before[0] == 2 * depth
    assert megawave.counter.launches == before[1]
    assert counter.plain == before[2]
    assert img.shape == (32, 32, 3) and np.isfinite(img).all()
    assert img.mean() > 1e-3


@pytest.mark.cuda
def test_volume_renders_through_the_volumetric_wave(cuda_device):
    """volume.pbrt at 32x32, 4 spp: render takes the volumetric wave, every
    main query through the triangle kernel (no plain version), the image
    finite and lit; every triangle-kernel query of one wave bit-equal to
    the plain version."""
    from pbrt_tpu_torch.integrators import path as path_mod
    from pbrt_tpu_torch.integrators import render
    from pbrt_tpu_torch.integrators import volpath
    desc = _golden_scene("volume", cuda_device, size=32)
    s = desc.scene
    assert render.wave_module(s) is volpath and s.tri_pallas is not None
    before = (ti.counter.launches, ti.counter.plain)
    img, _st = render.render(s, desc.camera, sampler=desc.sampler,
                             device=cuda_device,
                             opts=path_mod.PathOptions(max_depth=6))
    assert ti.counter.launches > before[0] and ti.counter.plain == before[1]
    assert img.shape == (32, 32, 3) and np.isfinite(img).all()
    assert img.mean() > 1e-2
    pix = torch.arange(32 * 32, device=cuda_device)
    calls = _record(ti, "tri_intersect", lambda: volpath.render_wave(
        s, desc.camera, desc.sampler, flt.make_filter("gaussian"), pix,
        torch.zeros_like(pix), path_mod.PathOptions(max_depth=6)))
    assert any(a[5] for a, _k in calls) and any(not a[5] for a, _k in calls)
    for a, _k in calls:
        o, d = a[1].contiguous(), a[2].contiguous()
        t_max = torch.as_tensor(a[3], dtype=torch.float32,
                                device=cuda_device).expand(o.shape[0])
        t_max = t_max.contiguous()
        got = ti._launch(s.tri_pallas, o, d, t_max, s.n_tris, bool(a[5]))
        want = ti.tri_intersect_plain(s.tri_pallas, o, d, t_max, s.n_tris,
                                      bool(a[5]))
        _bit_equal(got, want, bool(a[5]), ("t", "prim", "b1", "b2"))


@pytest.mark.cuda
def test_interface_kernel_bit_equal_on_a_shell_wave(cuda_device):
    """scenes.make_medium_shell at 32x32, 4 spp: its 320 interface
    triangles go through the single-level bvh2 kernel; render launches it
    and no plain version, and every interface query of one wave is
    bit-equal to the plain version."""
    from pbrt_tpu_torch.integrators import path as path_mod
    from pbrt_tpu_torch.integrators import render
    from pbrt_tpu_torch.integrators import volpath
    from pbrt_tpu_torch.ops import bvh2
    s, cam = scenes.make_medium_shell(32, 32, device=cuda_device)
    sampler = smp.make_sampler("zsobol", spp=4, full_resolution=(32, 32))
    assert s.use_iface_bvh
    before = (bvh2.counter_bvh2.launches, bvh2.counter_bvh2.plain)
    img, _st = render.render(s, cam, sampler=sampler, device=cuda_device,
                             opts=path_mod.PathOptions(max_depth=5))
    assert bvh2.counter_bvh2.launches > before[0]
    assert bvh2.counter_bvh2.plain == before[1]
    assert np.isfinite(img).all() and img.mean() > 1e-3
    pix = torch.arange(32 * 32, device=cuda_device)
    calls = _record(bvh2, "bvh2_intersect", lambda: volpath.render_wave(
        s, cam, sampler, flt.make_filter("gaussian"), pix,
        torch.zeros_like(pix), path_mod.PathOptions(max_depth=5)))
    assert len(calls) >= 5
    for a, _k in calls:
        o, d, t_max = (x.contiguous() for x in a[2:5])
        got = bvh2._launch(s.iface_nodes, s.iface_tris_bvh, o, d, t_max,
                           False)
        want = bvh2.bvh2_intersect_plain(s.iface_nodes, s.iface_tris_bvh, o,
                                         d, t_max, False)
        _bit_equal(got, want, False, ("t", "prim", "b1", "b2"))
