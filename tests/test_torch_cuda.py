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


def _uniform_light_box(device):
    """A floor, a back wall and two lamps under the uniform light sampler
    (the megakernel's other light-pick branch), seen by the cornell
    camera."""
    from pbrt_tpu_torch.scene_core import SceneBuilder
    from pbrt_tpu_torch.utils import color as pcolor
    b = SceneBuilder()
    m = b.materials.add_diffuse((0.6, 0.5, 0.4))
    quad = [[0, 1, 2], [0, 2, 3]]
    b.add_mesh([(556, 0, 0), (0, 0, 0), (0, 0, 560), (556, 0, 560)], quad, m)
    b.add_mesh([(556, 0, 560), (0, 0, 560), (0, 549, 560), (556, 549, 560)],
               quad, m)
    lamp = pcolor.RGBIlluminantSpectrum((8.0, 8.0, 8.0))
    for x0 in (100, 350):
        # wound so the emitting side faces down
        b.add_mesh([(x0, 500, 200), (x0 + 100, 500, 200),
                    (x0 + 100, 500, 330), (x0, 500, 330)], quad, m,
                   emission=lamp)
    return b.build(light_sampler="uniform", device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("light_sampler", ["power", "uniform"])
def test_megakernel_matches_plain(cuda_device, light_sampler):
    scene, cam = scenes.make_cornell_box(W, H, device=cuda_device)
    if light_sampler == "uniform":
        scene = _uniform_light_box(cuda_device)
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
    """Two levels: the instances golden's tables, 2^16 seeded box rays."""
    from pathlib import Path
    from pbrt_tpu_torch.ops import bvh2
    root = Path(__file__).resolve().parent.parent
    s = parser.parse_file(root / "scenes" / "instances.pbrt",
                          device=cuda_device).scene
    o, d = _box_rays((-6, -2, -6), (6, 2, 6), 1 << 16, 12, cuda_device)
    t_max = torch.full((1 << 16,), 30.0 if any_hit else 1e30,
                       device=cuda_device)
    tables = (s.tlas_nodes, s.inst_rows, s.tri_geo_tlas, s.tlas_root)
    before = bvh2.counter_two_level.launches
    got = bvh2.two_level_intersect(*tables, o, d, t_max, any_hit,
                                   depth=s.tlas_depth)
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
