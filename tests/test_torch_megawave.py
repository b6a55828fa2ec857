"""Port vs reference: the megakernel. The plain version
(pbrt_tpu_torch.ops.megawave.wave_full_plain, reached through the
trace_full wrapper on CPU tensors) against pbrt_tpu.ops.megawave.trace_full
in Pallas interpret mode, with the inputs of the reference's own
test_full_pipeline_matches_render_wave: cornell 16x16, 4 spp, sample index
2, max depth 4. The rays-in entry (megawave.trace, megakernel v1) and its
route inside path.trace_paths against the reference's trace and
trace_paths(megakernel=True) on the lanes of the reference's
test_cornell_is_eligible_and_matches_fused (sample index 1, pixel-centre
rays, max depth 4). Tolerance: the reference's kernel gate, relative error
< 1e-4 with a 1e-3 floor, per lane. The CUDA kernel is held to this plain
version on the card (tests/test_torch_cuda.py, chip_smoke.py)."""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from pbrt_tpu import filters as jflt  # noqa: E402
from pbrt_tpu import samplers as jsmp  # noqa: E402
from pbrt_tpu.ops import megawave as jmw  # noqa: E402
from pbrt_tpu.utils import spectrum as jspc  # noqa: E402
from pbrt_tpu_torch import filters as flt  # noqa: E402
from pbrt_tpu_torch import samplers as smp  # noqa: E402
from pbrt_tpu_torch import scenes  # noqa: E402
from pbrt_tpu_torch.ops import megawave  # noqa: E402
from pbrt_tpu_torch.utils import spectrum as spc  # noqa: E402

from _jax_export import export_cornell  # noqa: E402

torch.set_num_threads(1)
W = H = 16
SPP = 4
MAX_DEPTH = 4
SAMPLE = 2


def _rel(a, b):
    return np.abs(a - b) / np.maximum(np.abs(b), 1e-3)


@pytest.fixture(scope="module")
def lanes():
    """The reference's lanes and outputs for one 16x16 wave."""
    scene, cam, sampler, _arrays, _meta = export_cornell(W, H, SPP)
    pix = np.arange(W * H)
    px, py = pix % W, pix // W
    si = np.full(W * H, SAMPLE)
    u_lam = jsmp.sample_1d(sampler, jnp.asarray(px), jnp.asarray(py),
                           jnp.asarray(si), 5)
    lam = np.array(jspc.sample_visible_wavelengths(u_lam).lam)
    L, fw = jmw.trace_full(scene, sampler, cam, jflt.make_filter("gaussian"),
                           jnp.asarray(px), jnp.asarray(py), jnp.asarray(si),
                           jnp.asarray(lam), max_depth=MAX_DEPTH, rr_start=1,
                           interpret=True)
    return px, py, si, lam, np.array(L), np.array(fw)


def _port_inputs(lanes, device="cpu"):
    px, py, si, lam, _L, _fw = lanes
    scene, cam = scenes.make_cornell_box(W, H, device=device)
    sampler = smp.make_sampler("zsobol", spp=SPP, full_resolution=(W, H))
    return (scene, sampler, cam, flt.make_filter("gaussian"),
            *(torch.as_tensor(a, device=device) for a in (px, py, si, lam)))


def test_seed_table_and_sobol_columns_match_reference():
    seeds = megawave.seed_table(0, MAX_DEPTH)
    assert seeds.shape == (megawave.n_dims(MAX_DEPTH), 3)
    for d in (0, 5, 17, seeds.shape[0] - 1):
        assert tuple(int(x) for x in seeds[d]) == (
            jmw._hash_u32_host(d, 0, 0x9dbf6d7c), jmw._hash_u32_host(d, 0),
            jmw._hash_u32_host(d, 0, 0x4df5))
    c0, c1 = jmw._sobol_cols01()
    assert tuple(int(x) for x in megawave.sobol_cols01()) == c0 + c1


def test_wavelengths_match_reference(lanes):
    px, py, si, lam, _L, _fw = lanes
    sampler = smp.make_sampler("zsobol", spp=SPP, full_resolution=(W, H))
    u = smp.sample_1d(sampler, *(torch.as_tensor(a) for a in (px, py, si)),
                      5)
    swl = spc.sample_visible_wavelengths(u)
    # same u bit for bit; atanh may round one ulp apart from XLA's
    np.testing.assert_allclose(swl.lam.numpy(), lam, rtol=1e-6)


def test_plain_megakernel_matches_reference(lanes):
    _px, _py, _si, _lam, L_ref, fw_ref = lanes
    before = megawave.counter.launches
    L, fw = megawave.trace_full(*_port_inputs(lanes), max_depth=MAX_DEPTH,
                                rr_start=1)
    assert megawave.counter.launches == before   # CPU: the plain version
    assert L.shape == (W * H, 4) and fw.shape == (W * H,)
    assert np.all(np.isfinite(L.numpy())) and (L_ref > 0).mean() > 0.5
    assert _rel(L.numpy(), L_ref).max() < 1e-4
    assert _rel(fw.numpy(), fw_ref).max() < 1e-4


def _jax_uniform_light_box():
    """scenes.make_uniform_light_box, built by the reference's builder."""
    from pbrt_tpu.scene_core import SceneBuilder
    from pbrt_tpu.utils import color as jcolor
    b = SceneBuilder()
    m = b.materials.add_diffuse((0.6, 0.5, 0.4))
    quad = [[0, 1, 2], [0, 2, 3]]
    b.add_mesh([(556, 0, 0), (0, 0, 0), (0, 0, 560), (556, 0, 560)], quad, m)
    b.add_mesh([(556, 0, 560), (0, 0, 560), (0, 549, 560), (556, 549, 560)],
               quad, m)
    lamp = jcolor.RGBIlluminantSpectrum((8.0, 8.0, 8.0))
    for x0 in (100, 350):
        b.add_mesh([(x0, 500, 200), (x0 + 100, 500, 200),
                    (x0 + 100, 500, 330), (x0, 500, 330)], quad, m,
                   emission=lamp)
    return b.build(light_sampler="uniform")


def test_plain_megakernel_matches_reference_uniform_light_box(lanes):
    """The megakernel's uniform light pick: the port's uniform light box
    (the card tests' second scene) against the same scene built by the
    reference, on the 16x16 wave's lanes."""
    px, py, si, lam, _L, _fw = lanes
    _s, jcam, jsampler, _a, _m = export_cornell(W, H, SPP)
    L_ref, fw_ref = (np.array(x) for x in jmw.trace_full(
        _jax_uniform_light_box(), jsampler, jcam,
        jflt.make_filter("gaussian"), *(jnp.asarray(a) for a in
                                        (px, py, si, lam)),
        max_depth=MAX_DEPTH, rr_start=1, interpret=True))
    scene = scenes.make_uniform_light_box(device="cpu")
    assert scene.mega.ls_uniform and scene.mega.n_lights == 4
    _c, sampler, cam, filt, *rest = _port_inputs(lanes)
    L, fw = megawave.trace_full(scene, sampler, cam, filt, *rest,
                                max_depth=MAX_DEPTH, rr_start=1)
    assert (L_ref > 0).mean() > 0.25
    assert _rel(L.numpy(), L_ref).max() < 1e-4
    assert _rel(fw.numpy(), fw_ref).max() < 1e-4


def test_eligible_full_matches_reference_rule():
    scene, cam = scenes.make_cornell_box(8, 8, device="cpu")
    for spp, ok in ((4, True), (1 << 26, True), (1 << 27, False)):
        sampler = smp.make_sampler("zsobol", spp=spp, full_resolution=(8, 8))
        assert megawave.eligible_full(scene, sampler, cam,
                                      flt.make_filter("gaussian")) is ok



# ---------------------------------------------------------------------------
# Megakernel v1: camera rays given (reference megawave.trace and its route
# inside trace_paths), on the reference's own test lanes: cornell 16x16,
# 4 spp, sample index 1, pixel-centre camera rays, max depth 4.

@pytest.fixture(scope="module")
def ray_lanes():
    from pbrt_tpu import cameras as jcam
    from pbrt_tpu.integrators import path as jpath
    scene, cam, sampler, _arrays, _meta = export_cornell(W, H, SPP)
    pix = np.arange(W * H)
    px, py = jnp.asarray(pix % W), jnp.asarray(pix // W)
    si = jnp.full((W * H,), 1, jnp.int32)
    u_lens = jsmp.sample_2d(sampler, px, py, si, 3)
    swl = jspc.sample_visible_wavelengths(jsmp.sample_1d(sampler, px, py,
                                                         si, 5))
    p_film = jnp.stack([px + 0.5, py + 0.5], -1).astype(jnp.float32)
    o, d, _t, _w = jcam.generate_ray_weighted(cam, p_film, u_lens,
                                              jnp.zeros((W * H,)))
    L_trace = jmw.trace(scene, sampler, px, py, si, o, d, swl.lam,
                        max_depth=MAX_DEPTH, rr_start=1, interpret=True)
    L_paths = jpath.trace_paths(scene, sampler, px, py, si, o, d, swl,
                                jpath.PathOptions(max_depth=MAX_DEPTH,
                                                  megakernel=True))
    return dict(px=np.asarray(px), py=np.asarray(py), si=np.asarray(si),
                o=np.asarray(o), d=np.asarray(d), lam=np.asarray(swl.lam),
                pdf=np.asarray(swl.pdf), L_trace=np.asarray(L_trace),
                L_paths=np.asarray(L_paths))


def _port_rays(r):
    scene, _cam = scenes.make_cornell_box(W, H, device="cpu")
    sampler = smp.make_sampler("zsobol", spp=SPP, full_resolution=(W, H))
    px, py, si, o, d, lam = (torch.as_tensor(np.array(r[k])) for k in
                             ("px", "py", "si", "o", "d", "lam"))
    return scene, sampler, px, py, si, o, d, lam


def test_trace_matches_reference(ray_lanes):
    scene, sampler, px, py, si, o, d, lam = _port_rays(ray_lanes)
    before = (megawave.counter.plain, megawave.counter.launches)
    L = megawave.trace(scene, sampler, px, py, si, o, d, lam,
                       max_depth=MAX_DEPTH, rr_start=1)
    assert (megawave.counter.plain, megawave.counter.launches) == \
        (before[0] + 1, before[1])
    assert L.shape == (W * H, 4) and np.all(np.isfinite(L.numpy()))
    assert (ray_lanes["L_trace"] > 0).mean() > 0.5
    assert _rel(L.numpy(), ray_lanes["L_trace"]).max() < 1e-4


def test_trace_plain_is_the_full_path_loop_on_the_same_rays():
    """With the rays the in-kernel camera makes, the rays-in wave gives
    the full wave's L bit for bit: one path loop serves both."""
    scene, cam = scenes.make_cornell_box(W, H, device="cpu")
    sampler = smp.make_sampler("zsobol", spp=SPP, full_resolution=(W, H))
    pix = torch.arange(W * H)
    px, py, si = pix % W, pix // W, torch.full((W * H,), 3)
    lam = spc.sample_visible_wavelengths(smp.sample_1d(sampler, px, py, si,
                                                       5)).lam
    w = megawave.prepare_full(scene, sampler, cam, flt.make_filter("gaussian"),
                              px, py, si, lam, max_depth=MAX_DEPTH)
    zs = megawave._ZSobol(megawave.widen_mi(w.mi), w.seeds, w.B)
    o, d, _fw = megawave._camera_rays(w, zs)
    L_full, _ = megawave.wave_full_plain(w)
    L_rays = megawave.trace(scene, sampler, px, py, si, torch.stack(o, -1),
                            torch.stack(d, -1), lam, max_depth=MAX_DEPTH)
    assert torch.equal(L_full, L_rays)


def test_trace_paths_megakernel_true_matches_reference(ray_lanes,
                                                      monkeypatch):
    from pbrt_tpu_torch import scene_core
    from pbrt_tpu_torch.integrators import path as path_mod
    scene, sampler, px, py, si, o, d, lam = _port_rays(ray_lanes)
    swl = spc.SampledWavelengths(lam=lam, pdf=torch.as_tensor(
        np.array(ray_lanes["pdf"])))
    queries = []
    for name in ("intersect", "intersect_p"):
        real = getattr(scene_core, name)
        monkeypatch.setattr(scene_core, name, lambda *a, _f=real, **k:
                            queries.append(1) or _f(*a, **k))
    before = (megawave.counter.plain, megawave.counter.launches)
    L = path_mod.trace_paths(scene, sampler, px, py, si, o, d, swl,
                             path_mod.PathOptions(max_depth=MAX_DEPTH,
                                                  megakernel=True))
    # one plain megakernel run, no triangle query of the general wave
    assert (megawave.counter.plain - before[0],
            megawave.counter.launches - before[1], len(queries)) == (1, 0, 0)
    assert _rel(L.numpy(), ray_lanes["L_paths"]).max() < 1e-4


def test_megakernel_false_and_render_wave_never_reach_trace(ray_lanes,
                                                            monkeypatch):
    """megakernel=False, a time, and render_wave on every route stay off
    the rays-in megakernel; "auto" and True take it from trace_paths."""
    from pbrt_tpu_torch.integrators import path as path_mod
    scene, sampler, px, py, si, o, d, lam = _port_rays(ray_lanes)
    swl = spc.SampledWavelengths(lam=lam, pdf=torch.as_tensor(
        np.array(ray_lanes["pdf"])))
    calls = []
    real = megawave.trace
    monkeypatch.setattr(megawave, "trace",
                        lambda *a, **k: calls.append(1) or real(*a, **k))

    def paths(mk, **kw):
        return path_mod.trace_paths(scene, sampler, px, py, si, o, d, swl,
                                    path_mod.PathOptions(max_depth=2,
                                                         megakernel=mk),
                                    **kw)
    paths(False)
    paths(True, time=torch.zeros(W * H))
    assert calls == []
    paths("auto")
    paths(True)
    assert len(calls) == 2
    calls.clear()
    # render_wave: the in-kernel camera, or (a sampler too deep for the
    # in-kernel pixel decode) the general wave
    _s, cam = scenes.make_cornell_box(W, H, device="cpu")
    pix = torch.arange(W * H)
    deep = smp.make_sampler("zsobol", spp=1 << 27, full_resolution=(W, H))
    assert megawave.eligible(scene, deep)
    assert not megawave.eligible_full(scene, deep, cam,
                                      flt.make_filter("gaussian"))
    for mk in ("auto", True, False):
        for spl in (sampler, deep):
            path_mod.render_wave(scene, cam, spl, flt.make_filter("gaussian"),
                                 pix, si, path_mod.PathOptions(
                                     max_depth=2, megakernel=mk))
    assert calls == []
    with pytest.raises(ValueError, match="megakernel"):
        paths("yes")


# ---------------------------------------------------------------------------
# The kernel's Sobol' products (csrc/megawave.cu, ZSobol::product0/1) and
# the plain version's count of the kernel's work.

def _brev32(v):
    v = v.astype(np.uint64)
    out = np.zeros_like(v)
    for i in range(32):
        out |= ((v >> np.uint64(i)) & np.uint64(1)) << np.uint64(31 - i)
    return out.astype(np.uint32)


def _bytes_product(idx, tables):
    """The kernel's four byte-table lookups of dimension 1."""
    t = tables.reshape(4, 256)
    return (t[0][idx & 255] ^ t[1][(idx >> np.uint32(8)) & 255]
            ^ t[2][(idx >> np.uint32(16)) & 255] ^ t[3][idx >> np.uint32(24)])


@pytest.mark.parametrize("B", [8, 24, 32])
def test_sobol_table_forms_match_the_matrix_products(B):
    """Dimension 0's columns are 1 << (31 - i), so its product is the bit
    reversal; dimension 1's four byte tables give its 32-step product bit
    for bit: on seeded indices of B bits, on 0 and on 2^B - 1, against the
    port's and the reference's sobol_sample_u32."""
    from pbrt_tpu.utils import lowdiscrepancy as jld
    from pbrt_tpu_torch.utils import lowdiscrepancy as ld
    table = megawave.sobol_table()
    assert table.shape == (1024,) and table.dtype == np.uint32
    assert np.array_equal(megawave.sobol_cols01()[:32], np.uint32(1)
                          << np.arange(31, -1, -1, dtype=np.uint32))
    top = (1 << B) - 1
    rs = np.random.RandomState(B)
    idx = np.concatenate([[0, top], rs.randint(0, top + 1, 4096,
                                               dtype=np.int64)])
    idx = idx.astype(np.uint32)
    for dim, got in ((0, _brev32(idx)), (1, _bytes_product(idx, table))):
        port = ld.sobol_sample_u32(torch.as_tensor(idx.astype(np.int64)),
                                   dim).numpy().astype(np.uint32)
        ref = np.asarray(jld.sobol_sample_u32(jnp.asarray(idx), dim),
                         np.uint32)
        assert np.array_equal(port, ref)
        assert np.array_equal(got, ref), dim


def test_plain_work_counts(lanes):
    """The kernel's work as the plain version counts it: the per-depth live
    counts sum to live_lane_depths and shrink with depth; a shadow scan
    tests at least one group of four and at most every real triangle; the
    warp busy share is the share of live lanes in 32-lane warps."""
    scene, sampler, cam, filt, px, py, si, lam = _port_inputs(lanes)
    w = megawave.prepare_full(scene, sampler, cam, filt, px, py, si, lam,
                              max_depth=MAX_DEPTH, rr_start=1)
    megawave.wave_full_plain(w)
    work = megawave.counter.work
    live = work["live_by_depth"]
    n, n_real = W * H, w.n_real
    assert len(live) == MAX_DEPTH and live[0] == n
    assert sum(live) == work["live_lane_depths"]
    assert all(a >= b for a, b in zip(live, live[1:])) and live[-1] > 0
    assert work["hits"] <= work["live_lane_depths"]
    assert 0 < work["shadow_rays"] <= work["hits"]
    assert work["unoccluded"] <= work["shadow_rays"]
    assert (4 * work["shadow_rays"] <= work["shadow_tests"]
            <= n_real * work["shadow_rays"])
    # an unoccluded ray tests every real triangle
    assert work["shadow_tests"] >= n_real * work["unoccluded"]
    assert work["bsdf_samples"] <= work["hits"]
    assert work["rr_draws"] <= work["bsdf_samples"]
    assert 0 < work["emissions"] <= work["hits"]
    # busy share: live lane-depths over 32 x each warp's longest path
    assert sum(live) / (MAX_DEPTH * n) <= work["warp_busy_share"] <= 1.0
    lens = torch.tensor([[4] + [1] * 31, [2] * 32])
    assert megawave._warp_busy_share(lens.reshape(-1)) == \
        (4 + 31 + 64) / (32 * (4 + 2))
