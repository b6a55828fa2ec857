"""Port vs reference: the volumetric path integrator
(integrators/volpath.py) and the medium interfaces.

- float32 log1p, the flight's free-path draw: torch and XLA round 7.3% of
  the draws 1 ulp apart (4M seeded draws); the port's value is within 1 ulp
  of float64's log1p on every draw (measured 0.62 ulp), and the nearer one
  on >= 90% of the draws that differ (measured 92%). Where a draw lands
  within that ulp of a cell's exit, `t < t_exit_cell` flips and the lane
  takes another branch. The witness: every lane below that leaves its
  tolerance comes within it when the port replays the call with XLA's
  log1p values (torch.log1p patched);
- sample_t_maj and transmittance_ratio on 8,192 seeded rays through
  volume.pbrt's grid (its super-grid, both box lookups and a ray-carried
  medium): status equal and t, g, beta, r_u, r_l (T_ray, r_l, r_u) within
  rtol 1e-4 on >= 99.5% of the lanes, the rest witnessed (measured: every
  lane, no flip in 8,192); the 512-event cap ends a still-flying lane as
  EV_REACH in both (the cap lowered to 3 in both packages);
- intersect_interfaces against the reference's on seeded rays, the
  12-triangle box (tensor code) and a 320-triangle icosphere shell (above
  256: the BVH and the single-level bvh2 kernel's plain version): hit, t,
  normal and media equal or within rtol 1e-5;
- the general wave, volpath.trace_paths against the reference's, on a
  16x16, 4 spp crop of scenes/volume.pbrt (depth 6; kernel 1's plain
  version, the 12-triangle interface box) and on scenes.make_medium_shell
  (a homogeneous medium inside the 320-triangle shell under an area lamp,
  depth 5; the reference's scene built by its own builder): rel 1e-4 on
  >= 99% of lanes and the mean L within 1e-3 (test_torch_path_general.py's
  gate), the rest witnessed as above;
- render() picks volpath for a scene with media (reference wave_module);
  the parse entry points keep their card default; a subprocess imports and
  runs the new modules and shows no jax and no pbrt_tpu module loaded.
"""
import os
import subprocess
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from pbrt_tpu import scene_core as jsc  # noqa: E402
from pbrt_tpu.integrators import path as jpath  # noqa: E402
from pbrt_tpu.integrators import volpath as jvol  # noqa: E402
from pbrt_tpu.scene import parser as jparser  # noqa: E402
from pbrt_tpu.utils import spectrum as jspc  # noqa: E402
from pbrt_tpu_torch import scene_core as sc  # noqa: E402
from pbrt_tpu_torch import scenes  # noqa: E402
from pbrt_tpu_torch import spans  # noqa: E402
from pbrt_tpu_torch.integrators import path as path_mod  # noqa: E402
from pbrt_tpu_torch.integrators import render  # noqa: E402
from pbrt_tpu_torch.integrators import volpath  # noqa: E402
from pbrt_tpu_torch.ops import bvh2  # noqa: E402
from pbrt_tpu_torch.ops import tri_intersect as ti  # noqa: E402
from pbrt_tpu_torch.scene import parser  # noqa: E402

from test_torch_path_general import _hold  # noqa: E402

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
SCENES = ROOT / "scenes"
N = 8192


def _log1p_pair(u):
    return (torch.log1p(-torch.as_tensor(u)).numpy(),
            np.asarray(jnp.log1p(-jnp.asarray(u))))


def test_log1p_rounding_witness():
    u = np.random.default_rng(0).integers(0, 2 ** 24, 4_000_000).astype(
        np.float32) * np.float32(2.0 ** -24)
    a, b = _log1p_pair(u)
    exact = np.log1p(-u.astype(np.float64))
    diff = a != b
    ulps = np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))
    err_a = np.abs(a - exact) / np.spacing(np.abs(a))
    print(f"log1p: {diff.mean():.2%} of draws an ulp apart; the port's "
          f"largest error {err_a.max():.3f} ulp")
    assert ulps.max() <= 1 and 0.0 < diff.mean() < 0.15
    assert err_a.max() <= 1.0
    nearer = np.abs(a - exact)[diff] <= np.abs(b - exact)[diff]
    assert nearer.mean() >= 0.9


@pytest.fixture(scope="module")
def volume():
    return (jparser.parse_file(SCENES / "volume.pbrt"),
            parser.parse_file(SCENES / "volume.pbrt", device="cpu"))


def _flight_inputs(seed=5):
    """Seeded rays at and through volume.pbrt's box, wavelengths, seeds
    and path state."""
    rs = np.random.default_rng(seed)
    o = rs.uniform(-2.5, 2.5, (N, 3)).astype(np.float32)
    o[: N // 4] = rs.uniform(-1.1, 1.1, (N // 4, 3))      # inside
    tgt = rs.uniform(-0.8, 0.8, (N, 3))
    d = tgt - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t_max = rs.uniform(0.5, 8.0, N).astype(np.float32)
    t_max[::7] = np.inf
    lam = rs.uniform(360, 830, (N, 4)).astype(np.float32)
    seeds = rs.integers(0, 2 ** 32, N, dtype=np.uint64).astype(np.int64)
    active = rs.uniform(size=N) < 0.95
    beta = rs.uniform(0.2, 1.0, (N, 4)).astype(np.float32)
    r_u = rs.uniform(0.5, 1.5, (N, 4)).astype(np.float32)
    r_l = rs.uniform(0.5, 1.5, (N, 4)).astype(np.float32)
    return o, d, t_max, lam, seeds, active, beta, r_u, r_l


def _xla_log1p(x):
    """torch.log1p's stand-in for a replay: XLA's float32 log1p."""
    return torch.as_tensor(np.asarray(jnp.log1p(jnp.asarray(x.numpy()))))


def _outside(got, want, keys):
    """Lanes where a key leaves rtol 1e-4 of the lane's vector (floor
    1e-6), or an int or bool differs."""
    bad = np.zeros(len(np.asarray(want[keys[0]])), bool)
    for k in keys:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        if a.dtype == bool or np.issubdtype(a.dtype, np.integer):
            bad |= a != b
            continue
        scale = np.maximum(np.abs(b).reshape(len(b), -1).max(-1), 1e-6)
        err = np.abs(a - b).reshape(len(a), -1).max(-1) / scale
        bad |= ~(err < 1e-4) & ~(np.isinf(a) & np.isinf(b)).reshape(
            len(a), -1).all(-1)
    return bad


def _check(run, want, keys, label, monkeypatch):
    """run() -> the port's dict, against the reference's `want`: every lane
    within rtol 1e-4 but < 0.5%; those (log1p's flips) within it when the
    port replays the call with XLA's log1p values (the witness)."""
    bad = _outside(run(), want, keys)
    print(f"{label}: {bad.sum()} of {len(bad)} lanes outside rtol 1e-4 "
          "(log1p's flips)")
    assert bad.mean() < 0.005
    if bad.any():
        with monkeypatch.context() as m:
            m.setattr(torch, "log1p", _xla_log1p)
            replay = _outside(run(), want, keys)
        assert not replay[bad].any(), np.nonzero(bad & replay)[0][:10]
    return bad


@pytest.mark.parametrize("carried", [False, True])
def test_sample_t_maj_matches_reference(volume, carried, monkeypatch):
    dj, dp = volume
    o, d, t_max, lam, seeds, active, beta, r_u, r_l = _flight_inputs()
    cur = None
    if carried:
        cur = volpath.medium_index_at(dp.scene.media, torch.as_tensor(o))
    def run():
        r = volpath.sample_t_maj(
            dp.scene, *(torch.as_tensor(x) for x in (
                o, d, t_max, lam, seeds, active, beta, r_u, r_l)),
            cur_med=cur)
        return {k: v.numpy() for k, v in r.items()}
    want = jvol.sample_t_maj(
        dj.scene, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max),
        jnp.asarray(lam), jnp.asarray(seeds.astype(np.uint32)),
        jnp.asarray(active), jnp.asarray(beta), jnp.asarray(r_u),
        jnp.asarray(r_l),
        cur_med=None if cur is None else jnp.asarray(cur.numpy(),
                                                     jnp.int32))
    want = {k: np.asarray(v) for k, v in want.items()}
    assert {0, 1, 2} <= set(want["status"].tolist())
    _check(run, want, ("status", "t", "g", "beta", "r_u", "r_l"),
           f"sample_t_maj (ray-carried medium {carried})", monkeypatch)


def test_transmittance_ratio_matches_reference(volume, monkeypatch):
    dj, dp = volume
    o, d, t_max, lam, seeds, active, _b, _u, _l = _flight_inputs(6)
    t_max = np.where(np.isinf(t_max), 9.0, t_max).astype(np.float32)
    def run():
        r = volpath.transmittance_ratio(
            dp.scene, *(torch.as_tensor(x) for x in (o, d, t_max, lam, seeds,
                                                     active)))
        return dict(zip(("T", "r_l", "r_u"), (x.numpy() for x in r)))
    want = jvol.transmittance_ratio(
        dj.scene, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max),
        jnp.asarray(lam), jnp.asarray(seeds.astype(np.uint32)),
        jnp.asarray(active))
    want = dict(zip(("T", "r_l", "r_u"), (np.asarray(x) for x in want)))
    T = want["T"]
    assert (T == 0).all(-1).mean() > 0.05 and (T == 1).all(-1).mean() > 0.05
    _check(run, want, ("T", "r_l", "r_u"), "transmittance_ratio",
           monkeypatch)


def test_flight_cap_ends_as_reach(volume, monkeypatch):
    dj, dp = volume
    monkeypatch.setattr(volpath, "MAX_FLIGHT_EVENTS", 3)
    monkeypatch.setattr(jvol, "_MAX_FLIGHT_EVENTS", 3)
    o, d, t_max, lam, seeds, active, beta, r_u, r_l = _flight_inputs(7)
    got = volpath.sample_t_maj(
        dp.scene, *(torch.as_tensor(x) for x in (o, d, t_max, lam, seeds,
                                                 active, beta, r_u, r_l)))
    want = jvol.sample_t_maj(
        dj.scene, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max),
        jnp.asarray(lam), jnp.asarray(seeds.astype(np.uint32)),
        jnp.asarray(active), jnp.asarray(beta), jnp.asarray(r_u),
        jnp.asarray(r_l))
    assert int(want["n_iters"]) == 3
    np.testing.assert_array_equal(got["status"].numpy(),
                                  np.asarray(want["status"]))
    # the capped loop stopped at 3 steps, lanes that would scatter or be
    # absorbed later reach
    monkeypatch.setattr(volpath, "MAX_FLIGHT_EVENTS", 512)
    steps = spans.counter("flight.steps")
    uncapped = volpath.sample_t_maj(
        dp.scene, *(torch.as_tensor(x) for x in (o, d, t_max, lam, seeds,
                                                 active, beta, r_u, r_l)))
    assert spans.counter("flight.steps") - steps > 3
    assert (got["status"] != volpath.EV_REACH).sum() < \
        (uncapped["status"] != volpath.EV_REACH).sum()


def _reference_shell():
    """The reference's build of scenes.make_medium_shell's scene."""
    from pbrt_tpu.utils import color as jcolor
    verts, faces, _n = scenes.make_sphere_mesh((0.0, 0.8, 0.0), 1.0, 2)
    b = jsc.SceneBuilder()
    m = b.materials.add_diffuse((0.6, 0.55, 0.5))
    quad = [[0, 1, 2], [0, 2, 3]]
    b.add_mesh(np.asarray([[-4, -0.3, -4], [4, -0.3, -4], [4, -0.3, 4],
                           [-4, -0.3, 4]], np.float32), quad, m)
    b.add_mesh(np.asarray([[-0.6, 2.5, -0.6], [0.6, 2.5, -0.6],
                           [0.6, 2.5, 0.6], [-0.6, 2.5, 0.6]], np.float32),
               quad, m, emission=jcolor.RGBIlluminantSpectrum((9, 8, 7),
                                                              b.cs))
    med = b.media.add_homogeneous(sigma_a=(0.3, 0.2, 0.1),
                                  sigma_s=(1.2, 1.5, 1.8), g=0.4,
                                  bounds_lo=(-1.05, -0.25, -1.05),
                                  bounds_hi=(1.05, 1.85, 1.05))
    b.add_interface_mesh(verts, faces, med_in=med, med_out=-1)
    return b.build()


@pytest.fixture(scope="module")
def shell():
    """(the reference's scene, the port's scene, the port's camera) of
    scenes.make_medium_shell at 16x16."""
    sp, cam = scenes.make_medium_shell(16, 16, device="cpu")
    return _reference_shell(), sp, cam


def test_interface_tables_match_reference(shell, volume):
    sj, sp, _cam = shell
    assert sp.iface_tris.shape[0] == 320 and sp.use_iface_bvh
    np.testing.assert_array_equal(sp.iface_tris.numpy(),
                                  np.asarray(sj.iface_tris))
    np.testing.assert_array_equal(sp.iface_med.numpy(),
                                  np.asarray(sj.iface_med))
    np.testing.assert_array_equal(sp.iface_tris_bvh.numpy(),
                                  np.asarray(sj.iface_tris_bvh))
    np.testing.assert_array_equal(sp.iface_nodes.numpy(),
                                  np.asarray(sj.iface_bvh.nodes))
    assert sp.has_media and sp.mega is None and sj.mega is None
    assert not volume[1].scene.use_iface_bvh


@pytest.mark.parametrize("which", ["box", "shell"])
def test_intersect_interfaces_matches_reference(shell, volume, which):
    sj, sp = shell[:2] if which == "shell" else (volume[0].scene,
                                                 volume[1].scene)
    rs = np.random.default_rng(3)
    c = np.asarray([0.0, 0.8, 0.0]) if which == "shell" else np.zeros(3)
    o = (c + rs.uniform(-2.5, 2.5, (4096, 3))).astype(np.float32)
    d = c + rs.uniform(-0.7, 0.7, (4096, 3)) - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t_max = rs.uniform(1.0, 6.0, 4096).astype(np.float32)
    before = bvh2.counter_bvh2.plain
    got = sc.intersect_interfaces(sp, torch.as_tensor(o), torch.as_tensor(d),
                                  torch.as_tensor(t_max))
    assert bvh2.counter_bvh2.plain - before == int(which == "shell")
    want = jsc.intersect_interfaces(sj, jnp.asarray(o), jnp.asarray(d),
                                    jnp.asarray(t_max))
    hit = got["hit"].numpy()
    np.testing.assert_array_equal(hit, np.asarray(want["hit"]))
    assert 0.2 < hit.mean() < 0.95
    np.testing.assert_allclose(got["t"].numpy()[hit],
                               np.asarray(want["t"])[hit], rtol=1e-5)
    np.testing.assert_allclose(got["ng"].numpy()[hit],
                               np.asarray(want["ng"])[hit], rtol=1e-5,
                               atol=1e-6)
    for k in ("med_in", "med_out"):
        np.testing.assert_array_equal(got[k].numpy()[hit],
                                      np.asarray(want[k])[hit])


def _vol_wave(sj, sp, camera, sampler, W, H, spp, depth, monkeypatch):
    """One W x H x spp wave through both volumetric waves, from the port's
    camera rays, held under test_torch_path_general.py's gate; lanes
    outside rel 1e-4 are held to it when the port replays the wave with
    XLA's log1p values (the witness)."""
    pix = torch.as_tensor(np.tile(np.arange(W * H), spp))
    si = torch.as_tensor(np.repeat(np.arange(spp), W * H))
    px, py, swl = path_mod.camera_lanes(camera, sampler, pix, si)
    o, d, _fw = path_mod.camera_rays(camera, sampler,
                                     path_mod.flt.make_filter("gaussian"),
                                     px, py, si)
    def run():
        return volpath.trace_paths(sp, sampler, px, py, si, o, d, swl,
                                   path_mod.PathOptions(max_depth=depth))
    L = run().numpy()
    from pbrt_tpu import samplers as jsmp
    jsampler = jsmp.make_sampler("zsobol", spp=spp, full_resolution=(W, H))
    assert (jsampler.seed, jsampler.log2_spp) == (sampler.seed,
                                                  sampler.log2_spp)
    L_ref = jvol.trace_paths(
        sj, jsampler, jnp.asarray(px), jnp.asarray(py), jnp.asarray(si),
        jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
        jspc.SampledWavelengths(lam=jnp.asarray(swl.lam.numpy()),
                                pdf=jnp.asarray(swl.pdf.numpy())),
        jpath.PathOptions(max_depth=depth, megakernel=False,
                          compaction=False))
    L_ref = np.asarray(L_ref)
    rel = (np.abs(L - L_ref) / np.maximum(np.abs(L_ref), 1e-3)).max(axis=1)
    if (rel >= 1e-4).any():
        with monkeypatch.context() as m:
            m.setattr(torch, "log1p", _xla_log1p)
            L2 = run().numpy()
        rel2 = (np.abs(L2 - L_ref) / np.maximum(np.abs(L_ref), 1e-3)).max(1)
        assert (rel2[rel >= 1e-4] < 1e-4).all()
    return L, L_ref


def test_volpath_wave_volume_crop_matches_reference(monkeypatch):
    W = H = 16
    text = (SCENES / "volume.pbrt").read_text().replace(
        '"integer xresolution" [200] "integer yresolution" [200]',
        f'"integer xresolution" [{W}] "integer yresolution" [{H}]').replace(
        '"integer pixelsamples" [32]', '"integer pixelsamples" [4]')
    dj = jparser.parse_string(text, base_dir=str(SCENES))
    dp = parser.parse_string(text, base_dir=str(SCENES), device="cpu")
    before = ti.counter.plain
    L, L_ref = _vol_wave(dj.scene, dp.scene, dp.camera, dp.sampler, W, H, 4,
                         6, monkeypatch)
    assert ti.counter.plain > before
    assert (L_ref > 0).any(axis=1).mean() > 0.9
    _hold(L, L_ref, "volume crop, volpath")


def test_volpath_wave_interface_shell_matches_reference(shell, monkeypatch):
    sj, sp, cam = shell
    from pbrt_tpu_torch import samplers as smp
    sampler = smp.make_sampler("zsobol", spp=4, full_resolution=(16, 16))
    before = bvh2.counter_bvh2.plain
    L, L_ref = _vol_wave(sj, sp, cam, sampler, 16, 16, 4, 5, monkeypatch)
    assert bvh2.counter_bvh2.plain > before     # the interface BVH route
    assert (L_ref > 0).any(axis=1).mean() > 0.3
    _hold(L, L_ref, "320-triangle interface shell, volpath")


def test_render_picks_volpath(volume):
    _dj, dp = volume
    assert render.wave_module(dp.scene) is volpath
    sp, cam = scenes.make_cornell_box(4, 4, device="cpu")
    assert render.wave_module(sp) is path_mod
    import dataclasses
    small = dataclasses.replace(dp.camera, width=8, height=8)
    img, stats = render.render(dp.scene, small, spp=1, device="cpu",
                               opts=path_mod.PathOptions(max_depth=3))
    assert img.shape == (8, 8, 3) and np.isfinite(img).all()
    assert img.mean() > 0


def test_entry_points_keep_the_card_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default builds there")
    for name in ("volume", "plytex"):
        with pytest.raises(Exception):
            parser.parse_file(SCENES / f"{name}.pbrt")


def test_new_modules_import_no_jax():
    code = (
        "import sys, dataclasses, torch\n"
        "from pbrt_tpu_torch import media, models, scenes, spans\n"
        "from pbrt_tpu_torch.integrators import render, volpath, path\n"
        "from pbrt_tpu_torch.ops import intersect\n"
        "from pbrt_tpu_torch.scene import parser\n"
        "from pbrt_tpu_torch.utils import sampling, rng\n"
        "s, cam = models.material_showcase(8, 6, device='cpu')\n"
        "assert s.n_spheres == 3\n"
        "img, _ = render.render(s, cam, spp=1, device='cpu',\n"
        "                       opts=path.PathOptions(max_depth=2))\n"
        "for name in ('volume', 'plytex'):\n"
        "    d = parser.parse_file(f'scenes/{name}.pbrt', device='cpu')\n"
        "    cam = dataclasses.replace(d.camera, width=4, height=4)\n"
        "    img, _ = render.render(d.scene, cam, spp=1, device='cpu',\n"
        "                           opts=path.PathOptions(max_depth=2))\n"
        "    assert img.shape == (4, 4, 3)\n"
        "assert spans.counter('flight.calls') > 0\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'pbrt_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[-1] == "ok"
