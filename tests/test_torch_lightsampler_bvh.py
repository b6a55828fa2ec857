"""Port vs reference: the many-light path (scenes/manylight.pbrt, 1,152
emissive triangles of 1,324, and scenes/manylight16k.pbrt, 16,928 of
17,100, both under "string lightsampler" "bvh").

Inputs are the scene files or made from numpy seeds, and go through the
reference's function and the port's:
- the light BVH: the light bounds the two parsers hand the sampler
  (np.array_equal), then on those and on seeded sets of 1-300 lights
  (some infinite, some without power) the builds (nodes, bit trails,
  depths, the outside lights: np.array_equal); _child_importance,
  sample_bvh_light and pmf_bvh_light at seeded shading points (rtol 1e-5
  on >= 95% of values (0.7-2.1% measured beyond it on the scenes' lights,
  none on the seeded sets), the pick equal on >= 99.9% of lanes; where a value
  differs by more, torch's and XLA's float32 acos rounding an ulp apart,
  the port's float64 function is the witness: the port no farther from it
  than twice the reference, ROADMAP.md section 3); the pmf summed
  over every light the sampler can pick is 1 within 1e-5 at each point;
  a sample's pmf is pmf_bvh_light of its pick;
- the exhaustive sampler: the same checks;
- make_light_sampler's fall-through to the uniform sampler;
- a bvh or exhaustive sampler with an infinite light: the reference's
  wave fails (its escape branches read a pmf_table the sampler lacks),
  the port raises NotImplementedError at build;
- the megakernel refuses the bvh sampler;
- the general wave (trace_paths(megakernel=False)) on manylight at 16x16,
  4 spp, depth 3 (bvh and exhaustive) and on a 12x12-pixel crop of
  manylight16k at 4 spp, held under test_torch_path_general.py's gate
  (rel 1e-4 on >= 99% of lanes, mean L within 1e-3).
"""
import dataclasses
import os
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from pbrt_tpu import lightsampler_bvh as jlb  # noqa: E402
from pbrt_tpu import lightsamplers as jls  # noqa: E402
from pbrt_tpu.integrators import path as jpath  # noqa: E402
from pbrt_tpu.scene import parser as jparser  # noqa: E402
from pbrt_tpu.utils import spectrum as jspc  # noqa: E402
from pbrt_tpu_torch import cameras  # noqa: E402
from pbrt_tpu_torch import convert  # noqa: E402
from pbrt_tpu_torch import lightsampler_bvh as lb  # noqa: E402
from pbrt_tpu_torch import lightsamplers as lsamp  # noqa: E402
from pbrt_tpu_torch.integrators import path as path_mod  # noqa: E402
from pbrt_tpu_torch.ops import bvh8  # noqa: E402
from pbrt_tpu_torch.ops import tri_intersect as ti  # noqa: E402
from pbrt_tpu_torch.scene import parser  # noqa: E402

from _jax_export import export, reference_keeps_spectra  # noqa: E402
from test_torch_path_general import _hold  # noqa: E402

torch.set_num_threads(1)
SCENES = Path(__file__).resolve().parent.parent / "scenes"
N = 4096
KEYS = ("nodes", "bit_trail", "trail_len", "outside", "pmf_outside")
BOUND_KEYS = ("bounds_lo", "bounds_hi", "axis_w", "cos_theta_o",
              "cos_theta_e", "power", "is_infinite")


def _text(name, sampler="bvh", res=None, spp=None):
    t = (SCENES / f"{name}.pbrt").read_text()
    t = t.replace('"string lightsampler" "bvh"',
                  f'"string lightsampler" "{sampler}"')
    if res is not None:
        t = t.replace('"integer xresolution" [200] "integer yresolution" '
                      '[200]', f'"integer xresolution" [{res}] '
                      f'"integer yresolution" [{res}]')
    if spp is not None:
        t = t.replace('"integer pixelsamples" [32]',
                      f'"integer pixelsamples" [{spp}]')
    return t


def _parse_both(text, monkeypatch=None):
    """The reference's and the port's parse of text, each with the light
    bounds its builder handed make_light_sampler."""
    seen = {}

    def spy(module, key):
        fn = module.make_light_sampler

        def wrapped(kind, powers, light_bounds=None, **kw):
            seen[key] = light_bounds
            return fn(kind, powers, light_bounds=light_bounds, **kw)
        return fn, wrapped

    fj, wj = spy(jls, "ref")
    fp, wp = spy(lsamp, "port")
    jls.make_light_sampler, lsamp.make_light_sampler = wj, wp
    try:
        with reference_keeps_spectra():
            dj = jparser.parse_string(text, base_dir=str(SCENES))
        dp = parser.parse_string(text, base_dir=str(SCENES), device="cpu")
    finally:
        jls.make_light_sampler, lsamp.make_light_sampler = fj, fp
    return dj, dp, seen["ref"], seen["port"]


@pytest.fixture(scope="module")
def scenes_parsed():
    """manylight at 16x16x4 and manylight16k at its full 200x200 (for the
    crop) at 4 spp, parsed by both packages."""
    return {"manylight": _parse_both(_text("manylight", res=16, spp=4)),
            "manylight16k": _parse_both(_text("manylight16k", spp=4))}


def _seeded_bounds(n, seed):
    """n lights: boxes (a fifth of them points), random cone axes, one- or
    two-sided cones, a tenth without power, a twentieth infinite."""
    rs = np.random.RandomState(seed)
    lo = rs.uniform(-5, 5, (n, 3)).astype(np.float32)
    ext = rs.uniform(0, 1, (n, 3)) * (rs.uniform(size=(n, 1)) > 0.2)
    w = rs.normal(size=(n, 3))
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    return dict(
        bounds_lo=lo, bounds_hi=(lo + ext).astype(np.float32),
        axis_w=w.astype(np.float32),
        cos_theta_o=np.where(rs.uniform(size=n) < 0.5, -1.0,
                             rs.uniform(-1, 1, n)).astype(np.float32),
        cos_theta_e=rs.uniform(0, 1, n).astype(np.float32),
        power=rs.uniform(0.1, 10, n) * (rs.uniform(size=n) > 0.1),
        is_infinite=rs.uniform(size=n) < 0.05)


CASES = ["manylight", "manylight16k", "seeded-1", "seeded-7", "seeded-300"]


@pytest.fixture(scope="module")
def cases(scenes_parsed):
    """name -> (bounds, the reference's sampler, the port's, seeded
    shading points (N, 3) in the lights' world box +- 2)."""
    out = {}
    for name in CASES:
        if name.startswith("seeded"):
            b = _seeded_bounds(int(name.split("-")[1]), 11)
        else:
            b = scenes_parsed[name][3]
        rs = np.random.RandomState(5)
        lo = b["bounds_lo"].min(axis=0) - 2
        hi = b["bounds_hi"].max(axis=0) + 2
        p = rs.uniform(lo, hi, (N, 3)).astype(np.float32)
        out[name] = (b, jlb.build_bvh_light_sampler(**b),
                     lb.build_bvh_light_sampler(**b, device="cpu"), p)
    return out


@pytest.mark.parametrize("name", ["manylight", "manylight16k"])
def test_parsed_light_bounds_match_reference(scenes_parsed, name):
    _dj, dp, b_ref, b = scenes_parsed[name]
    assert dp.scene.light_sampler.kind == lsamp.LS_BVH
    for k in BOUND_KEYS:
        np.testing.assert_array_equal(b[k], np.asarray(b_ref[k]), err_msg=k)
    n = {"manylight": 1152, "manylight16k": 16928}[name]
    assert len(b["power"]) == n and not b["is_infinite"].any()


@pytest.mark.parametrize("name", CASES)
def test_build_matches_reference(cases, name):
    _b, lj, lp, _p = cases[name]
    for k in KEYS:
        np.testing.assert_array_equal(getattr(lp, k).numpy(),
                                      np.asarray(getattr(lj, k)), err_msg=k)
    assert (lp.n_lights, lp.max_depth, lp.p_outside) == \
        (lj.n_lights, lj.max_depth, lj.p_outside)
    if name == "manylight16k":
        assert lp.max_depth == 15 and lp.nodes.shape == (16927, 28)


def _held_to_f64(got, want, w64, label):
    """The port's values (got) against the reference's (want): the same
    zeros; rtol 1e-5 on >= 95% of them (torch's and XLA's float32 acos
    round an ulp apart, and cos(theta') near 0 turns an ulp of angle into
    up to ~1e-3 of importance, which the pmf's product carries); the value
    in float64 (w64, the port's function in float64) is the witness: the
    port's largest relative error to it, where the packages differ beyond
    rtol 1e-5, at most twice the reference's, and over all values its
    99th percentile at most twice the reference's."""
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
    off = rel > 1e-5
    np.testing.assert_array_equal(got == 0, want == 0)
    lit = w64 > 0
    err, err_ref = (np.abs(x - w64) / np.maximum(w64, 1e-300)
                    for x in (got, want))
    print(f"{label}: {off.sum()} of {len(got)} beyond rtol 1e-5 (max rel "
          f"{rel.max():.3g}); relative error to float64 there: port "
          f"{err[off].max(initial=0):.3g}, reference "
          f"{err_ref[off].max(initial=0):.3g}")
    assert off.mean() <= 0.05
    assert err[off].max(initial=0) <= 2 * err_ref[off].max(initial=0) + 1e-6
    if lit.any():
        assert np.percentile(err[lit], 99) <= \
            2 * np.percentile(err_ref[lit], 99) + 1e-7


def _f64(ls):
    """The sampler's tables in float64 (the witness's)."""
    if ls.kind == lsamp.LS_BVH:
        return dataclasses.replace(ls, nodes=ls.nodes.double(),
                                   pmf_outside=ls.pmf_outside.double())
    return dataclasses.replace(ls, cols=ls.cols.double(),
                               is_inf=ls.is_inf.double())


def _importance64(rows, p, n_ref=None):
    return lb._child_importance(
        torch.as_tensor(rows).double(), torch.as_tensor(p).double(),
        None if n_ref is None else torch.as_tensor(n_ref).double()).numpy()


@pytest.mark.parametrize("name", CASES)
def test_child_importance_matches_reference(cases, name):
    _b, _lj, lp, p = cases[name]
    rs = np.random.RandomState(6)
    rows = lp.nodes.numpy()[rs.randint(0, lp.nodes.shape[0], N)]
    for half in (slice(0, 14), slice(14, 28)):
        got = lb._child_importance(torch.as_tensor(rows[:, half]),
                                   torch.as_tensor(p)).numpy()
        want = np.asarray(jlb._child_importance(jnp.asarray(rows[:, half]),
                                                jnp.asarray(p), None))
        _held_to_f64(got, want, _importance64(rows[:, half], p),
                     f"{name} importance {half}")
    # the receiver-normal bound the exhaustive sampler may take
    n_ref = rs.normal(size=(N, 3)).astype(np.float32)
    got = lb._child_importance(torch.as_tensor(rows[:, :14]),
                               torch.as_tensor(p),
                               torch.as_tensor(n_ref)).numpy()
    want = np.asarray(jlb._child_importance(
        jnp.asarray(rows[:, :14]), jnp.asarray(p), jnp.asarray(n_ref)))
    _held_to_f64(got, want, _importance64(rows[:, :14], p, n_ref),
                 f"{name} importance with n_ref")


@pytest.mark.parametrize("name", CASES)
def test_sample_and_pmf_match_reference(cases, name):
    _b, lj, lp, p = cases[name]
    rs = np.random.RandomState(7)
    u = rs.uniform(size=N).astype(np.float32)
    li, pmf, _u = lb.sample_bvh_light(lp, torch.as_tensor(p), None,
                                      torch.as_tensor(u))
    li_j, pmf_j, _uj = jlb.sample_bvh_light(lj, jnp.asarray(p), None,
                                            jnp.asarray(u))
    same = li.numpy() == np.asarray(li_j)
    print(f"{name}: the pick equal on {same.mean():.4%} of {N} lanes")
    assert same.mean() >= 0.999
    p64 = torch.as_tensor(p).double()
    w64 = lb.pmf_bvh_light(_f64(lp), p64, None, li).numpy()
    _held_to_f64(pmf.numpy()[same], np.asarray(pmf_j)[same], w64[same],
                 f"{name} sample pmf")
    idx = torch.as_tensor(rs.randint(0, lp.n_lights, N))
    _held_to_f64(lb.pmf_bvh_light(lp, torch.as_tensor(p), None, idx).numpy(),
                 np.asarray(jlb.pmf_bvh_light(lj, jnp.asarray(p), None,
                                              jnp.asarray(idx.numpy()))),
                 lb.pmf_bvh_light(_f64(lp), p64, None, idx).numpy(),
                 f"{name} pmf_bvh_light")
    # a sample's pmf is the pmf of its pick: the same walk
    np.testing.assert_array_equal(
        lb.pmf_bvh_light(lp, torch.as_tensor(p), None, li).numpy(),
        pmf.numpy())


def _pmf_sums(pmf_of, b, p, n_points=6):
    """The pmf summed (float64) over every light the sampler can pick (the
    ones with power) at each of n_points points."""
    L = len(b["power"])
    can = torch.as_tensor(np.asarray(b["power"]) > 0)
    sums = []
    for k in range(n_points):
        pk = torch.as_tensor(np.repeat(p[k:k + 1], L, 0))
        pm = pmf_of(pk, torch.arange(L))
        sums.append(float(pm[can].double().sum()))
    return np.asarray(sums)


@pytest.mark.parametrize("name", CASES)
def test_pmf_sums_to_one(cases, name):
    b, _lj, lp, p = cases[name]
    sums = _pmf_sums(lambda pk, i: lb.pmf_bvh_light(lp, pk, None, i), b, p)
    np.testing.assert_allclose(sums, 1.0, atol=1e-5)


@pytest.mark.parametrize("name", CASES)
def test_exhaustive_sampler_matches_reference(cases, name):
    b, _lj, _lp, p = cases[name]
    n = 512 if name == "manylight16k" else N   # (n, L) matrices
    p = p[:n]
    ej = jls.make_light_sampler("exhaustive", b["power"], light_bounds=b)
    ep = lsamp.make_light_sampler("exhaustive", b["power"], light_bounds=b,
                                  device="cpu")
    assert ep.kind == ej.kind == lsamp.LS_EXHAUSTIVE
    np.testing.assert_array_equal(ep.cols.numpy(), np.asarray(ej.cols))
    np.testing.assert_array_equal(ep.is_inf.numpy(), np.asarray(ej.is_inf))
    assert (ep.n_lights, ep.p_infinite) == (ej.n_lights, ej.p_infinite)
    rs = np.random.RandomState(8)
    u = rs.uniform(size=n).astype(np.float32)
    pt = torch.as_tensor(p)
    li, pmf = lsamp.sample_light(ep, torch.as_tensor(u), p=pt)
    li_j, pmf_j, _u = jls.sample_light(ej, jnp.asarray(u),
                                       p=jnp.asarray(p))
    same = li.numpy() == np.asarray(li_j)
    print(f"{name} exhaustive: the pick equal on {same.mean():.4%} of {n}")
    assert same.mean() >= 0.999
    p64 = pt.double()
    w64 = lsamp.light_pmf(_f64(ep), li, p=p64).numpy()
    _held_to_f64(pmf.numpy()[same], np.asarray(pmf_j)[same], w64[same],
                 f"{name} exhaustive sample pmf")
    idx = torch.as_tensor(rs.randint(0, ep.n_lights, n))
    _held_to_f64(lsamp.light_pmf(ep, idx, p=pt).numpy(),
                 np.asarray(jls.light_pmf(ej, jnp.asarray(idx.numpy()),
                                          p=jnp.asarray(p))),
                 lsamp.light_pmf(_f64(ep), idx, p=p64).numpy(),
                 f"{name} exhaustive light_pmf")
    np.testing.assert_array_equal(lsamp.light_pmf(ep, li, p=pt).numpy(),
                                  pmf.numpy())
    # every light: the infinite ones take p_infinite whatever their power;
    # a point that no bounded light reaches (all importances 0) gives the
    # bounded lights no pmf, so the sum there is p_infinite (the
    # reference's semantics: its sample renormalizes by the total)
    sums = lsamp._exhaustive_pmf_matrix(ep, pt[:6], None).double() \
        .sum(dim=1).numpy()
    imp = lb._child_importance(ep.cols[None], pt[:6, None]) * \
        (1 - ep.is_inf)[None]
    want = np.where(imp.sum(dim=1).numpy() > 0, 1.0, ep.p_infinite)
    assert (want == 1.0).any()
    np.testing.assert_allclose(sums, want, atol=1e-5)


@pytest.mark.parametrize("kind, bounds, powers", [
    ("bvh", None, [1.0, 2.0]), ("bvh", "seeded", [0.0, 0.0]),
    ("exhaustive", None, [1.0]), ("exhaustive", "seeded", [0.0, 0.0]),
    ("bogus", "seeded", [1.0, 2.0]), ("power", None, [1.0, 3.0]),
    ("bvh", "seeded", [1.0, 2.0])])
def test_make_light_sampler_falls_through_as_the_reference(kind, bounds,
                                                           powers):
    b = None
    if bounds:
        b = {k: v[:len(powers)] for k, v in _seeded_bounds(2, 3).items()}
        b["power"] = np.asarray(powers, np.float64)
        b["is_infinite"] = np.zeros(len(powers), bool)
    lj = jls.make_light_sampler(kind, np.asarray(powers), light_bounds=b)
    lp = lsamp.make_light_sampler(kind, np.asarray(powers), light_bounds=b,
                                  device="cpu")
    assert lp.kind == lj.kind and lp.n_lights == lj.n_lights
    if lp.kind in (lsamp.LS_UNIFORM, lsamp.LS_POWER):
        np.testing.assert_array_equal(lp.pmf_table, np.asarray(lj.pmf_table))


INF_SCENE = (
    'LookAt 0 2 6  0 0.5 0  0 1 0\nCamera "perspective" "float fov" [40]\n'
    'Film "rgb" "integer xresolution" [4] "integer yresolution" [4]\n'
    'Sampler "zsobol" "integer pixelsamples" [1]\n'
    'Integrator "path" "integer maxdepth" [2] "string lightsampler" "{ls}"\n'
    'WorldBegin\n{light}\n'
    'Material "diffuse" "rgb reflectance" [0.5 0.5 0.5]\n'
    'Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]\n'
    '  "point3 P" [-4 0 -4  4 0 -4  4 0 4  -4 0 4]\n'
    'AttributeBegin\n  AreaLightSource "diffuse" "rgb L" [4 4 4]\n'
    '  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]\n'
    '    "point3 P" [-1 3 -1  -1 3 1  1 3 1  1 3 -1]\nAttributeEnd\n')


@pytest.mark.parametrize("ls", ["bvh", "exhaustive"])
@pytest.mark.parametrize("light", [
    'LightSource "infinite" "rgb L" [0.2 0.2 0.2]',
    'LightSource "infinite" "string filename" "sky.exr"'])
def test_position_aware_sampler_with_infinite_light(ls, light):
    """The reference renders no such scene: its escape branches read the
    sampler's pmf_table, which its bvh and exhaustive samplers lack. The
    port does not invent semantics for it: its build raises."""
    text = INF_SCENE.format(ls=ls, light=light)
    dj = jparser.parse_string(text, base_dir=str(SCENES))
    assert dj.scene.light_sampler.kind == {"bvh": jls.LS_BVH,
                                           "exhaustive": jls.LS_EXHAUSTIVE}[ls]
    n = 16
    z = jnp.zeros((n,), jnp.int32)
    o = jnp.tile(jnp.asarray([[0.0, 2.0, 6.0]]), (n, 1))
    d = jnp.tile(jnp.asarray([[0.0, -0.3, -1.0]]), (n, 1))
    swl = jspc.SampledWavelengths(lam=jnp.full((n, 4), 550.0),
                                  pdf=jnp.ones((n, 4)))
    with pytest.raises(AttributeError, match="pmf_table"):
        jpath.trace_paths(dj.scene, dj.sampler, z, z, z, o, d, swl,
                          jpath.PathOptions(max_depth=2, megakernel=False,
                                            compaction=False))
    with pytest.raises(NotImplementedError, match="infinite light"):
        parser.parse_string(text, base_dir=str(SCENES), device="cpu")
    # without the infinite light, or under the power sampler, it builds
    parser.parse_string(INF_SCENE.format(ls=ls, light=""), device="cpu")
    parser.parse_string(text.replace(f'"{ls}"', '"power"'),
                        base_dir=str(SCENES), device="cpu")


def test_megakernel_refuses_the_bvh_sampler():
    """cornell under the bvh sampler: no megakernel tables, in the port as
    in the reference; the power sampler keeps them."""
    text = (SCENES / "cornell.pbrt").read_text()
    bvh = text.replace('"integer maxdepth" [5]',
                       '"integer maxdepth" [5] "string lightsampler" "bvh"')
    assert bvh != text
    for t, eligible in ((text, True), (bvh, False)):
        sp = parser.parse_string(t, device="cpu").scene
        sj = jparser.parse_string(t).scene
        assert (sp.mega is not None) == eligible == (sj.mega is not None)
    assert sp.light_sampler.kind == lsamp.LS_BVH


def test_convert_carries_the_light_bvh(scenes_parsed):
    dj, dp, _b, _bp = scenes_parsed["manylight"]
    arrays, meta = export(dj.scene, dj.camera, dj.sampler)
    scene, _cam, _smp = convert.from_jax_scene(arrays, meta, device="cpu")
    ls, lp = scene.light_sampler, dp.scene.light_sampler
    for k in KEYS:
        np.testing.assert_array_equal(getattr(ls, k).numpy(),
                                      getattr(lp, k).numpy(), err_msg=k)
    assert (ls.kind, ls.max_depth, ls.p_outside, ls.n_lights) == \
        (lp.kind, lp.max_depth, lp.p_outside, lp.n_lights)
    for k in ("mat_pool", "lights_packed", "spectra_pool", "tri_pallas"):
        np.testing.assert_array_equal(getattr(scene, k).numpy(),
                                      getattr(dp.scene, k).numpy(), err_msg=k)
    b = {k: v for k, v in _seeded_bounds(40, 2).items()}
    ej = jls.make_light_sampler("exhaustive", b["power"], light_bounds=b)
    arrays, meta = export(dj.scene.replace(light_sampler=ej), dj.camera,
                          dj.sampler)
    scene, _cam, _smp = convert.from_jax_scene(arrays, meta, device="cpu")
    np.testing.assert_array_equal(scene.light_sampler.cols.numpy(),
                                  np.asarray(ej.cols))
    assert scene.light_sampler.p_infinite == ej.p_infinite


def test_parse_manylight_matches_reference(scenes_parsed):
    dj, dp, _b, _bp = scenes_parsed["manylight"]
    sj, sp = dj.scene, dp.scene
    assert sp.n_tris == 1324 and not sp.use_bvh and sp.mega is None
    # 576 panels, each its own emission spectrum
    assert sp.spectra_pool.shape[0] == 576
    for what, got, want in (
            ("triangles", sp.tri_all, sj.tri_all),
            ("brute-force pool", sp.tri_pallas, sj.tri_pallas),
            ("material rows", sp.mat_pool, sj.materials.packed),
            ("light rows", sp.lights_packed, sj.lights.packed),
            ("spectra_pool", sp.spectra_pool, sj.spectra_pool)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=what)
    assert sp.scene_radius == float(sj.scene_radius)


def _wave(dj, dp, pix, spp, depth, counter):
    """One wave over the pixel ids pix (each at sample indices 0..spp-1)
    through both general waves, from the port's camera rays and cone
    spread."""
    pix = torch.as_tensor(np.tile(pix, spp))
    si = torch.as_tensor(np.repeat(np.arange(spp), len(pix) // spp))
    px, py, swl = path_mod.camera_lanes(dp.camera, dp.sampler, pix, si)
    o, d, _fw = path_mod.camera_rays(dp.camera, dp.sampler,
                                     path_mod.flt.make_filter("gaussian"),
                                     px, py, si)
    spread = cameras.pixel_cone_spread(dp.camera)
    before = counter.plain
    L = path_mod.trace_paths(dp.scene, dp.sampler, px, py, si, o, d, swl,
                             path_mod.PathOptions(max_depth=depth,
                                                  megakernel=False),
                             cone_spread=spread)
    # one closest and one shadow query a depth but the last's closest
    assert counter.plain - before == 2 * depth
    sj = dj.scene if dp.scene.use_bvh else dj.scene.replace(use_pallas=True)
    L_ref = jpath.trace_paths(
        sj, dj.sampler, jnp.asarray(px), jnp.asarray(py), jnp.asarray(si),
        jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
        jspc.SampledWavelengths(lam=jnp.asarray(swl.lam.numpy()),
                                pdf=jnp.asarray(swl.pdf.numpy())),
        jpath.PathOptions(max_depth=depth, megakernel=False,
                          compaction=False), cone_spread=spread)
    return L.numpy(), np.asarray(L_ref)


@pytest.mark.parametrize("sampler", ["bvh", "exhaustive"])
def test_general_wave_manylight_matches_reference(scenes_parsed, sampler):
    if sampler == "bvh":
        dj, dp, _b, _bp = scenes_parsed["manylight"]
        res, spp = 16, 4
    else:
        res, spp = 8, 2
        dj, dp, _b, _bp = _parse_both(_text("manylight", "exhaustive",
                                            res=res, spp=spp))
    assert dp.scene.light_sampler.kind == dj.scene.light_sampler.kind
    L, L_ref = _wave(dj, dp, np.arange(res * res), spp, 3, ti.counter)
    assert (L_ref > 0).any(axis=1).mean() > 0.05
    _hold(L, L_ref, f"manylight ({sampler}), triangle kernel route")


def test_general_wave_manylight16k_crop_matches_reference(scenes_parsed):
    """A 12x12-pixel crop (rows 20-31, columns 170-181, all lit in the
    golden) of the 200x200 image at 4 spp, depth 3: the BVH8 route and
    the 15-level light BVH."""
    dj, dp, _b, _bp = scenes_parsed["manylight16k"]
    assert dp.scene.use_bvh and dp.scene.n_tris == 17100
    ys, xs = np.meshgrid(np.arange(20, 32), np.arange(170, 182),
                         indexing="ij")
    L, L_ref = _wave(dj, dp, (ys * 200 + xs).ravel(), 4, 3, bvh8.counter)
    assert (L_ref > 0).any(axis=1).mean() > 0.5
    _hold(L, L_ref, "manylight16k crop, BVH8 route")
