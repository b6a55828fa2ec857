"""Port vs reference: the envlit path (scenes/envlit.pbrt: an image infinite
light, a rough gold conductor, a smooth dielectric, diffuse meshes; 1,538
triangles, so every query goes through the brute-force triangle route).

Inputs are made from numpy seeds, or are the scene files, and go through
the reference's function and the port's:
- the image infinite light: make_env_light on scenes/sky.exr gives the
  same texels, alias rows and pmf (np.array_equal); env_radiance,
  env_sample_li and env_pdf_li agree at rtol 1e-5 on seeded directions,
  uniforms and wavelengths; the pmf and the pdf over the texels sum to 1;
  equalarea_from_latlong on a seeded lat-long image (rel 1e-4: its white
  noise magnifies the map's one-ulp differences), and the parser's
  lat-long path through a .pfm file;
- parsing: parse_file("scenes/envlit.pbrt", device="cpu") gives the
  reference parse's triangles, material pool, spectra pool, light pool,
  light sampler and env arrays, array for array;
- the general wave: trace_paths(megakernel=False) at 16x16, 4 spp, depth 5
  on envlit, on a spectral glass-BK7 dielectric (dispersion) and on an
  area lamp seen through a smooth dielectric pane (the MIS weight 1 after
  a specular bounce), all through the brute-force route, the reference
  through its Pallas triangle kernel in interpret mode; held under
  test_torch_path_general.py's gate (rel 1e-4 on >= 99% of lanes, mean L
  within 1e-3);
- the megakernel's eligibility refuses the image light and any non-diffuse
  material, so such scenes render through the general wave.
"""
import os
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from pbrt_tpu import lights as jlgt  # noqa: E402
from pbrt_tpu.integrators import path as jpath  # noqa: E402
from pbrt_tpu.scene import parser as jparser  # noqa: E402
from pbrt_tpu.utils import color as jcolor  # noqa: E402
from pbrt_tpu.utils import image as jimage  # noqa: E402
from pbrt_tpu.utils import image_env as jimage_env  # noqa: E402
from pbrt_tpu.utils import spectrum as jspc  # noqa: E402
from pbrt_tpu.utils import vecmath as jvm  # noqa: E402
from pbrt_tpu_torch import bxdfs  # noqa: E402
from pbrt_tpu_torch import lights as lgt  # noqa: E402
from pbrt_tpu_torch import scene_core as sc  # noqa: E402
from pbrt_tpu_torch import convert  # noqa: E402
from pbrt_tpu_torch.integrators import path as path_mod  # noqa: E402
from pbrt_tpu_torch.ops import megawave  # noqa: E402
from pbrt_tpu_torch.ops import tri_intersect as ti  # noqa: E402
from pbrt_tpu_torch.scene import parser  # noqa: E402
from pbrt_tpu_torch.utils import color as pcolor  # noqa: E402
from pbrt_tpu_torch.utils import image  # noqa: E402
from pbrt_tpu_torch.utils import image_env  # noqa: E402
from pbrt_tpu_torch.utils import spectrum as spc  # noqa: E402
from pbrt_tpu_torch.utils import vecmath as vm  # noqa: E402

from _jax_export import export  # noqa: E402
from test_torch_path_general import _hold  # noqa: E402

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
SCENES = ROOT / "scenes"
W = H = 16
SPP = 4
DEPTH = 5
N = 4096


def _small(text):
    """A scene file's text at W x H and SPP."""
    return text.replace(
        '"integer xresolution" [200] "integer yresolution" [200]',
        f'"integer xresolution" [{W}] "integer yresolution" [{H}]').replace(
        '"integer pixelsamples" [64]', f'"integer pixelsamples" [{SPP}]')


def _unit(v):
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def sky():
    return image.read_exr(SCENES / "sky.exr")


@pytest.fixture(scope="module")
def envs(sky):
    """The reference's and the port's env light of sky.exr."""
    return (jlgt.make_env_light(sky, jcolor.srgb(), scale=1.5,
                                light_index=2),
            lgt.make_env_light(sky, pcolor.srgb(), scale=1.5, light_index=2,
                               device="cpu"))


def test_sky_reads_like_the_reference(sky):
    np.testing.assert_array_equal(sky, jimage.read_exr(SCENES / "sky.exr"))
    assert sky.shape == (128, 128, 3)


def test_make_env_light_matches_reference(envs):
    ej, ep = envs
    for k in ("texels", "alias_rows", "pmf", "illum"):
        np.testing.assert_array_equal(getattr(ep, k).numpy(),
                                      np.asarray(getattr(ej, k)), err_msg=k)
    assert (ep.width, ep.height, ep.light_index) == (ej.width, ej.height,
                                                     ej.light_index)
    assert ep.scale == float(ej.scale)


def test_env_radiance_sample_and_pdf_match_reference(envs):
    ej, ep = envs
    rs = np.random.RandomState(12)
    d = _unit(rs.normal(size=(N, 3)))
    lam = rs.uniform(360, 830, (N, 4)).astype(np.float32)
    u2 = rs.uniform(0, 1, (N, 2)).astype(np.float32)
    p = rs.uniform(-3, 3, (N, 3)).astype(np.float32)
    got = lgt.env_radiance(ep, torch.as_tensor(d), torch.as_tensor(lam))
    want = np.asarray(jlgt.env_radiance(ej, jnp.asarray(d), jnp.asarray(lam)))
    # the lookup at the same texel coordinates: every lane whose equal-area
    # uv is bit-equal in both packages (torch's and XLA's float32 atan
    # round an ulp apart on a few directions; there the bilinear weights
    # move by ~1e-5 and the radiance by up to ~2e-5, ROADMAP.md section 3)
    uv = vm.equal_area_sphere_to_square(torch.as_tensor(d)).numpy()
    uv_ref = np.asarray(jvm.equal_area_sphere_to_square(jnp.asarray(d)))
    same_uv = (uv == uv_ref).all(axis=-1)
    assert same_uv.mean() > 0.98, same_uv.mean()
    np.testing.assert_allclose(got.numpy()[same_uv], want[same_uv],
                               rtol=1e-5, atol=1e-6)
    # where the uv differ, by one ulp, each package's is as close to the
    # float64 map (the witness) as the other's
    uv64 = _equal_area_f64(d.astype(np.float64))
    err, err_ref = (np.abs(x[~same_uv] - uv64[~same_uv]).max(initial=0)
                    for x in (uv, uv_ref))
    assert np.abs(uv - uv_ref).max() <= 1.2e-7
    assert err <= max(err_ref, 6e-8) * 1.5, (err, err_ref)
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-5, atol=1e-6)
    np.testing.assert_allclose(
        lgt.env_pdf_li(ep, torch.as_tensor(d)).numpy(),
        np.asarray(jlgt.env_pdf_li(ej, jnp.asarray(d))), rtol=1e-5)
    got = lgt.env_sample_li(ep, torch.as_tensor(p), torch.as_tensor(u2),
                            torch.as_tensor(lam), 7.5)
    want = jlgt.env_sample_li(ej, jnp.asarray(p), jnp.asarray(u2),
                              jnp.asarray(lam), 7.5)
    for name, g, w in zip(("wi", "L", "pdf", "p_light"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    # the sampled direction's pdf is the one env_pdf_li gives it, but on
    # a texel's edge
    inside = np.abs(got[2].numpy() / lgt.env_pdf_li(ep, got[0]).numpy() - 1)
    assert (inside < 1e-5).mean() > 0.99


def _equal_area_f64(d):
    """The equal-area sphere-to-square map in float64, numpy."""
    x, y, z = np.abs(d).T
    r = np.sqrt(1 - z)
    a = np.maximum(x, y)
    phi = np.arctan(np.where(a == 0, 0, np.minimum(x, y) / np.maximum(
        a, 1e-300))) * 2 / np.pi
    phi = np.where(x < y, 1 - phi, phi)
    v = phi * r
    u = r - v
    south = d[:, 2] < 0
    u, v = np.where(south, 1 - v, u), np.where(south, 1 - u, v)
    u = u * np.where(d[:, 0] >= 0, 1, -1)
    v = v * np.where(d[:, 1] >= 0, 1, -1)
    return np.stack([0.5 * (u + 1), 0.5 * (v + 1)], -1)


def test_env_pdf_sums_to_one_over_the_texels(envs):
    _ej, ep = envs
    n = ep.width * ep.height
    assert abs(float(ep.pmf.double().sum()) - 1.0) < 1e-5
    ys, xs = np.meshgrid(np.arange(ep.height), np.arange(ep.width),
                         indexing="ij")
    uv = np.stack([(xs.ravel() + 0.5) / ep.width,
                   (ys.ravel() + 0.5) / ep.height], -1).astype(np.float32)
    pdf = lgt.env_pdf_li(ep, vm.equal_area_square_to_sphere(
        torch.as_tensor(uv)))
    # each texel covers 4 pi / n of the sphere
    assert abs(float(pdf.double().sum()) * 4 * np.pi / n - 1.0) < 1e-4


def test_equalarea_from_latlong_matches_reference():
    rs = np.random.RandomState(13)
    img = rs.uniform(0, 4, (24, 48, 3)).astype(np.float32)
    got = image_env.equalarea_from_latlong(img)
    want = jimage_env.equalarea_from_latlong(img)
    assert got.shape == (32, 32, 3)
    # white noise turns the directions' one-ulp differences (cos, sin) into
    # ~1e-5 of a bilinear tap: rel 1e-4
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


HEADER = (
    'LookAt 0 1.2 6  0 0.5 0  0 1 0\nCamera "perspective" "float fov" [40]\n'
    f'Film "rgb" "integer xresolution" [{W}] "integer yresolution" [{H}]\n'
    f'Sampler "zsobol" "integer pixelsamples" [{SPP}]\n'
    f'Integrator "path" "integer maxdepth" [{DEPTH}]\nWorldBegin\n')
GROUND = ('Material "diffuse" "rgb reflectance" [0.6 0.6 0.55]\n'
          'Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]\n'
          '  "point3 P" [-8 -0.5 -8  8 -0.5 -8  8 -0.5 8  -8 -0.5 8]\n')


def _sphere(nu=12, nv=8, r=0.9, c=(0.0, 0.5, 0.0)):
    """A uv sphere as trianglemesh text, with per-vertex normals."""
    P, N_, idx = [], [], []
    for j in range(nv + 1):
        th = np.pi * j / nv
        for i in range(nu + 1):
            ph = 2 * np.pi * i / nu
            n = np.array([np.sin(th) * np.cos(ph), np.cos(th),
                          np.sin(th) * np.sin(ph)])
            P.append(np.asarray(c) + r * n)
            N_.append(n)
    for j in range(nv):
        for i in range(nu):
            a = j * (nu + 1) + i
            idx += [a, a + nu + 1, a + 1, a + 1, a + nu + 1, a + nu + 2]

    def f(a):
        return " ".join(f"{x:.6g}" for x in np.asarray(a).reshape(-1))
    return (f'Shape "trianglemesh" "integer indices" [{f(idx)}]\n'
            f'  "point3 P" [{f(P)}]\n  "normal N" [{f(N_)}]\n')


def _lamp(y=3.0, L="8 8 6"):
    return ('AttributeBegin\n'
            f'  AreaLightSource "diffuse" "rgb L" [{L}]\n'
            '  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]\n'
            f'    "point3 P" [-1 {y} -1  -1 {y} 1  1 {y} 1  1 {y} -1]\n'
            'AttributeEnd\n')


# a glass-BK7 sphere (spectral eta) under a lamp and a uniform sky
DISPERSION = (HEADER + 'LightSource "infinite" "rgb L" [0.3 0.35 0.4]\n'
              + GROUND + 'Material "dielectric" "spectrum eta" "glass-BK7"\n'
              + _sphere() + _lamp())
# an area lamp seen through a smooth glass pane: the camera's rays refract
# into the pane (two faces) and hit the lamp behind it after specular
# bounces
PANE = (HEADER + GROUND
        + 'Material "dielectric" "float eta" [1.5]\n'
        'Shape "trianglemesh" "integer indices" [0 1 2 0 2 3 4 6 5 4 7 6]\n'
        '  "point3 P" [-1.5 -0.5 1  1.5 -0.5 1  1.5 2.5 1  -1.5 2.5 1\n'
        '    -1.5 -0.5 0.9  1.5 -0.5 0.9  1.5 2.5 0.9  -1.5 2.5 0.9]\n'
        'AttributeBegin\n  AreaLightSource "diffuse" "rgb L" [6 5 4]\n'
        '  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]\n'
        '    "point3 P" [-1 0 -1  1 0 -1  1 2 -1  -1 2 -1]\nAttributeEnd\n'
        + _lamp(y=4.0, L="2 2 2"))


def _texts():
    return {"envlit": _small((SCENES / "envlit.pbrt").read_text()),
            "dispersion": DISPERSION, "pane": PANE}


@pytest.fixture(scope="module")
def parsed():
    """Each scene parsed by both packages (base_dir scenes/)."""
    return {k: (jparser.parse_string(t, base_dir=str(SCENES)),
                parser.parse_string(t, base_dir=str(SCENES), device="cpu"))
            for k, t in _texts().items()}


def test_parse_envlit_matches_reference():
    dj = jparser.parse_file(SCENES / "envlit.pbrt")
    dp = parser.parse_file(SCENES / "envlit.pbrt", device="cpu")
    sj, sp = dj.scene, dp.scene
    assert sp.n_tris == 1538 and not sp.use_bvh and sp.mega is None
    assert sp.bxdf_tags == (bxdfs.BXDF_DIFFUSE, bxdfs.BXDF_CONDUCTOR,
                            bxdfs.BXDF_DIELECTRIC)
    assert sp.light_tags == (lgt.LIGHT_IMAGE_INFINITE,)
    for what, got, want in (
            ("triangles", sp.tri_all, sj.tri_all),
            ("brute-force pool", sp.tri_pallas, sj.tri_pallas),
            ("material rows", sp.mat_pool, sj.materials.packed),
            ("light rows", sp.lights_packed, sj.lights.packed),
            ("spectra_pool", sp.spectra_pool, sj.spectra_pool),
            ("env texels", sp.env.texels, sj.env.texels),
            ("env alias rows", sp.env.alias_rows, sj.env.alias_rows),
            ("env pmf", sp.env.pmf, sj.env.pmf),
            ("env illuminant", sp.env.illum, sj.env.illum)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=what)
    assert (sp.env.scale, sp.env.width, sp.env.height,
            sp.env.light_index) == (float(sj.env.scale), sj.env.width,
                                    sj.env.height, sj.env.light_index)
    np.testing.assert_array_equal(sp.light_sampler.pmf_table,
                                  np.asarray(sj.light_sampler.pmf_table))
    assert sp.scene_radius == float(sj.scene_radius)
    # the conductor's named spectra, the dielectric's constant eta
    np.testing.assert_array_equal(
        sp.spectra_pool.numpy(),
        np.stack([spc.get_named_spectrum(n).to_dense()
                  for n in ("metal-Au-eta", "metal-Au-k")]))


def test_convert_carries_the_env_light(parsed):
    dj, dp = parsed["envlit"]
    arrays, meta = export(dj.scene, dj.camera, dj.sampler)
    scene, _cam, _smp = convert.from_jax_scene(arrays, meta, device="cpu")
    for k in ("texels", "alias_rows", "pmf", "illum"):
        np.testing.assert_array_equal(getattr(scene.env, k).numpy(),
                                      getattr(dp.scene.env, k).numpy())
    assert (scene.env.scale, scene.env.light_index, scene.light_tags,
            scene.bxdf_tags) == (dp.scene.env.scale,
                                 dp.scene.env.light_index,
                                 dp.scene.light_tags, dp.scene.bxdf_tags)
    for k in ("mat_pool", "spectra_pool", "lights_packed", "tri_pallas"):
        np.testing.assert_array_equal(getattr(scene, k).numpy(),
                                      getattr(dp.scene, k).numpy())


def test_latlong_pfm_light_matches_reference(tmp_path):
    """LightSource "infinite" with a lat-long .pfm: read, resampled to the
    equal-area square (a 16 x 16 image of seeded noise), the light's tables
    those of make_env_light on the resampled image, its radiance the
    reference's within rel 1e-4 (the noise magnifies the resampling's
    one-ulp differences, as in the test above)."""
    rs = np.random.RandomState(14)
    ll = rs.uniform(0, 3, (16, 32, 3)).astype(np.float32)
    jimage.write_pfm(tmp_path / "ll.pfm", ll)
    np.testing.assert_array_equal(image.read_pfm(tmp_path / "ll.pfm"), ll)
    text = (HEADER + 'LightSource "infinite" "string filename" "ll.pfm" '
            '"float scale" [2]\n' + GROUND)
    sj = jparser.parse_string(text, base_dir=str(tmp_path)).scene
    sp = parser.parse_string(text, base_dir=str(tmp_path),
                             device="cpu").scene
    own = lgt.make_env_light(image_env.equalarea_from_latlong(ll),
                             pcolor.srgb(), scale=2.0)
    assert (sp.env.width, sp.env.scale) == (16, 2.0)
    for k in ("texels", "alias_rows", "pmf"):
        np.testing.assert_array_equal(getattr(sp.env, k).numpy(),
                                      getattr(own, k).numpy(), err_msg=k)
    d = _unit(rs.normal(size=(N, 3)))
    lam = rs.uniform(360, 830, (N, 4)).astype(np.float32)
    np.testing.assert_allclose(
        lgt.env_radiance(sp.env, torch.as_tensor(d),
                         torch.as_tensor(lam)).numpy(),
        np.asarray(jlgt.env_radiance(sj.env, jnp.asarray(d),
                                     jnp.asarray(lam))), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(sp.env.pmf.numpy(), np.asarray(sj.env.pmf),
                               rtol=1e-4, atol=1e-9)


SPECTRAL = (HEADER
            + 'Material "diffuse" "spectrum reflectance" [400 0.2 700 0.8]\n'
            + GROUND
            + 'Material "conductor" "float eta" [0.4] "rgb k" [3 2.5 2]\n'
            '  "float uroughness" [0.05] "float vroughness" [0.2]\n'
            '  "bool remaproughness" false\n' + _sphere(c=(-1.5, 0.5, 0))
            + 'Material "glass" "spectrum eta" "glass-BK7" '
            '"float roughness" [0.3]\n' + _sphere(c=(1.5, 0.5, 0))
            + 'AttributeBegin\n  AreaLightSource "diffuse" "spectrum L" '
            '"stdillum-F4" "float scale" [3]\n'
            '  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]\n'
            '    "point3 P" [-1 3 -1  -1 3 1  1 3 1  1 3 -1]\nAttributeEnd\n')


def test_spectral_parameters_parse_like_the_reference():
    """Named, inline and constant spectra in every spectrum parameter, an
    anisotropic conductor without the remap, a rough spectral glass: the
    same material, light and spectrum pools as the reference's parse (the
    spectral reflectance's RGB is a float32 product that XLA and numpy
    round an ulp apart: its sigmoid coefficients within rel 1e-5)."""
    sj = jparser.parse_string(SPECTRAL).scene
    sp = parser.parse_string(SPECTRAL, device="cpu").scene
    assert sp.bxdf_tags == (bxdfs.BXDF_DIFFUSE, bxdfs.BXDF_CONDUCTOR,
                            bxdfs.BXDF_DIELECTRIC)
    for what, got, want in (
            ("material rows", sp.mat_pool, sj.materials.packed),
            ("light rows", sp.lights_packed, sj.lights.packed),
            ("spectra_pool", sp.spectra_pool, sj.spectra_pool)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-7, err_msg=what)
    np.testing.assert_array_equal(sp.mat_pool[1:].numpy(),
                                  np.asarray(sj.materials.packed)[1:])


@pytest.mark.parametrize("snippet, item", [
    (b'LightSource "infinite" "string filename" "sky.tga"', "slice 6"),
    (b'LightSource "infinite" "string filename" "sky.exr" '
     b'"point3 portal" [0 0 0 1 0 0 1 1 0 0 1 0]', "slice 3 item 14"),
    (b'Material "conductor" "spectrum eta" "no-such-spectrum"', "slice 6"),
    (b'Material "conductor" "texture roughness" "r"', "slice 3 item 9"),
])
def test_envlit_refusals(snippet, item):
    with pytest.raises(parser.ParseError) as err:
        parser.parse_string(b"WorldBegin\n" + snippet + b"\n",
                            base_dir=str(SCENES), device="cpu")
    assert f"ROADMAP.md {item}" in str(err.value), str(err.value)


def _wave(dj, dp):
    """One wave of W x H x SPP lanes through both general waves, from the
    port's camera rays."""
    pix = torch.as_tensor(np.tile(np.arange(W * H), SPP))
    si = torch.as_tensor(np.repeat(np.arange(SPP), W * H))
    px, py, swl = path_mod.camera_lanes(dp.camera, dp.sampler, pix, si)
    o, d, _fw = path_mod.camera_rays(dp.camera, dp.sampler,
                                     path_mod.flt.make_filter("gaussian"),
                                     px, py, si)
    before = (ti.counter.plain, megawave.counter.plain)
    L = path_mod.trace_paths(dp.scene, dp.sampler, px, py, si, o, d, swl,
                             path_mod.PathOptions(max_depth=DEPTH,
                                                  megakernel=False))
    # one closest and one shadow query a depth but the last's closest
    assert ti.counter.plain - before[0] == 2 * DEPTH
    assert megawave.counter.plain == before[1]
    L_ref = jpath.trace_paths(
        dj.scene.replace(use_pallas=True), dj.sampler, jnp.asarray(px),
        jnp.asarray(py), jnp.asarray(si), jnp.asarray(o.numpy()),
        jnp.asarray(d.numpy()),
        jspc.SampledWavelengths(lam=jnp.asarray(swl.lam.numpy()),
                                pdf=jnp.asarray(swl.pdf.numpy())),
        jpath.PathOptions(max_depth=DEPTH, megakernel=False,
                          compaction=False))
    return L.numpy(), np.asarray(L_ref)


@pytest.mark.parametrize("name", ["envlit", "dispersion", "pane"])
def test_general_wave_matches_reference(parsed, name):
    dj, dp = parsed[name]
    assert dp.scene.mega is None and not dp.scene.use_bvh
    L, L_ref = _wave(dj, dp)
    assert (L_ref > 0).any()
    _hold(L, L_ref, f"{name}, triangle kernel route")


def test_wave_pieces_do_what_the_scenes_need(parsed):
    """Each scene exercises the branch it was made for: envlit's escapes to
    the image light, dispersion's dispersed lanes, the pane's specular
    bounces onto the lamp."""
    _dj, dp = parsed["dispersion"]
    s = dp.scene
    assert bxdfs.BXDF_DIELECTRIC in s.bxdf_tags
    eidx = int(s.mat_pool[-1, 10])
    eta = s.spectra_pool[eidx]
    assert eidx >= 0 and float(eta.max() - eta.min()) > 1e-3
    _dj, dp = parsed["pane"]
    assert lgt.LIGHT_AREA_TRI in dp.scene.light_tags
    _dj, dp = parsed["envlit"]
    assert dp.scene.env is not None and dp.scene.inf_indices == ()


def test_megakernel_refuses_env_and_specular_scenes():
    """The megakernel's eligibility (area lights only, diffuse only) keeps
    an image light or a conductor off it, as in the reference."""
    quad = np.asarray([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]],
                      np.float32)
    lamp = quad + np.asarray([0, 0, 2], np.float32)

    def scene(material, env):
        b = sc.SceneBuilder()
        m = getattr(b.materials, material)()
        b.add_mesh(quad, [[0, 1, 2], [0, 2, 3]], m)
        b.add_mesh(lamp, [[0, 1, 2], [0, 2, 3]],
                   b.materials.add_diffuse((0.5, 0.5, 0.5)),
                   emission=pcolor.RGBIlluminantSpectrum((1.0, 1.0, 1.0)))
        if env:
            b.add_image_infinite_light(np.ones((8, 8, 3), np.float32))
        return b.build(device="cpu")
    assert scene("add_diffuse", False).mega is not None
    assert scene("add_diffuse", True).mega is None
    assert scene("add_conductor", False).mega is None
    assert scene("add_dielectric", False).mega is None
    sampler = path_mod.smp.make_sampler("zsobol", spp=1,
                                        full_resolution=(4, 4))
    assert not megawave.eligible(scene("add_diffuse", True), sampler)
