"""Port vs reference: the killeroo path's new pieces (scenes/killeroo.pbrt:
two killermesh.ply copies, 163,842 triangles, an imagemap texture on the
floor, the sky image light, the rough gold conductor and the rough
dielectric).

Inputs are the repository's files or made from numpy seeds, and go
through the reference's function and the port's:
- read_png on checker.png and on seeded 8- and 16-bit images written with
  every scanline filter (np.array_equal); srgb_to_linear on the 256 byte
  values (equal but where torch's and XLA's float32 pow round an ulp
  apart; there the float64 curve is the witness);
- TextureBuilder.add_image: the descriptor, atlas and MIP rows
  (np.array_equal) of checker.png's linear image, of a seeded
  non-power-of-two HDR image and of a scaled one;
- eval_texture at seeded uv (inside, outside [0, 1), on texel seams and
  the wrap) and footprints spanning every MIP level and none, at rtol
  1e-5; pixel_cone_spread;
- plyio.read_ply on killermesh.ply and blob.ply and on small ASCII and
  big-endian files written here, quads among their faces (np.array_equal);
- parse_file("scenes/killeroo.pbrt", device="cpu"): triangles, material,
  light and spectrum pools, light sampler, texture descriptor and MIP rows
  array for array, the atlas that of the reference's builder on the
  port's linear image; the PNG image light; the image light's power;
  convert carries the texture pool;
- the general wave (trace_paths(megakernel=False)) on a small
  killeroo-like scene (the textured floor, blob.ply under the gold
  conductor, the sky; 5,122 triangles, so the BVH8 route) at 16x16, 4 spp,
  depth 5, at the camera's cone spread and at a wide one that reaches the
  coarse MIP levels, held under test_torch_path_general.py's gate;
- the megakernel refuses a textured material; the parser's refusals.
"""
import os
import struct
import zlib
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from pbrt_tpu import cameras as jcam  # noqa: E402
from pbrt_tpu import textures as jtex  # noqa: E402
from pbrt_tpu.scene import parser as jparser  # noqa: E402
from pbrt_tpu.scene import plyio as jply  # noqa: E402
from pbrt_tpu.utils import color as jcolor  # noqa: E402
from pbrt_tpu.utils import image as jimage  # noqa: E402
from pbrt_tpu_torch import cameras  # noqa: E402
from pbrt_tpu_torch import convert  # noqa: E402
from pbrt_tpu_torch import textures as tex  # noqa: E402
from pbrt_tpu_torch.ops import bvh8  # noqa: E402
from pbrt_tpu_torch.scene import parser  # noqa: E402
from pbrt_tpu_torch.scene import plyio  # noqa: E402
from pbrt_tpu_torch.utils import color as pcolor  # noqa: E402
from pbrt_tpu_torch.utils import image  # noqa: E402

from _jax_export import export, reference_keeps_spectra  # noqa: E402
from test_torch_lightsampler_bvh import _wave  # noqa: E402
from test_torch_path_general import _hold  # noqa: E402

torch.set_num_threads(1)
SCENES = Path(__file__).resolve().parent.parent / "scenes"
N = 4096


def _png_bytes(img, filters):
    """A truecolor PNG of img (H, W, 3) uint8 or uint16, row y written
    with scanline filter filters[y] (0 none, 1 sub, 2 up, 3 average,
    4 paeth)."""
    h, w = img.shape[:2]
    depth = 16 if img.dtype == np.uint16 else 8
    raw = np.frombuffer(img.astype(">u2" if depth == 16 else "u1")
                        .tobytes(), np.uint8).reshape(h, -1).astype(np.int64)
    bpp = 3 * depth // 8
    out = b""
    prev = np.zeros(raw.shape[1], np.int64)
    for y in range(h):
        x = raw[y]
        a = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        p = a + prev - c
        pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, prev, c))
        pred = [0, a, prev, (a + prev) >> 1, paeth][filters[y]]
        out += bytes([filters[y]]) + ((x - pred) % 256).astype(
            np.uint8).tobytes()
        prev = x

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(out)) + chunk(b"IEND", b""))


def test_read_png_matches_reference(tmp_path):
    img = image.read_png(SCENES / "checker.png")
    np.testing.assert_array_equal(img, jimage.read_png(SCENES /
                                                       "checker.png"))
    assert img.shape == (256, 256, 3) and img.dtype == np.uint8
    rs = np.random.RandomState(21)
    for dtype, hi in ((np.uint8, 256), (np.uint16, 65536)):
        im = rs.randint(0, hi, (10, 7, 3)).astype(dtype)
        fp = tmp_path / f"f{dtype.__name__}.png"
        fp.write_bytes(_png_bytes(im, [y % 5 for y in range(10)]))
        got = image.read_png(fp)
        np.testing.assert_array_equal(got, im)
        np.testing.assert_array_equal(got, jimage.read_png(fp))


def test_srgb_to_linear_matches_reference():
    """The 256 values of a byte: equal but where torch's and XLA's float32
    pow round an ulp apart (6 measured); there the float64 curve is the
    witness."""
    x = (np.arange(256, dtype=np.float32) / 255.0).astype(np.float32)
    got = pcolor.srgb_to_linear(torch.as_tensor(x)).numpy()
    want = np.asarray(jcolor.srgb_to_linear(jnp.asarray(x)))
    x64 = x.astype(np.float64)
    f64 = np.where(x64 <= 0.04045, x64 / 12.92,
                   ((x64 + 0.055) / 1.055) ** 2.4)
    off = got != want
    print(f"{off.sum()} of 256 values an ulp apart")
    assert off.sum() <= 8
    assert (np.abs(got - want) <= np.spacing(np.abs(want))).all()
    # the witness, the curve in float64: each side within 4 ulps of it,
    # the port's largest error at most twice the reference's
    ulp = np.spacing(np.float32(f64[off]))
    err, err_ref = np.abs(got - f64)[off], np.abs(want - f64)[off]
    assert (err <= 4 * ulp).all() and (err_ref <= 4 * ulp).all()
    assert err.max(initial=0) <= 2 * err_ref.max(initial=0)


def _pools(images, scales=None):
    """The reference's and the port's texture pools of images, each added
    with add_image (uscale 3, vscale 2 on the second), after a constant."""
    jb, pb = jtex.TextureBuilder(jcolor.srgb()), tex.TextureBuilder(
        pcolor.srgb())
    for b in (jb, pb):
        b.add_constant((0.2, 0.5, 0.7))
        for k, im in enumerate(images):
            b.add_image(im, su=1.0 + 2.0 * (k == 1), sv=1.0 + (k == 1),
                        scale=(scales or [1.0] * len(images))[k])
    return jb.build(), pb.build(device="cpu")


@pytest.fixture(scope="module")
def pools():
    rs = np.random.RandomState(22)
    checker = pcolor.srgb_to_linear(torch.as_tensor(
        image.read_png(SCENES / "checker.png").astype(np.float32) / 255.0)
    ).numpy()
    hdr = rs.uniform(0, 3, (23, 37, 3)).astype(np.float32)   # not pow2
    return _pools([checker, hdr, hdr[:5, :9]], scales=[1.0, 1.0, 0.5])


def test_add_image_matches_reference(pools):
    pj, pp = pools
    for k in ("desc", "atlas", "mips"):
        np.testing.assert_array_equal(getattr(pp, k).numpy(),
                                      np.asarray(getattr(pj, k)), err_msg=k)
    assert (pp.has_image, pp.has_mips) == (pj.has_image, pj.has_mips) == \
        (True, True)
    # checker 256 -> 9 levels; 23 x 37 -> 32 x 64, 7 levels
    assert pp.mips[1, 0] == 9 and pp.mips[2, 0] == 7
    assert tuple(pp.desc[2, 2:4].tolist()) == (64.0, 32.0)


def _uv_cases(rs, pool):
    """Seeded uv (in [0, 1), beyond it both ways, on level-0 texel seams
    and at the wrap), texture ids and footprints from 0 to past the
    coarsest level (log-uniform)."""
    n4 = N // 4
    uv = [rs.uniform(0, 1, (n4, 2)), rs.uniform(-3, 4, (n4, 2))]
    w = pool.desc[1:, 2].numpy()
    seam = rs.randint(0, 256, (n4, 2)) / np.float32(256.0)
    seam[: n4 // 2] = rs.randint(0, 64, (n4 // 2, 2)) / np.float32(
        w.max())
    uv.append(seam)
    uv.append(rs.choice(np.float32([0.0, 1.0, -1.0, 2.0, 1e-7, 1 - 1e-7]),
                        (n4, 2)))
    uv = np.concatenate(uv).astype(np.float32)
    tid = rs.randint(0, pool.desc.shape[0], N).astype(np.int32)
    fp = np.exp(rs.uniform(np.log(1e-5), np.log(4.0), N)).astype(np.float32)
    fp[:64] = 0.0
    return uv, tid, fp


@pytest.mark.parametrize("with_footprint", [True, False])
def test_eval_texture_matches_reference(pools, with_footprint):
    pj, pp = pools
    rs = np.random.RandomState(23)
    uv, tid, fp = _uv_cases(rs, pp)
    got = tex.eval_texture(pp, torch.as_tensor(tid), torch.as_tensor(uv),
                           torch.as_tensor(fp) if with_footprint else None)
    want = jtex.eval_texture(pj, jnp.asarray(tid), jnp.asarray(uv),
                             footprint=jnp.asarray(fp) if with_footprint
                             else None)
    for g, w_, what in zip(got, want, ("coeffs", "scale")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=1e-5,
                                   atol=1e-5, err_msg=what)
    if with_footprint:
        # every MIP level of each image is reached
        res = torch.maximum(pp.desc[tid, 2], pp.desc[tid, 3]).numpy()
        lod = np.log2(np.maximum(fp * res, 1.0))
        img = tid > 0
        n_lv = pp.mips[tid, 0].numpy()
        for k in (1, 2, 3):
            lv = np.floor(np.minimum(lod, n_lv - 1))[tid == k]
            assert set(range(int(n_lv[tid == k][0]))) <= set(lv.tolist())
        assert img.any() and (~img).any()


def test_pixel_cone_spread_matches_reference():
    from pbrt_tpu.utils import transform as jtfm
    for w, h, fov in ((200, 200, 44.0), (16, 9, 60.0), (7, 31, 20.0)):
        cj = jcam.make_camera("perspective",
                              camera_from_world=jtfm.identity(), width=w,
                              height=h, fov=fov)
        cp = cameras.make_camera("perspective", width=w, height=h, fov=fov)
        assert cameras.pixel_cone_spread(cp) == \
            float(np.float32(jcam.pixel_cone_spread(cj)))


PLY_ASCII = """ply
format ascii 1.0
element vertex 5
property float x
property float y
property float z
property float nx
property float ny
property float nz
property float s
property float t
element face 2
property list uchar int vertex_indices
end_header
0 0 0 0 0 1 0 0
1 0 0 0 0 1 1 0
1 1 0 0 0 1 1 1
0 1 0 0 0 1 0 1
0.5 2 0 0 1 0 0.5 1
4 0 1 2 3
3 3 2 4
"""


@pytest.mark.parametrize("which", ["killermesh.ply", "blob.ply", "ascii",
                                   "big-endian quads"])
def test_read_ply_matches_reference(tmp_path, which):
    if which == "ascii":
        fp = tmp_path / "a.ply"
        fp.write_text(PLY_ASCII)
    elif which == "big-endian quads":
        rs = np.random.RandomState(24)
        v = rs.uniform(-1, 1, (9, 3)).astype(">f4")
        uv = rs.uniform(0, 1, (9, 2)).astype(">f4")
        quads = rs.randint(0, 9, (6, 4)).astype(">i4")
        head = ("ply\nformat binary_big_endian 1.0\nelement vertex 9\n"
                "property float x\nproperty float y\nproperty float z\n"
                "property float u\nproperty float v\nelement face 6\n"
                "property list uchar int vertex_indices\nend_header\n")
        body = np.concatenate([v, uv], 1).tobytes() + b"".join(
            b"\x04" + q.tobytes() for q in quads)
        fp = tmp_path / "b.ply"
        fp.write_bytes(head.encode() + body)
    else:
        fp = SCENES / which
    got, want = plyio.read_ply(fp), jply.read_ply(fp)
    for k in ("vertices", "indices", "normals", "uvs"):
        if want[k] is None:
            assert got[k] is None, k
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert got[k].dtype == want[k].dtype
    if which == "killermesh.ply":
        assert got["indices"].shape == (81920, 3)
    if which == "big-endian quads":
        assert got["indices"].shape == (12, 3)


@pytest.fixture(scope="module")
def killeroo():
    with reference_keeps_spectra():
        dj = jparser.parse_file(SCENES / "killeroo.pbrt")
    return dj, parser.parse_file(SCENES / "killeroo.pbrt", device="cpu")


def test_parse_killeroo_matches_reference(killeroo):
    dj, dp = killeroo
    sj, sp = dj.scene, dp.scene
    assert sp.n_tris == 163842 and sp.use_bvh and sp.mega is None
    assert sp.has_textures and sp.env is not None
    for what, got, want in (
            ("triangles", sp.tri_all, sj.tri_all),
            ("material rows", sp.mat_pool, sj.materials.packed),
            ("light rows", sp.lights_packed, sj.lights.packed),
            ("spectra_pool", sp.spectra_pool, sj.spectra_pool),
            ("texture rows", sp.textures.desc, sj.textures.desc),
            ("MIP rows", sp.textures.mips, sj.textures.mips)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=what)
    np.testing.assert_array_equal(sp.light_sampler.pmf_table,
                                  np.asarray(sj.light_sampler.pmf_table))
    assert sp.light_sampler.kind == sj.light_sampler.kind
    assert (sp.textures.has_image, sp.textures.has_mips) == \
        (sj.textures.has_image, sj.textures.has_mips)
    # the atlas: the reference's builder on the port's linear image
    # (checker.png through the port's srgb_to_linear, which rounds an ulp
    # apart from XLA's on a few byte values: test above)
    lin = pcolor.srgb_to_linear(torch.as_tensor(image.read_png(
        SCENES / "checker.png").astype(np.float32) / 255.0)).numpy()
    jb = jtex.TextureBuilder(jcolor.srgb())
    jb.add_image(lin, su=3.0, sv=3.0)
    np.testing.assert_array_equal(sp.textures.atlas.numpy(),
                                  np.asarray(jb.build().atlas))
    np.testing.assert_allclose(sp.textures.atlas.numpy(),
                               np.asarray(sj.textures.atlas), rtol=1e-4,
                               atol=2e-5)


def test_convert_carries_the_texture_pool(killeroo):
    dj, dp = killeroo
    arrays, meta = export(dj.scene, dj.camera, dj.sampler)
    scene, _cam, _smp = convert.from_jax_scene(arrays, meta, device="cpu")
    for k in ("desc", "atlas", "mips"):
        np.testing.assert_array_equal(
            getattr(scene.textures, k).numpy(),
            np.asarray(getattr(dj.scene.textures, k)), err_msg=k)
    assert scene.has_textures and scene.textures.has_mips
    np.testing.assert_array_equal(scene.mat_pool.numpy(),
                                  dp.scene.mat_pool.numpy())


HEADER = ('LookAt 0 2.4 6.5   0 1.1 0   0 1 0\n'
          'Camera "perspective" "float fov" [42]\n'
          'Film "rgb" "integer xresolution" [16] "integer yresolution" [16]\n'
          'Sampler "zsobol" "integer pixelsamples" [4]\n'
          'Integrator "path" "integer maxdepth" [5]\nWorldBegin\n')
FLOOR = ('Texture "floor" "spectrum" "imagemap" "string filename" '
         '"checker.png" "float uscale" [3] "float vscale" [3]\n'
         'Material "diffuse" "texture reflectance" "floor"\n'
         'Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]\n'
         '  "point2 uv" [0 0  1 0  1 1  0 1]\n'
         '  "point3 P" [-8 0 -8  8 0 -8  8 0 8  -8 0 8]\n')
SMALL_KILLEROO = (HEADER + 'LightSource "infinite" "string filename" '
                  '"sky.exr"\n' + FLOOR
                  + 'Material "conductor" "spectrum eta" "metal-Au-eta"\n'
                  '  "spectrum k" "metal-Au-k" "float roughness" [0.15]\n'
                  'Shape "plymesh" "string filename" "blob.ply"\n')


@pytest.fixture(scope="module")
def small_killeroo():
    with reference_keeps_spectra():
        dj = jparser.parse_string(SMALL_KILLEROO, base_dir=str(SCENES))
    return dj, parser.parse_string(SMALL_KILLEROO, base_dir=str(SCENES),
                                   device="cpu")


@pytest.mark.parametrize("spread", ["camera", 0.3])
def test_general_wave_small_killeroo_matches_reference(small_killeroo,
                                                       spread, monkeypatch):
    dj, dp = small_killeroo
    assert dp.scene.use_bvh and dp.scene.n_tris == 5122
    assert dp.scene.has_textures and dp.scene.mega is None
    if spread != "camera":
        monkeypatch.setattr(cameras, "pixel_cone_spread",
                            lambda cam: spread)
    L, L_ref = _wave(dj, dp, np.arange(16 * 16), 4, 5, bvh8.counter)
    assert (L_ref > 0).any(axis=1).mean() > 0.9
    _hold(L, L_ref, f"small killeroo (cone spread {spread}), BVH8 route")


def test_megakernel_refuses_a_textured_material():
    text = (SCENES / "cornell.pbrt").read_text()
    mat = ('MakeNamedMaterial "white" "string type" "diffuse"\n'
           '    "rgb reflectance" [0.725 0.71 0.68]')
    assert mat in text
    textured = text.replace(mat, (
        'Texture "t" "spectrum" "imagemap" "string filename" '
        '"checker.png"\nMakeNamedMaterial "white" "string type" "diffuse" '
        '"texture reflectance" "t"'))
    for t, eligible in ((text, True), (textured, False)):
        sp = parser.parse_string(t, base_dir=str(SCENES), device="cpu").scene
        with reference_keeps_spectra():
            sj = jparser.parse_string(t, base_dir=str(SCENES)).scene
        assert (sp.mega is not None) == eligible == (sj.mega is not None)
        assert sp.has_textures == (not eligible)


def test_png_image_light_and_power_match_reference(tmp_path):
    """LightSource "infinite" with a PNG (bytes over 255, no sRGB curve, as
    in the reference) beside an area lamp under the power sampler: the
    same env tables and light pool (the image light's power carries the
    4 pi^2 r^2 of the reference's build, so the pmf column matches)."""
    rs = np.random.RandomState(25)
    jimage.write_png(tmp_path / "env.png",
                     rs.randint(0, 256, (16, 16, 3)).astype(np.uint8))
    (tmp_path / "checker.png").write_bytes(
        (SCENES / "checker.png").read_bytes())
    text = (HEADER + 'LightSource "infinite" "string filename" "env.png"\n'
            + FLOOR + 'AttributeBegin\n  AreaLightSource "diffuse" "rgb L" '
            '[5 5 5]\n  Shape "trianglemesh" "integer indices" [0 1 2]\n'
            '    "point3 P" [-1 3 -1  1 3 -1  0 3 1]\nAttributeEnd\n')
    with reference_keeps_spectra():
        sj = jparser.parse_string(text, base_dir=str(tmp_path)).scene
    sp = parser.parse_string(text, base_dir=str(tmp_path), device="cpu").scene
    for k in ("texels", "alias_rows", "pmf", "illum"):
        np.testing.assert_array_equal(getattr(sp.env, k).numpy(),
                                      np.asarray(getattr(sj.env, k)),
                                      err_msg=k)
    np.testing.assert_array_equal(sp.lights_packed.numpy(),
                                  np.asarray(sj.lights.packed))
    np.testing.assert_array_equal(sp.light_sampler.pmf_table,
                                  np.asarray(sj.light_sampler.pmf_table))


@pytest.mark.parametrize("snippet, item", [
    (b'Texture "t" "float" "imagemap" "string filename" "checker.png"',
     "item 21"),
    (b'Texture "t" "spectrum" "checkerboard"', "item 21"),
    (b'Texture "t" "spectrum" "imagemap" "string filename" "checker.png" '
     b'"string mapping" "spherical"', "item 21"),
    (b'Texture "t" "spectrum" "imagemap" "string filename" "checker.png" '
     b'"float udelta" [0.5]', "item 21"),
    (b'Texture "t" "spectrum" "imagemap" "string filename" "sky.tga"',
     "slice 6"),
    (b'Material "conductor" "texture roughness" "r"', "slice 3 item 9"),
    (b'Shape "plymesh" "string filename" "blob.ply" "float alpha" [0.5]',
     "slice 4 item 18"),
])
def test_texture_and_plymesh_refusals(snippet, item):
    with pytest.raises(parser.ParseError) as err:
        parser.parse_string(b"WorldBegin\n" + snippet + b"\n",
                            base_dir=str(SCENES), device="cpu")
    assert "ROADMAP.md" in str(err.value) and item in str(err.value), \
        str(err.value)


def test_unknown_texture_name_raises():
    with pytest.raises(parser.ParseError, match="unknown texture 'nope'"):
        parser.parse_string(b'WorldBegin\nMaterial "diffuse" '
                            b'"texture reflectance" "nope"\n', device="cpu")
