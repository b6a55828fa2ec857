"""Port vs reference: the whole render and the film.

The port's render (megakernel plain version on the CPU) against
pbrt_tpu.integrators.render.render, which on the CPU runs the general
fused wave, at 16x16, 4 spp, max depth 4, same sampler and filter.
Tolerance rtol 1e-4 / atol 1e-6: the reference holds its megakernel to the
general wave at relative error < 1e-4 per lane, and the two films sum the
same samples in a different order. Also: each film function against the
reference's, the EXR codec against the reference's, and a subprocess that
renders with the port and finds neither jax nor flax imported."""
import os
import subprocess
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from pbrt_tpu import film as jfilm  # noqa: E402
from pbrt_tpu.integrators import path as jpath  # noqa: E402
from pbrt_tpu.integrators import render as jrender  # noqa: E402
from pbrt_tpu.utils import image as jimage  # noqa: E402
from pbrt_tpu.utils import spectrum as jspc  # noqa: E402
from pbrt_tpu_torch import film  # noqa: E402
from pbrt_tpu_torch import scenes  # noqa: E402
from pbrt_tpu_torch.integrators import path as path_mod  # noqa: E402
from pbrt_tpu_torch.integrators import render  # noqa: E402
from pbrt_tpu_torch.ops import megawave  # noqa: E402
from pbrt_tpu_torch.utils import image  # noqa: E402
from pbrt_tpu_torch.utils import spectrum as spc  # noqa: E402

from _jax_export import export_cornell  # noqa: E402

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
W = H = 16


def test_render_matches_reference():
    scene_j, cam_j, sampler_j, _arrays, _meta = export_cornell(W, H, spp=4)
    img_ref, _st = jrender.render(scene_j, cam_j, spp=4, sampler=sampler_j,
                                  opts=jpath.PathOptions(max_depth=4))
    scene, cam = scenes.make_cornell_box(W, H, device="cpu")
    before = megawave.counter.launches
    img, stats = render.render(scene, cam, spp=4, device="cpu",
                               opts=path_mod.PathOptions(max_depth=4))
    assert megawave.counter.launches == before
    assert img.shape == (H, W, 3) and np.all(np.isfinite(img))
    assert stats["spp"] == 4 and stats["lanes_per_wave"] == W * H * 4
    np.testing.assert_allclose(img, np.asarray(img_ref), rtol=1e-4,
                               atol=1e-6)


def _samples(n=512, seed=9):
    rs = np.random.RandomState(seed)
    u = rs.uniform(0, 1, n).astype(np.float32)
    L = rs.exponential(1.0, (n, 4)).astype(np.float32)
    L[::37] = np.inf      # non-finite samples are scrubbed by both
    w = rs.uniform(0, 2, n).astype(np.float32)
    return u, L, w


def test_sensor_to_sensor_rgb_matches_reference():
    u, L, _w = _samples()
    swl_j = jspc.sample_visible_wavelengths(jnp.asarray(u))
    swl_t = spc.sample_visible_wavelengths(torch.as_tensor(u))
    np.testing.assert_allclose(swl_t.pdf.numpy(), np.asarray(swl_j.pdf),
                               rtol=1e-5)
    L[::37] = 1.0
    ref = jfilm.sensor_to_sensor_rgb(jfilm.make_pixel_sensor(),
                                     jnp.asarray(L), swl_j)
    got = film.sensor_to_sensor_rgb(film.make_pixel_sensor(),
                                    torch.as_tensor(L), swl_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("identity", [True, False])
def test_add_samples_and_get_image_match_reference(identity):
    n_pix = 64
    rs = np.random.RandomState(10)
    if identity:
        pix = np.tile(np.arange(n_pix), 4)
    else:
        pix = rs.randint(0, n_pix, 300)
    rgb = rs.exponential(1.0, (len(pix), 3)).astype(np.float32)
    rgb[::29] = np.nan
    w = rs.uniform(0, 2, len(pix)).astype(np.float32)
    f_j = jfilm.add_samples(jfilm.make_film(8, 8), jnp.asarray(pix),
                            jnp.asarray(rgb), jnp.asarray(w),
                            identity=identity)
    f_t = film.add_samples(film.make_film(8, 8, "cpu"), torch.as_tensor(pix),
                           torch.as_tensor(rgb), torch.as_tensor(w),
                           identity=identity)
    np.testing.assert_allclose(f_t.accum.numpy(), np.asarray(f_j.accum),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        film.get_image(f_t, film.make_pixel_sensor()),
        jfilm.get_image(f_j, jfilm.make_pixel_sensor()), rtol=1e-5,
        atol=1e-6)


def test_exr_codec_matches_reference(tmp_path):
    golden = ROOT / "goldens" / "cornell_400_64spp.exr"
    np.testing.assert_array_equal(image.read_exr(golden),
                                  jimage.read_exr(golden))
    img = np.random.RandomState(11).rand(9, 7, 3).astype(np.float32)
    image.write_exr(tmp_path / "port.exr", img)
    jimage.write_exr(tmp_path / "ref.exr", img)
    assert (tmp_path / "port.exr").read_bytes() == \
        (tmp_path / "ref.exr").read_bytes()
    np.testing.assert_array_equal(jimage.read_exr(tmp_path / "port.exr"),
                                  img)


def test_port_imports_no_jax(tmp_path):
    code = (
        "import sys\n"
        "sys.path.insert(0, 'tools')\n"
        "import hair_scene\n"
        "import terrain_rays\n"
        "import torch_dma_probe\n"
        "import torch_redesign_ab\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in\n"
        "            ('torch', 'jax', 'pbrt_tpu', 'pbrt_tpu_torch')]\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from pbrt_tpu_torch import scenes\n"
        "from pbrt_tpu_torch.integrators import render, path\n"
        "from pbrt_tpu_torch import convert, native\n"
        "from pbrt_tpu_torch.ops import bvh2, bvh8, bvh8_pages, curves, tlas\n"
        "from pbrt_tpu_torch.scene import parser\n"
        "from pbrt_tpu_torch.utils import image\n"
        "scene, cam = scenes.make_cornell_box(8, 8, device='cpu')\n"
        "img, _ = render.render(scene, cam, spp=1, device='cpu',\n"
        "                       opts=path.PathOptions(max_depth=2))\n"
        f"image.write_exr({str(tmp_path / 'x.exr')!r}, img)\n"
        "desc = parser.parse_file('scenes/cornell.pbrt', force_bvh=True,\n"
        "                         device='cpu')\n"
        "import dataclasses\n"
        "desc.camera = dataclasses.replace(desc.camera, width=4, height=4)\n"
        "img2, _ = render.render(desc.scene, desc.camera, spp=1,\n"
        "                        device='cpu',\n"
        "                        opts=path.PathOptions(max_depth=2))\n"
        "assert bvh8.counter.plain == 4 and img2.shape == (4, 4, 3)\n"
        "desc = parser.parse_file('scenes/instances.pbrt', device='cpu')\n"
        "desc.camera = dataclasses.replace(desc.camera, width=4, height=4)\n"
        "img3, _ = render.render(desc.scene, desc.camera, spp=1,\n"
        "                        device='cpu',\n"
        "                        opts=path.PathOptions(max_depth=2))\n"
        "assert bvh2.counter_two_level.plain == 4 and img3.mean() > 0\n"
        "desc = parser.parse_string(hair_scene.hair_scene_text(\n"
        "    8, 0, 4, 4, 1), device='cpu')\n"
        "img4, _ = render.render(desc.scene, desc.camera, spp=1,\n"
        "                        device='cpu',\n"
        "                        opts=path.PathOptions(max_depth=2))\n"
        "assert curves.counter.plain == 4 and img4.mean() > 0\n"
        "assert desc.scene.curve_wide.shape[1] == curves.WIDE_COLS\n"
        "sph, scam = scenes.make_furnace_sphere(width=4, height=4,\n"
        "                                       force_bvh=None, device='cpu')\n"
        "from pbrt_tpu_torch.ops import tri_intersect\n"
        "before = tri_intersect.counter.plain\n"
        "img6, _ = render.render(sph, scam, spp=1, device='cpu',\n"
        "                        opts=path.PathOptions(max_depth=2))\n"
        "assert sph.n_tris == 1280 and sph.tri_pallas is not None\n"
        "assert tri_intersect.counter.plain > before and img6.mean() > 0\n"
        "lo, hi, tri = terrain_rays.terrain_triangles(12)\n"
        "V, _F = terrain_rays.make_terrain(12)\n"
        "o, d = (torch.as_tensor(a) for a in\n"
        "        terrain_rays.gen_rays(V, 'raster', 64))\n"
        "f = bvh8.build_bvh8_forest(lo, hi, tri, page_budget=4096,\n"
        "                           device='cpu')\n"
        "c = bvh8.build_bvh8_chunked(lo, hi, tri, budget=4096,\n"
        "                            device='cpu')\n"
        "hf = bvh8_pages.forest_intersect(f, o, d, 1e30)\n"
        "hb = bvh8_pages.binned_intersect(c, o, d, 1e30)\n"
        "assert torch.equal(hf['prim'], hb['prim']) and hf['hit'].any()\n"
        "o3, d3 = (torch.as_tensor(a) for a in\n"
        "          terrain_rays.gen_rays(V, 'bounce', 8))\n"
        "sc2, cam2 = scenes.make_cornell_box(4, 2, device='cpu')\n"
        "from pbrt_tpu_torch import samplers\n"
        "from pbrt_tpu_torch.utils import spectrum\n"
        "spl = samplers.make_sampler('zsobol', spp=1,\n"
        "                            full_resolution=(4, 2))\n"
        "pix = torch.arange(8)\n"
        "swl = spectrum.sample_visible_wavelengths(torch.rand(8))\n"
        "L = path.trace_paths(sc2, spl, pix % 4, pix // 4, pix * 0,\n"
        "                     o3 + 278.0, d3, swl,\n"
        "                     path.PathOptions(max_depth=2))\n"
        "from pbrt_tpu_torch.ops import megawave\n"
        "assert L.shape == (8, 4) and megawave.counter.plain >= 2\n"
        "from pbrt_tpu_torch.ops import dma_probe, intersect\n"
        "assert torch_dma_probe.main(['--device', 'cpu', '--probe', 'min',\n"
        "                             '--stage', '4']) == 0\n"
        "assert dma_probe.counter_ladder.plain == 1\n"
        "desc = parser.parse_file('scenes/patches.pbrt', device='cpu')\n"
        "desc.camera = dataclasses.replace(desc.camera, width=4, height=4)\n"
        "img5, _ = render.render(desc.scene, desc.camera, spp=1,\n"
        "                        device='cpu',\n"
        "                        opts=path.PathOptions(max_depth=2))\n"
        "assert desc.scene.blp_rows.shape == (12, 14) and img5.mean() > 0\n"
        "assert native.NATIVE_DIR.parts[-3:] == ('pbrt_tpu_torch', 'csrc',\n"
        "                                        'host')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'pbrt_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok', float(img.mean()))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[-1].startswith("ok")
    assert (tmp_path / "x.exr").exists()
