"""Port vs reference: the curves path (the general wave on a fur patch).

The scene is tools/hair_scene.py's hair_scene_text(32, seed 5, 16x16,
2 spp): 32 strands, 256 cylinder curve spans (2,048 sub-segments) with the
hair material, a diffuse ground quad, an area light quad and a uniform
infinite light, parsed by both packages.

- The port's render_wave (trace_paths) against the reference's with
  megakernel=False, lane for lane on the same pixels, sample indices and
  sampler, at max depth 5, the reference's curve queries through its
  Pallas curve kernel in interpret mode (packet_intersect_curves, whose
  gathered re-test is the port's): L within rel 1e-4 (floor 1e-3) on
  >= 99% of lanes, mean L within 1e-3 relative. Float32 transcendentals
  of XLA and torch round an ulp apart (ROADMAP section 3) and the hair
  lobes chain dozens of them, so a sampled direction differs by up to
  1e-4 relative (test_torch_hair.py); where that ray then hits a fiber,
  its offset across the fiber, h = 2 v - 1, moves by that difference over
  the fiber's width (2-8 thousandths): 250x or more. Such lanes drift by
  0.1-0.5% from the first curve hit after a bounce; an ulp-level flip of
  a shadow ray's hit does the same. 3 of the 512 lanes do (the shares and
  the lanes are printed). Every closest and shadow query runs the curve
  traversal's plain version.
- render() against the reference's render on the same scene, the
  reference on its default CPU route (the XLA curve traversal, as for the
  chip's gate image): the images within rel 1e-3 on >= 99% of pixels and
  their means within 1e-3. (The XLA traversal rounds a curve hit's v and
  normal apart from its own segment test, up to 3e-3 for a ray through
  the axis, test_torch_curves.py; the hair lobes carry that into a few
  pixels.)
"""
import functools
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from pbrt_tpu import filters as jflt  # noqa: E402
from pbrt_tpu.integrators import path as jpath  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from pbrt_tpu.integrators import render as jrender  # noqa: E402
from pbrt_tpu.ops import curves as jcrv  # noqa: E402
from pbrt_tpu.scene import parser as jparser  # noqa: E402
from pbrt_tpu_torch import filters as flt  # noqa: E402
from pbrt_tpu_torch.integrators import path as path_mod  # noqa: E402
from pbrt_tpu_torch.integrators import render  # noqa: E402
from pbrt_tpu_torch.ops import curves as crv  # noqa: E402
from pbrt_tpu_torch.scene import parser  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
from hair_scene import hair_scene_text  # noqa: E402

torch.set_num_threads(1)
W = H = 16
SPP = 2
DEPTH = 5
TEXT = hair_scene_text(32, 5, W, H, SPP)


@pytest.fixture(scope="module")
def scenes():
    return jparser.parse_string(TEXT), parser.parse_string(TEXT, device="cpu")


def test_general_wave_matches_reference(scenes, monkeypatch):
    dj, dp = scenes
    assert dp.scene.has_curves and dp.scene.bxdf_tags == (0, 7)
    monkeypatch.setattr(jcrv.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    s = dj.scene.replace(use_pallas_curves=True,
                         curve_segs_dense=jcrv.pad_segs_dense(
                             np.asarray(dj.scene.curve_segs)))
    pix = np.tile(np.arange(W * H), SPP)
    si = np.repeat(np.arange(SPP), W * H)
    L_ref, _swl, fw_ref = jpath.render_wave(
        s, dj.camera, dj.sampler, jflt.make_filter("gaussian"),
        jnp.asarray(pix), jnp.asarray(si),
        jpath.PathOptions(max_depth=DEPTH, megakernel=False,
                          compaction=False))
    before = crv.counter.plain
    L, _swl, fw = path_mod.render_wave(
        dp.scene, dp.camera, dp.sampler, flt.make_filter("gaussian"),
        torch.as_tensor(pix), torch.as_tensor(si),
        path_mod.PathOptions(max_depth=DEPTH))
    # one closest and one shadow query per depth
    assert crv.counter.plain - before == 2 * DEPTH
    assert crv.counter.launches == 0
    L, L_ref = L.numpy(), np.asarray(L_ref)
    rel = (np.abs(L - L_ref) / np.maximum(np.abs(L_ref), 1e-3)).max(axis=1)
    within = float((rel < 1e-4).mean())
    exact = float((L == L_ref).all(axis=1).mean())
    mean_rel = abs(float(L.mean()) / float(L_ref.mean()) - 1.0)
    outside = [(int(i), L[i].tolist(), L_ref[i].tolist())
               for i in np.nonzero(rel >= 1e-4)[0][:4]]
    print(f"hair wave: {within:.2%} of {len(L)} lanes within rel 1e-4, "
          f"{exact:.2%} bit-identical, mean L rel diff {mean_rel:.3g}; "
          f"lanes outside (lane, L, L_ref): {outside}")
    assert np.all(np.isfinite(L)) and L.mean() > 0
    assert within >= 0.99, within
    assert mean_rel < 1e-3, mean_rel
    np.testing.assert_allclose(fw.numpy(), np.asarray(fw_ref), rtol=1e-5,
                               atol=1e-6)


def test_render_matches_reference(scenes):
    dj, dp = scenes
    img_ref, _ = jrender.render(dj.scene, dj.camera, spp=SPP,
                                sampler=dj.sampler,
                                opts=jpath.PathOptions(max_depth=DEPTH))
    img, stats = render.render(dp.scene, dp.camera, sampler=dp.sampler,
                               device="cpu",
                               opts=path_mod.PathOptions(max_depth=DEPTH))
    img_ref = np.asarray(img_ref)
    assert img.shape == img_ref.shape == (H, W, 3)
    assert stats["lanes_per_wave"] == W * H * SPP
    rel = np.abs(img - img_ref) / np.maximum(np.abs(img_ref), 1e-3)
    share = float((rel.max(axis=-1) < 1e-3).mean())
    mean_rel = abs(float(img.mean()) / float(img_ref.mean()) - 1.0)
    print(f"hair render: {share:.2%} of pixels within rel 1e-3, mean rel "
          f"diff {mean_rel:.3g}")
    assert share >= 0.99, share
    assert mean_rel < 1e-3, mean_rel
