"""The spans and counters of pbrt_tpu_torch (spans.py) on the CPU.

- the span trees of a megakernel render (cornell) and of a general-wave
  render (plytex: BVH8, the image light, a texture, the conductor and the
  dielectric): the stage names, each child inside its parent, render.image
  around everything its render() did;
- under torch.profiler, render.image laid on the trace's clock through its
  anchor holds every aten op of its render(), and the trace holds no event
  named after a program span;
- images bit-identical in the "off", "host" and "device" modes;
- the records bounded: after KEEP_IMAGES + 44 renders at most
  KEEP_IMAGES + 1 records, sequence number 0 still kept;
- the device counters (lanes alive a depth, shadow rays), the flight
  counters on a crop of volume.pbrt (the counts the volumetric wave's own
  counter dict gave before the spans took it over), and the LaunchCounters
  read as launches.* and plain.*;
- on the card (marker cuda): device times of the kernels' spans (on
  cornell the lanes kernel, the megakernel and the film kernel) and the
  image equal to the host mode's.

The file imports no jax: on a machine without it run its card test with
    python -m pytest tests/test_torch_spans.py --noconftest -q -m cuda
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from pbrt_tpu_torch import scenes, spans
from pbrt_tpu_torch.integrators import path as path_mod
from pbrt_tpu_torch.integrators import render
from pbrt_tpu_torch.ops import bvh8, megawave
from pbrt_tpu_torch.scene import parser

ROOT = Path(__file__).resolve().parent.parent
SCENES = ROOT / "scenes"

MEGA_NAMES = {"render.image", "render.wave", "wave.lanes", "sampler.draw",
              "megawave.prepare", "megawave.kernel", "film.sensor_rgb",
              "film.add", "film.get_image"}
GENERAL_NAMES = {"render.image", "render.wave", "wave.lanes", "wave.camera",
                 "sampler.draw", "scene.intersect", "bvh8.kernel",
                 "wave.emission", "material.params", "texture.eval", "nee",
                 "light.pick", "light.sample_li", "bsdf.eval", "scene.shadow",
                 "bsdf.sample", "wave.roulette", "film.sensor_rgb",
                 "film.add", "film.get_image"}
# each span's parent in the trees (sampler.draw: wherever a draw is made)
PARENTS = {"render.wave": {"render.image"},
           "film.get_image": {"render.image"},
           "wave.lanes": {"render.wave"}, "wave.camera": {"render.wave"},
           "megawave.prepare": {"render.wave"},
           "megawave.kernel": {"render.wave"},
           "film.sensor_rgb": {"render.wave"}, "film.add": {"render.wave"},
           "scene.intersect": {"render.wave"},
           "wave.emission": {"render.wave"},
           "material.params": {"render.wave"}, "nee": {"render.wave"},
           "bsdf.sample": {"render.wave"},
           "wave.roulette": {"render.wave"},
           "bvh8.kernel": {"scene.intersect", "scene.shadow"},
           "texture.eval": {"material.params"},
           "light.pick": {"nee"}, "light.sample_li": {"nee"},
           "bsdf.eval": {"nee"}, "scene.shadow": {"nee"},
           "sampler.draw": {"wave.lanes", "wave.camera", "nee",
                            "render.wave", "wave.roulette"}}
DEPTH_SPANS = {"scene.intersect", "wave.emission", "material.params", "nee",
               "bsdf.sample", "wave.roulette"}


@pytest.fixture(autouse=True)
def host_mode():
    torch.set_num_threads(1)
    yield
    spans.configure("host")


def _cropped(name, width, height, spp):
    text = (SCENES / f"{name}.pbrt").read_text()
    text = re.sub(r'"integer xresolution" \[\s*\d+\s*\]',
                  f'"integer xresolution" [{width}]', text)
    text = re.sub(r'"integer yresolution" \[\s*\d+\s*\]',
                  f'"integer yresolution" [{height}]', text)
    text = re.sub(r'"integer pixelsamples" \[\s*\d+\s*\]',
                  f'"integer pixelsamples" [{spp}]', text)
    return parser.parse_string(text, base_dir=str(SCENES), device="cpu")


@pytest.fixture(scope="module")
def cornell():
    return scenes.make_cornell_box(8, 6, device="cpu")


@pytest.fixture(scope="module")
def plytex():
    return _cropped("plytex", 8, 6, 2)


def _render_cornell(cornell, spp=4, seed=0, device="cpu"):
    from pbrt_tpu_torch import samplers
    scene, cam = cornell
    return render.render(scene, cam, spp, device=device,
                         sampler=samplers.make_sampler(
                             "zsobol", spp, seed,
                             full_resolution=(cam.width, cam.height)))


def _render_desc(desc, max_depth=5, device="cpu"):
    return render.render(desc.scene, desc.camera, sampler=desc.sampler,
                         device=device,
                         opts=path_mod.PathOptions(max_depth=max_depth))


def _check_tree(raw, names):
    assert {r["name"] for r in raw} == names
    root = raw[0]
    assert root["name"] == "render.image" and root["parent"] is None
    assert all(r["image"] == root["image"] for r in raw)
    for r in raw:
        assert r["start_ns"] <= r["end_ns"]
        if r["parent"] is None:
            assert r is root
            continue
        p = raw[r["parent"]]
        assert p["name"] in PARENTS[r["name"]], (r["name"], p["name"])
        assert p["start_ns"] <= r["start_ns"] <= r["end_ns"] <= p["end_ns"]
        # a name never nests inside itself
        while p is not None:
            assert p["name"] != r["name"]
            p = None if p["parent"] is None else raw[p["parent"]]


def test_megakernel_span_tree(cornell):
    img, st = _render_cornell(cornell, spp=4)
    raw = spans.raw_spans()
    _check_tree(raw, MEGA_NAMES)
    rec = spans.images()[-1]
    waves = [r for r in raw if r["name"] == "render.wave"]
    assert [r["attrs"]["wave"] for r in waves] == list(range(rec["waves"]))
    assert rec["spp"] == 4 and (rec["width"], rec["height"]) == (8, 6)
    assert rec["lanes_per_wave"] == st["lanes_per_wave"]
    assert rec["spans"]["render.wave"]["calls"] == rec["waves"]
    assert rec["counters"]["wave.lanes"] == 8 * 6 * 4
    assert rec["counters"]["plain.megawave"] == rec["waves"]
    # self time: the duration less the children's
    root = rec["spans"]["render.image"]
    assert 0 <= root["self_ns"] < root["ns"] == \
        rec["end_ns"] - rec["start_ns"]


def test_general_wave_span_tree(plytex):
    _render_desc(plytex)
    raw = spans.raw_spans()
    _check_tree(raw, GENERAL_NAMES)
    depths = sorted({r["attrs"]["depth"] for r in raw
                     if r["name"] == "scene.intersect"})
    assert depths == list(range(5))
    assert all("depth" in r["attrs"] for r in raw
               if r["name"] in DEPTH_SPANS)


def test_render_image_holds_its_aten_ops_on_the_trace_clock(cornell):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _render_cornell(cornell, spp=2)
    rec, raw = spans.images()[-1], spans.raw_spans()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CPU]
    ops = [e for e in events if e.name().startswith("aten::")]
    assert len(ops) > 100
    lo = spans.trace_clock_us(rec, rec["start_ns"])
    hi = spans.trace_clock_us(rec, rec["end_ns"])
    first = min(e.start_ns() for e in ops) * 1e-3
    last = max(e.start_ns() + e.duration_ns() for e in ops) * 1e-3
    assert lo - 200 <= first and last <= hi + 200, (first - lo, hi - last)
    # the spans emit no profiler range
    assert not {e.name() for e in events} & {r["name"] for r in raw}


@pytest.mark.parametrize("which", ["cornell", "plytex"])
def test_images_equal_in_every_mode(which, cornell, plytex):
    images = []
    for mode in ("off", "host", "device"):
        spans.configure(mode)
        _render_cornell(cornell, spp=1)
        newest = spans.images()[-1]
        img = _render_cornell(cornell)[0] if which == "cornell" else \
            _render_desc(plytex, max_depth=3)[0]
        images.append(img)
        # "off" records no image
        assert (spans.images()[-1] is newest) == (mode == "off")
    assert np.array_equal(images[0], images[1])
    assert np.array_equal(images[0], images[2])


def test_records_are_bounded():
    from pbrt_tpu_torch import samplers
    scene, cam = scenes.make_cornell_box(4, 4, device="cpu")
    sampler = samplers.make_sampler("zsobol", 1, full_resolution=(4, 4))
    opts = path_mod.PathOptions(max_depth=1)
    first = None
    for i in range(spans.KEEP_IMAGES + 44):
        render.render(scene, cam, 1, device="cpu", sampler=sampler,
                      opts=opts)
        if first is None:
            first = spans.images()[0]
    recs = spans.images()
    assert len(recs) <= spans.KEEP_IMAGES + 1
    assert recs[0]["seq"] == 0 and recs[0] is first
    seqs = [r["seq"] for r in recs]
    assert seqs == sorted(seqs) and seqs[-1] - seqs[1] == len(recs) - 2


def test_lanes_alive_by_depth(plytex):
    spans.configure("device")
    _render_desc(plytex)
    c = spans.images()[-1]["counters"]
    alive = [c.get(f"lanes.alive[{d}]", 0) for d in range(5)]
    lanes = plytex.camera.width * plytex.camera.height * plytex.sampler.spp
    assert alive[0] == lanes == c["wave.lanes"]
    assert all(a >= b for a, b in zip(alive, alive[1:]))
    assert 0 < alive[-1] and 0 < c["shadow.rays"] <= sum(alive)
    spans.configure("host")
    _render_desc(plytex)
    assert not any(k.startswith(("lanes.alive", "shadow.rays"))
                   for k in spans.images()[-1]["counters"])


def test_flight_counters_on_the_volume_crop():
    """The counts of a 16x16, 4 spp crop of volume.pbrt at depth 6, as
    the volumetric wave's own counter dict read them before the spans'
    counters replaced it: 11 free-flight and 11 shadow loops, 671 and 848
    steps."""
    desc = _cropped("volume", 16, 16, 4)
    before = {k: spans.counter(k) for k in ("flight.calls", "flight.steps",
                                           "shadow.calls", "shadow.steps")}
    _render_desc(desc, max_depth=6)
    c = spans.images()[-1]["counters"]
    want = {"flight.calls": 11, "flight.steps": 671, "shadow.calls": 11,
            "shadow.steps": 848}
    assert {k: c[k] for k in want} == want
    assert {k: spans.counter(k) - before[k] for k in want} == want
    rec = spans.images()[-1]["spans"]
    assert rec["media.flight"]["calls"] == 11
    assert rec["media.transmittance"]["calls"] == 11


def test_launch_counters_are_counters(plytex, cornell):
    from pbrt_tpu_torch.ops import bvh2, bxdf, curves, tri_intersect
    wrappers = {"bvh8": bvh8.counter, "megawave": megawave.counter,
                "tri": tri_intersect.counter, "bvh2": bvh2.counter_bvh2,
                "two_level": bvh2.counter_two_level,
                "curves": curves.counter, "bxdf": bxdf.counter}
    for fn in (lambda: _render_desc(plytex, max_depth=3),
               lambda: _render_cornell(cornell)):
        before = {k: (c.launches, c.plain) for k, c in wrappers.items()}
        fn()
        c = spans.images()[-1]["counters"]
        for k, w in wrappers.items():
            assert c.get(f"launches.{k}", 0) == w.launches - before[k][0]
            assert c.get(f"plain.{k}", 0) == w.plain - before[k][1]
    assert c["plain.megawave"] == 1 and "plain.bvh8" not in c
    bvh8.counter.launches += 2
    assert spans.counter("launches.bvh8") == bvh8.counter.launches
    bvh8.counter.launches -= 2


def test_report_and_setup(plytex):
    spans.configure("device")
    _render_desc(plytex, max_depth=2)
    text = spans.report([spans.images()[-1]])
    assert "bsdf.eval" in text and "lanes.alive[0]" in text
    assert {"scene.parse", "scene.build", "bvh.build",
            "scene.upload"} <= set(spans.setup())
    with pytest.raises(ValueError):
        spans.configure("on")


@pytest.mark.cuda
def test_device_mode_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    dev = torch.device("cuda")
    cornell = scenes.make_cornell_box(32, 24, device=dev)
    text = (SCENES / "meshfield.pbrt").read_text()
    text = re.sub(r'"integer pixelsamples" \[\s*\d+\s*\]',
                  '"integer pixelsamples" [4]', text)
    mesh = parser.parse_string(text, base_dir=str(SCENES), device=dev)
    assert mesh.scene.bvh8 is not None
    # cornell's waves on the card: the lanes kernel (megawave.prepare), the
    # megakernel and the film kernel (film.add), no tensor front end
    card_mega = {"render.image", "render.wave", "megawave.prepare",
                 "megawave.kernel", "film.add", "film.get_image"}
    for run, kernels, names in (
            (lambda: _render_cornell(cornell, device=dev),
             ("megawave.prepare", "megawave.kernel", "film.add"), card_mega),
            (lambda: _render_desc(mesh, 3, device=dev), ("bvh8.kernel",),
             None)):
        run()
        host = run()[0]
        spans.configure("device")
        img = run()[0]
        spans.configure("host")
        s = spans.images()[-1]["spans"]
        for kernel in kernels:
            assert s[kernel]["device_ns"] > 0
            assert s["render.image"]["device_ns"] >= s[kernel]["device_ns"]
        assert names is None or set(s) == names
        assert np.array_equal(img, host)

