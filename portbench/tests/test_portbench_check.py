"""The check of the outputs: the reference against the program on a tiny
crop, the bfloat16 control, the faults planted under the timed path, and
the guard against the JAX package."""
import dataclasses
import json
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest

from portbench import checks, control, faults, harness, spec

CELLS = [w["name"] for w in
         json.loads((spec.ROOT / "BENCHMARK.json").read_text())["workloads"]]


def tiny(name, size=16, spp=4):
    """The cell on a crop, without its golden (pbrt-v4's render is of the
    cell's own size)."""
    cell = spec.load_cell(name)
    limits = {k: v for k, v in cell.workload.limits.items()
              if k != "golden_mrse"}
    return dataclasses.replace(cell, workload=dataclasses.replace(
        cell.workload, width=size, height=size, spp=spp, limits=limits,
        golden=None))


@pytest.mark.parametrize("name", CELLS)
def test_reference_matches_program_on_a_crop(name):
    """On the CPU both sides are plain PyTorch: the same image, bit for
    bit, and the program's own render through the harness's entry."""
    cell = tiny(name)
    wl = cell.workload
    program = harness.Program(cell, "cpu", seed=3)
    s = checks.image_seed(3, 0)
    got, stats = program.render(s)
    assert stats["spp"] == wl.spp
    ref = checks.Reference(spec.scene_text(cell, wl), cell.scene_path.parent,
                           wl, "cpu").render(s)
    assert np.array_equal(got, ref)
    assert all(v == 0 for v in checks.compare(got, ref).values())
    assert checks.compare(got * 0 + np.nan, ref)["image_mrse"] == np.inf


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limits(name):
    """The reference in bfloat16, put in the program's place, fails the
    cell's limits."""
    r = control.readings(tiny(name), 11, "cpu")
    assert r["nonfinite_pixels"] == 0
    assert not checks.within(r["numbers"], r["limits"])


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_fault_in_the_timed_path_is_not_correct(name, fault):
    """A run on the CPU (the look for a card skipped) with the program's
    timed path broken: correct comes out false."""
    from pbrt_tpu_torch import film
    from pbrt_tpu_torch.integrators import path
    cell = tiny(name)
    with faults.planted(fault, film, path):
        result = harness.run(cell, 2 ** 31 + 99, 0.05, False, "cpu", 0.0)
    assert result["correct"] is False and result["failed"] == 1
    assert any(c["value"] > c["limit"] for c in result["checks"].values())
    clean = harness.run(cell, 2 ** 31 + 99, 0.05, False, "cpu", 0.0)
    assert clean["correct"] is True


def altered(img):
    """`img` as the film produces it with the fault `altered` planted."""
    film = types.SimpleNamespace(add_samples=None, get_image=lambda: img)
    path = types.SimpleNamespace(render_wave=None)
    with faults.planted("altered", film, path):
        out = film.get_image()
    assert film.get_image() is img
    return out


def test_altered_doubles_the_brightest_pixel():
    """Where the centre is black, the brightest pixel, and it alone,
    doubles; of pixels with the same mean of their channels, the first in
    row-major order; on an all-black image one pixel changes, to 1.0."""
    img = np.zeros((8, 8, 3), np.float32)
    img[1, 5] = (0.2, 0.4, 0.6)
    img[3, 3] = (0.1, 0.1, 0.1)
    out = altered(img)
    want = img.copy()
    want[1, 5] *= 2.0
    assert np.array_equal(out, want) and img[1, 5, 0] == np.float32(0.2)

    tie = np.zeros((8, 8, 3), np.float32)
    tie[2, 6] = (0.25, 0.5, 0.75)
    tie[5, 1] = (0.75, 0.5, 0.25)
    tie[6, 0] = (0.5, 0.5, 0.5)
    changed = np.argwhere((altered(tie) != tie).any(axis=-1))
    assert changed.tolist() == [[2, 6]]

    black = np.zeros((8, 8, 3), np.float32)
    out = altered(black)
    assert (out != black).any(axis=-1).sum() == 1
    assert np.array_equal(out[0, 0], np.ones(3, np.float32))


def test_altered_is_caught_where_the_centre_is_black(monkeypatch):
    """manylight16k on a crop (16x16, 4 spp, the scene's depth 3), whose
    every image rendered is black in its centre pixel and lit elsewhere:
    with `altered` planted correct comes out false, without it true."""
    from pbrt_tpu_torch import film
    from pbrt_tpu_torch.integrators import path
    from portbench.tests.test_portbench_refport_lights import (
        SCENES, manylight_cell)
    cell = manylight_cell(SCENES / "manylight16k.pbrt")
    images, get_image = [], film.get_image

    def recorded(*a, **k):
        images.append(get_image(*a, **k))
        return images[-1]

    monkeypatch.setattr(film, "get_image", recorded)
    seed = 3
    assert harness.run(cell, seed, 0.05, False, "cpu", 0.0)["correct"] \
        is True
    with faults.planted("altered", film, path):
        result = harness.run(cell, seed, 0.05, False, "cpu", 0.0)
    assert result["correct"] is False and result["failed"] == 1
    assert len(images) >= 4
    assert all(not img[8, 8].any() and img.any() for img in images)


def film_of(golden, wl):
    """An image of the cell's film whose part that the golden shows is the
    golden, each of its pixels spread over the film's pixels it covers
    (nearest), and black elsewhere."""
    if wl.golden_window is None:
        return golden.copy()
    x0, y0, x1, y1 = wl.golden_window
    img = np.zeros((wl.height, wl.width, 3), np.float32)
    gy = (np.arange(y1 - y0) * golden.shape[0]) // (y1 - y0)
    gx = (np.arange(x1 - x0) * golden.shape[1]) // (x1 - x0)
    img[y0:y1, x0:x1] = golden[gy][:, gx]
    return img


@pytest.mark.parametrize("name", CELLS)
def test_golden_number(name):
    """golden_mrse against pbrt-v4's render: 0 on the render itself (near
    0 where a larger film shows it, resampled); over the cell's limit with
    the brighter half of the image blank (a scene may be dark in the
    other); inf on a crop; the trim drops the largest pixel errors
    alone."""
    wl = spec.load_cell(name).workload
    golden = checks.read_golden(wl.golden)
    limit = wl.limits["golden_mrse"]
    film = film_of(golden, wl)
    got = checks.compare(film, film, golden, wl.golden_trim,
                         window=wl.golden_window)["golden_mrse"]
    assert got == 0 if wl.golden_window is None else got < limit / 10
    gh = golden.shape[0] // 2
    top = golden[:gh].mean() > golden[gh:].mean()

    def brighter(n):
        return slice(None, n // 2) if top else slice(n // 2, None)

    film[brighter(wl.height)] = 0
    assert checks.compare(film, film, golden, wl.golden_trim,
                          window=wl.golden_window)["golden_mrse"] > limit
    assert checks.compare(film[:16, :16], film[:16, :16], golden,
                          window=wl.golden_window)["golden_mrse"] == np.inf
    half = golden.copy()
    half[brighter(golden.shape[0])] = 0
    assert checks.golden_mrse(half, golden, wl.golden_trim) > limit
    crop = golden[:16, :16]
    assert checks.compare(crop, crop, golden)["golden_mrse"] == np.inf
    spot = golden.copy()
    spot[0, 0] += 1e6
    assert checks.golden_mrse(spot, golden, 0.0) > limit
    assert checks.golden_mrse(spot, golden, 0.002) == 0


def test_resample():
    """Area averages: a constant stays constant; a whole factor averages
    blocks; a fractional one weighs the pixels it cuts by their part."""
    ones = np.ones((27, 40, 3))
    out = checks.resample(ones, (5, 0, 32, 27), (10, 10))
    assert out.shape == (10, 10, 3) and np.allclose(out, 1.0)
    rng = np.random.default_rng(0)
    img = rng.random((12, 18, 3))
    blocks = img[:, 3:15].reshape(4, 3, 4, 3, 3).mean(axis=(1, 3))
    assert np.allclose(checks.resample(img, (3, 0, 15, 12), (4, 4)), blocks)
    row = np.array([[[1.0] * 3, [2.0] * 3, [4.0] * 3]])
    # three pixels into two: the middle one split in half
    assert np.allclose(checks.resample(row, (0, 0, 3, 1), (1, 2))[0, :, 0],
                       [(1 + 0.5 * 2) / 1.5, (0.5 * 2 + 4) / 1.5])


def test_sampled_rows():
    """One row drawn from the seed in each of n equal bands, in order; the
    same for the same seed and image; every row where n reaches the
    height."""
    big = 2 ** 31 + 4321
    rows = checks.sample_rows(big, 3, 1080, 108)
    assert len(rows) == 108 and np.array_equal(rows // 10, np.arange(108))
    assert np.array_equal(rows, checks.sample_rows(big, 3, 1080, 108))
    assert not np.array_equal(rows, checks.sample_rows(big, 4, 1080, 108))
    assert checks.sample_rows(big, 0, 16, 16) is None
    assert checks.sample_rows(big, 0, 16, None) is None


def sampled(name, rows=5):
    cell = tiny(name)
    return dataclasses.replace(cell, workload=dataclasses.replace(
        cell.workload, width=20, height=12, reference_rows=rows))


@pytest.mark.parametrize("name", CELLS)
def test_reference_renders_sampled_rows(name):
    """The reference's render of a sample of rows is those rows of its
    whole image, bit for bit, and of the program's."""
    cell = sampled(name)
    wl = cell.workload
    s = checks.image_seed(5, 0)
    got, _ = harness.Program(cell, "cpu", seed=5).render(s)
    ref = checks.Reference(spec.scene_text(cell, wl), cell.scene_path.parent,
                           wl, "cpu")
    rows = checks.sample_rows(5, 0, wl.height, wl.reference_rows)
    part = ref.render(s, rows)
    assert part.shape == (5, 20, 3)
    assert np.array_equal(part, got[rows])
    assert np.array_equal(ref.render(s, None, range(4, 16)), got[:, 4:16])


@pytest.mark.parametrize("fault", ("unchanged", "half"))
def test_fault_is_caught_on_sampled_rows(fault):
    """Where the reference renders a sample of rows, a fault that spoils
    every image or half of each wave still makes correct false (one
    altered pixel is caught only where its row is drawn)."""
    from pbrt_tpu_torch import film
    from pbrt_tpu_torch.integrators import path
    cell = sampled("cornell.1080p")
    assert harness.run(cell, 2 ** 31 + 98, 0.05, False, "cpu",
                       0.0)["correct"] is True
    with faults.planted(fault, film, path):
        result = harness.run(cell, 2 ** 31 + 98, 0.05, False, "cpu", 0.0)
    assert result["correct"] is False


def test_control_reads_a_windowed_golden():
    """The control on a wide film whose central square the golden shows,
    with sampled rows: every number read, finite, over a limit."""
    cell = spec.load_cell("cornell.1080p")
    wl = dataclasses.replace(cell.workload, width=24, height=12, spp=4,
                             reference_rows=4, golden_window=(6, 0, 18, 12))
    r = control.readings(dataclasses.replace(cell, workload=wl), 11, "cpu")
    assert r["rows"] == 4 and set(r["numbers"]) == set(checks.NUMBERS)
    assert all(np.isfinite(v) for v in r["numbers"].values())
    assert not checks.within(r["numbers"], r["limits"])


def test_seeds():
    big = 2 ** 31 + 12345
    assert checks.image_seed(big, 0) == checks.image_seed(big, 0)
    seeds = {checks.image_seed(big, i) for i in range(-1, 100)}
    assert len(seeds) == 101 and max(seeds) < 2 ** 31
    assert 0 <= checks.sample_index(big, 7) < 7


GUARD = """
import sys, types
sys.path.insert(0, {root!r})
from portbench import harness
import pbrt_tpu_torch
harness.guard("clean")
sys.modules[{name!r}] = types.ModuleType({name!r})
try:
    harness.guard("planted")
except harness.ForbiddenImport as e:
    print("caught", e)
"""


@pytest.mark.parametrize("name", ["pbrt_tpu", "jax", "jaxlib", "flax",
                                  "pbrt_tpu.scene"])
def test_guard_in_a_subprocess(name):
    out = subprocess.run([sys.executable, "-c",
                          GUARD.format(root=str(spec.ROOT), name=name)],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("caught planted: loaded "
                                 + name.split(".")[0])


def test_run_without_a_card_prints_no_result(tmp_path):
    """No card: a nonzero exit and no result; the same in a directory that
    holds only BENCHMARK.json and the benchmark's folder."""
    cmd = [sys.executable, "portbench/run.py", "--workload",
           "cornell.1080p", "--seed", str(2 ** 31 + 5), "--seconds", "1",
           "--trace", "0"]
    out = subprocess.run(cmd, cwd=spec.ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache",
                                                  "_build"))
    out = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(card, name):
    """A short run of each cell on the card: a result that is correct."""
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", name, "--seed",
         str(2 ** 31 + 77), "--seconds", "2", "--trace", "1"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["busy_s"] > 0
