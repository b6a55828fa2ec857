"""The megakernel's front end and film kernels (pbrt_tpu_torch.ops.megafront)
on the CPU, through their plain versions:

- the lanes entry writes the megakernel's inputs mi, lam and le bit for bit
  as path.camera_lanes and megawave.prepare_full make them, and the film
  entry adds to the accumulator bit for bit what film.sensor_to_sensor_rgb
  and film.add_samples add, on cornell films of 64x48 (m = 1 sample index
  a wave) and 16x16 (m = 4), 8 spp;
- on CPU tensors the wrappers count plain runs and no launches;
- the route's waves (lanes, megakernel, film) give render.render's image
  bit for bit, in waves of 1, 4 and 8 sample indices (on the CPU
  render.render itself keeps the chain of path.render_wave,
  film.sensor_to_sensor_rgb and film.add_samples).

The kernels are held to these plain versions on the card in
tests/test_torch_cuda.py. The file imports no jax.
"""
import numpy as np
import pytest
import torch

from pbrt_tpu_torch import film as film_mod
from pbrt_tpu_torch import filters as flt
from pbrt_tpu_torch import samplers as smp
from pbrt_tpu_torch import scenes, spans
from pbrt_tpu_torch.integrators import path as path_mod
from pbrt_tpu_torch.integrators import render
from pbrt_tpu_torch.ops import megafront, megawave

SPP = 8
FILMS = [(64, 48, 1), (16, 16, 4)]   # width, height, m


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


def _setup(width, height, m, seed=11):
    scene, cam = scenes.make_cornell_box(width, height, device="cpu")
    sampler = smp.make_sampler("zsobol", SPP, seed,
                               full_resolution=(width, height))
    sensor = film_mod.make_pixel_sensor()
    front = megafront.prepare(scene, cam, sampler,
                              flt.make_filter("gaussian"), sensor,
                              film_mod.make_film(width, height, "cpu"), m)
    return scene, cam, sampler, sensor, front


def _todays_wave(scene, cam, sampler, n_pix, m, s):
    """The chain the route replaces: path.camera_lanes, then
    megawave.prepare_full. Returns (its FullWave, wavelengths, pixel ids)."""
    pixel_idx = torch.arange(n_pix, dtype=torch.int64).repeat(m)
    si = s + torch.arange(n_pix * m, dtype=torch.int64) // n_pix
    px, py, swl = path_mod.camera_lanes(cam, sampler, pixel_idx, si)
    w = megawave.prepare_full(scene, sampler, cam,
                              flt.make_filter("gaussian"), px, py, si,
                              swl.lam)
    return w, swl, pixel_idx


@pytest.mark.parametrize("width, height, m", FILMS)
def test_plain_entries_equal_todays_chain(width, height, m):
    scene, cam, sampler, sensor, front = _setup(width, height, m)
    n_pix = width * height
    film = film_mod.make_film(width, height, "cpu")
    for s in (0, SPP - m):
        megafront.lanes(front, s)
        w, swl, pixel_idx = _todays_wave(scene, cam, sampler, n_pix, m, s)
        got = front.full
        assert got.mi.dtype == torch.int32
        assert torch.equal(got.mi, w.mi)
        assert torch.equal(got.lam.view(torch.int32),
                           w.lam.view(torch.int32))
        assert torch.equal(got.le.view(torch.int32), w.le.view(torch.int32))
        front.L, front.fw = megawave.wave_full_plain(w)
        megafront.film(front)
        rgb = film_mod.sensor_to_sensor_rgb(sensor, front.L, swl)
        film_mod.add_samples(film, pixel_idx, rgb, front.fw, identity=True)
        assert torch.equal(front.film.accum.view(torch.int32),
                           film.accum.view(torch.int32))
    assert front.film.accum[:, 6].eq(2 * m).all()


def test_counters_count_plain_runs_on_the_cpu():
    _scene, _cam, _sampler, _sensor, front = _setup(16, 16, 4)
    counters = (megafront.lanes_counter, megafront.film_counter,
                megawave.counter)
    before = [(c.launches, c.plain) for c in counters]
    megafront.wave(front, 0)
    megafront.wave(front, 4)
    for c, (launches, plain) in zip(counters, before):
        assert (c.launches, c.plain) == (launches, plain + 2)
    assert spans.counter("plain.mega_lanes") == megafront.lanes_counter.plain
    assert spans.counter("launches.mega_film") == \
        megafront.film_counter.launches


@pytest.mark.parametrize("max_lanes", [256, 1024, 1 << 18])
def test_route_waves_give_renders_image(monkeypatch, max_lanes):
    """16x16, 8 spp in waves of m = 1, 4 and 8 sample indices (render's
    tiling under max_lanes lanes a wave)."""
    monkeypatch.setattr(render, "MAX_WAVE_LANES", max_lanes)
    scene, cam, sampler, sensor, _front = _setup(16, 16, 1)
    want, st = render.render(scene, cam, SPP, device="cpu", sampler=sampler)
    m = st["lanes_per_wave"] // (16 * 16)
    assert m == min(max_lanes // 256, SPP)
    _scene, _cam, _sampler, sensor, front = _setup(16, 16, m)
    for s in range(0, SPP, m):
        megafront.wave(front, s)
    assert np.array_equal(film_mod.get_image(front.film, sensor), want)
