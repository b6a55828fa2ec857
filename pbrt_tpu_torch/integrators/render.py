"""Render driver (counterpart of pbrt_tpu/integrators/render.py): a plain
loop over sample-index batches, through the path integrator or, for a
scene with media, the volumetric one (reference wave_module).

Every wave covers the whole image and m consecutive sample indices (m a
power of two, chosen like the reference's wave tiling: as many as fit
under 2^18 lanes), then adds its samples into the film. On a card, a
render whose waves take the megakernel with in-kernel camera rays
(path.in_kernel_camera) runs each wave as ops/megafront.wave: the lanes
kernel, the megakernel and the film kernel, their arguments made once a
render. Each call is one image of spans.py: the root span `render.image`,
a `render.wave` span a wave, and the counter `wave.lanes`.
"""
from __future__ import annotations

import time

import torch

from .. import device as dev_mod
from .. import film as film_mod
from .. import filters as flt
from .. import samplers as smp
from .. import spans
from ..ops import megafront
from . import path as path_mod
from . import volpath as volpath_mod

MAX_WAVE_LANES = 1 << 18


def wave_module(scene):
    """The integrator of a scene (reference wave_module): volpath where the
    scene has media, else path."""
    return volpath_mod if scene.has_media else path_mod


def render(scene, camera, spp=16, *, device, sampler=None, filt=None,
           opts: path_mod.PathOptions = None):
    """Render and return (image (H, W, 3) float32 linear RGB, stats dict)
    through wave_module(scene)'s waves.

    device: where to render; the scene's tables must live there."""
    device = dev_mod.resolve(device)
    if scene.device != device:
        raise ValueError(f"scene lives on {scene.device}, render on {device}")
    W, H = camera.width, camera.height
    sampler = sampler or smp.make_sampler("zsobol", spp=spp,
                                          full_resolution=(W, H))
    filt = filt or flt.make_filter("gaussian")
    sensor = film_mod.make_pixel_sensor()
    opts = opts or path_mod.PathOptions()
    wave = wave_module(scene)
    n_pix = W * H
    n_waves = sampler.spp
    m = 1
    while m * 2 * n_pix <= MAX_WAVE_LANES and n_waves % (m * 2) == 0:
        m *= 2
    with spans.image(device, spp=sampler.spp, width=W, height=H,
                     lanes_per_wave=n_pix * m, waves=n_waves // m):
        film = film_mod.make_film(W, H, device)
        front = None
        if device.type == "cuda" and wave is path_mod and \
                path_mod.in_kernel_camera(scene, sampler, camera, filt, opts):
            front = megafront.prepare(scene, camera, sampler, filt, sensor,
                                      film, m, opts.max_depth,
                                      opts.rr_start_depth)
        else:
            pixel_idx = torch.arange(n_pix, dtype=torch.int64,
                                     device=device).repeat(m)
            lane_s = torch.arange(n_pix * m, dtype=torch.int64,
                                  device=device) // n_pix
        dev_mod.synchronize(device)
        t0 = time.perf_counter()
        for s in range(0, n_waves, m):
            with spans.span("render.wave", wave=s // m):
                spans.count("wave.lanes", n_pix * m)
                if front is not None:
                    megafront.wave(front, s)
                    continue
                L, swl, fw = wave.render_wave(scene, camera, sampler, filt,
                                              pixel_idx, s + lane_s, opts)
                rgb = film_mod.sensor_to_sensor_rgb(sensor, L, swl)
                film_mod.add_samples(film, pixel_idx, rgb, fw, identity=True)
        dev_mod.synchronize(device)
        dt = time.perf_counter() - t0
        img = film_mod.get_image(film, sensor)
    n_paths = n_pix * n_waves
    return img, dict(seconds=dt, paths_per_sec=n_paths / max(dt, 1e-9),
                     spp=sampler.spp, lanes_per_wave=n_pix * m)
