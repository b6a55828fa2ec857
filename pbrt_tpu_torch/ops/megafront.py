"""The megakernel's front end and film in two kernels (csrc/megafront.cu),
for a render whose every wave goes through the whole-path megakernel with
in-kernel camera rays (path.in_kernel_camera).

A wave there is three launches, and the lane counter's memset: the lanes
kernel (`lanes`) writes each lane's morton|spp index, its four wavelengths
from the ZSobol draw of dimension 5 and the light spectrum at them into
the megakernel's input buffers; the megakernel (ops/megawave.py) traces
the paths; the film kernel (`film`) projects their radiance onto the
sensor and adds each pixel's rows into the film's accumulator. `prepare`
makes, once a render, what the waves share: the buffers, the camera
table, the megakernel's and both kernels' arguments, so that no tensor is
made or uploaded in the wave loop.

The reference has no such kernels: its front end is XLA tensor ops, and so
is the port's other route (path.render_wave, film.sensor_to_sensor_rgb,
film.add_samples), which the plain versions here call. Each wrapper runs
its plain version for CPU tensors and its kernel for CUDA tensors.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import film as film_mod
from .. import samplers as smp
from .. import spans
from ..utils import spectrum as spc
from . import LaunchCounter, megawave

LAMBDA_DIM = 5   # the sampler dimension of the wavelength draw

lanes_counter = LaunchCounter("mega_lanes")
film_counter = LaunchCounter("mega_film")


@dataclasses.dataclass
class Front:
    """One render's waves through the kernels. full: the megakernel's
    inputs, whose mi (int32 u32 bits), lam and le the lanes kernel writes;
    L and fw: the megakernel's outputs, which the film kernel reads. On a
    card, mega_args, lanes_args and film_args: the three kernels'
    arguments (the lanes kernel's without its first, the wave's first
    sample index), and keep: the tensors they point into."""
    scene: object
    camera: object
    sampler: object
    sensor: film_mod.PixelSensor
    film: film_mod.Film
    n_pix: int
    m: int
    full: megawave.FullWave
    L: torch.Tensor = None
    fw: torch.Tensor = None
    mega_args: tuple = None
    lanes_args: tuple = None
    film_args: tuple = None
    keep: tuple = ()


def prepare(scene, camera, sampler, filt, sensor, film, m, max_depth=5,
            rr_start=1) -> Front:
    """The render's waves of m sample indices over the film's pixels."""
    import ctypes
    dev = film.accum.device
    n_pix = camera.width * camera.height
    n = n_pix * m
    full = megawave.wave_of(
        scene, sampler, torch.empty((n,), dtype=torch.int32, device=dev),
        torch.empty((n, 4), dtype=torch.float32, device=dev),
        torch.empty((n, 4), dtype=torch.float32, device=dev), max_depth,
        rr_start, cam=megawave.camera_table(camera, dev), filt=filt)
    front = Front(scene, camera, sampler, sensor, film, n_pix, m, full)
    if dev.type != "cuda":
        return front
    if not (film.accum.is_contiguous() and film.accum.data_ptr() % 16 == 0
            and film.accum.shape == (n_pix, 8)):
        raise ValueError("megafront: the film's accumulator must be a "
                         "contiguous, 16-byte aligned (H*W, 8) tensor")
    spec = scene.spectra_pool[scene.mega.light_spec].contiguous()
    with torch.cuda.device(dev):
        front.mega_args, front.L, front.fw, keep = megawave.launch_args(full)
        seeds = megawave.device_seeds(dev, full.seed, full.max_depth)
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    front.lanes_args = (
        seeds.data_ptr(), spec.data_ptr(), full.mi.data_ptr(),
        full.lam.data_ptr(), full.le.data_ptr(), n, n_pix, camera.width,
        full.log2_spp, full.B, stream)
    front.film_args = (front.L.data_ptr(), front.fw.data_ptr(),
                       full.lam.data_ptr(), film.accum.data_ptr(), n_pix, m,
                       float(sensor.imaging_ratio), stream)
    front.keep = (*keep, seeds, spec)
    return front


def wave(front: Front, s: int):
    """The wave of sample indices s ... s + m - 1: lanes, megakernel, film.
    On the CPU the plain versions throughout."""
    lanes(front, s)
    if front.mega_args is None:
        front.L, front.fw = megawave.wave_full(front.full)
    else:
        with torch.cuda.device(front.full.lam.device):
            megawave.launch(front.mega_args)
    film(front)


@spans.span("megawave.prepare")
def lanes(front: Front, s: int):
    """Write the lanes of the wave whose first sample index is s into
    front.full's mi, lam and le."""
    if front.lanes_args is None:
        return lanes_plain(front, s)
    from . import _build
    lib = _build.load_library("megafront")
    with torch.cuda.device(front.full.lam.device):
        err = lib.mega_lanes_launch(s, *front.lanes_args)
    _build.check(err, "mega_lanes")
    lanes_counter.launches += 1


def lanes_plain(front: Front, s: int):
    """Plain version: path.camera_lanes' draw and megawave's front end
    (samplers.morton_index, megawave.light_spectrum)."""
    lanes_counter.plain += 1
    w, dev = front.full, front.full.lam.device
    lane = torch.arange(front.n_pix * front.m, dtype=torch.int64, device=dev)
    pix, si = lane % front.n_pix, s + lane // front.n_pix
    px, py = pix % front.camera.width, pix // front.camera.width
    lam = spc.sample_visible_wavelengths(smp.sample_1d(
        front.sampler, px, py, si, LAMBDA_DIM)).lam
    w.mi.copy_(megawave.encode_mi(smp.morton_index(front.sampler, px, py,
                                                   si)))
    w.lam.copy_(lam)
    w.le.copy_(megawave.light_spectrum(front.scene, lam))


@spans.span("film.add")
def film(front: Front):
    """Add the wave's radiance front.L (n, 4) and filter weights front.fw
    (n,), at front.full's wavelengths, into front.film."""
    if front.film_args is None:
        return film_plain(front)
    from . import _build
    lib = _build.load_library("megafront")
    with torch.cuda.device(front.full.lam.device):
        err = lib.mega_film_launch(*front.film_args)
    _build.check(err, "mega_film")
    film_counter.launches += 1


def film_plain(front: Front):
    """Plain version: film.sensor_to_sensor_rgb at the wavelengths' pdf
    (spectrum.visible_wavelengths_pdf), then film.add_samples."""
    film_counter.plain += 1
    lam = front.full.lam
    swl = spc.SampledWavelengths(lam=lam,
                                 pdf=spc.visible_wavelengths_pdf(lam))
    rgb = film_mod.sensor_to_sensor_rgb(front.sensor, front.L, swl)
    pixel_idx = torch.arange(front.n_pix, device=lam.device).repeat(front.m)
    film_mod.add_samples(front.film, pixel_idx, rgb, front.fw, identity=True)
