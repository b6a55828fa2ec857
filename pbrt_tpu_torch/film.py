"""Film and pixel sensor (counterpart of pbrt_tpu/film.py): the default
CIE 1931 sensor and the RGB film.

The film accumulates one (H*W, 8) float32 tensor per image, columns
[rgb_sum(3), weight_sum, lum_sum, lum_sq_sum, n_samples, pad], as the
reference does; `add_samples` adds into it in place.
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from . import device as dev_mod
from . import spans
from .ops import film_readout
from .utils import color as pcolor
from .utils import spectrum as spc


@dataclasses.dataclass(frozen=True)
class PixelSensor:
    """The cie1931 sensor: analytic CIE curves, identity white balance."""
    xyz_from_sensor_rgb: np.ndarray   # (3, 3)
    imaging_ratio: float


def make_pixel_sensor() -> PixelSensor:
    """The reference's default sensor (cie1931, ISO 100, exposure 1); named
    sensors and white balance are queued in ROADMAP.md (slice 6)."""
    return PixelSensor(xyz_from_sensor_rgb=np.eye(3, dtype=np.float32),
                       imaging_ratio=1.0)


@spans.span("film.sensor_rgb")
def sensor_to_sensor_rgb(sensor: PixelSensor, L: torch.Tensor,
                         swl: spc.SampledWavelengths) -> torch.Tensor:
    """Monte Carlo projection of sampled radiance L (N, 4) onto the sensor
    curves -> (N, 3) (reference PixelSensor::ToSensorRGB)."""
    w = spc.safe_div_spectrum(L, swl.pdf) / spc.CIE_Y_INTEGRAL
    X, Y, Z = spc.eval_cie_xyz_analytic(swl.lam)
    rgb = torch.stack([torch.mean(X * w, -1), torch.mean(Y * w, -1),
                       torch.mean(Z * w, -1)], dim=-1)
    return sensor.imaging_ratio * rgb


@dataclasses.dataclass
class Film:
    accum: torch.Tensor   # (H*W, 8)
    width: int
    height: int


def make_film(width, height, device) -> Film:
    return Film(accum=torch.zeros((width * height, 8), dtype=torch.float32,
                                  device=dev_mod.resolve(device)),
                width=width, height=height)


@spans.span("film.add")
def add_samples(film: Film, pixel_index: torch.Tensor, rgb: torch.Tensor,
                weight: torch.Tensor, identity=False) -> Film:
    """Add weighted samples into the film, in place (reference
    RGBFilm::AddSample). identity: pixel_index is arange(H*W) tiled m
    times, so the m rows of each pixel are summed and added densely; else
    an index_add_."""
    rgb = torch.where(torch.isfinite(rgb), rgb, 0.0)
    lum = 0.2126 * rgb[:, 0] + 0.7152 * rgb[:, 1] + 0.0722 * rgb[:, 2]
    row = torch.cat([rgb * weight[:, None], weight[:, None], lum[:, None],
                     (lum * lum)[:, None], torch.ones_like(lum)[:, None],
                     torch.zeros_like(lum)[:, None]], dim=1)
    if identity:
        hw = film.accum.shape[0]
        m = row.shape[0] // hw
        film.accum += row if m == 1 else row.reshape(m, hw, 8).sum(dim=0)
    else:
        film.accum.index_add_(0, pixel_index.to(torch.int64), row)
    return film


@spans.span("film.get_image")
def get_image(film: Film, sensor: PixelSensor) -> np.ndarray:
    """(H, W, 3) float32 linear sRGB (reference RGBFilm::GetPixelRGB), a
    fresh array the caller owns. On a card the readout kernel computes the
    image there and only the image is copied to the host, through the
    device's pinned staging buffer."""
    img = film_readout.film_readout(
        film.accum.detach(), film.height, film.width,
        sensor.xyz_from_sensor_rgb, pcolor.srgb().rgb_from_xyz)
    if img.device.type != "cuda":
        return img.numpy()
    with _staging_lock:
        staging = _staging.get(img.device)
        if staging is None or staging.shape != img.shape:
            staging = torch.empty(img.shape, dtype=img.dtype,
                                  pin_memory=True)
            _staging[img.device] = staging
        staging.copy_(img)
        return staging.numpy().copy()


# one pinned (H, W, 3) float32 host buffer a card, kept across readouts of
# one shape and remade when the film's shape changes
_staging: dict = {}
_staging_lock = threading.Lock()
