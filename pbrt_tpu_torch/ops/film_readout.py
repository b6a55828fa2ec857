"""The film's readout (csrc/film.cu): the (H, W, 3) float32 linear RGB
image of the film's (H*W, 8) accumulator, computed where the accumulator
lives, so that on a card only the image crosses to the host.

The reference reads the film out in NumPy (pbrt_tpu/film.py get_image);
the plain version here is that readout in PyTorch, with each 3x3 product
written out in the kernel's order and the colour space's product in
float64, as NumPy computes it against the float64 matrix. The wrapper runs
the plain version for CPU tensors and the kernel for CUDA tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from . import LaunchCounter

counter = LaunchCounter("film_readout")


def film_readout(accum: torch.Tensor, height: int, width: int,
                 xyz_from_sensor_rgb, rgb_from_xyz) -> torch.Tensor:
    """(height, width, 3) float32 on accum's device: accum[:, 0:3] over
    max(accum[:, 3], 1e-12), through the sensor's xyz_from_sensor_rgb
    (3, 3) in float32, then the colour space's rgb_from_xyz (3, 3) in
    float64, rounded to float32."""
    if accum.device.type != "cuda":
        return film_readout_plain(accum, height, width, xyz_from_sensor_rgb,
                                  rgb_from_xyz)
    import ctypes
    from . import _build
    n_pix = height * width
    if not (accum.dtype == torch.float32 and accum.is_contiguous()
            and accum.data_ptr() % 16 == 0 and accum.shape == (n_pix, 8)):
        raise ValueError("film_readout: the accumulator must be a "
                         "contiguous, 16-byte aligned (H*W, 8) float32 "
                         "tensor")
    s = np.ascontiguousarray(xyz_from_sensor_rgb, dtype=np.float32)
    m = np.ascontiguousarray(rgb_from_xyz, dtype=np.float64)
    if s.shape != (3, 3) or m.shape != (3, 3):
        raise ValueError("film_readout: the matrices must be 3x3")
    out = torch.empty((height, width, 3), dtype=torch.float32,
                      device=accum.device)
    lib = _build.load_library("film")
    with torch.cuda.device(accum.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        err = lib.film_readout_launch(accum.data_ptr(), out.data_ptr(),
                                      n_pix, s.ctypes.data, m.ctypes.data,
                                      stream)
    _build.check(err, "film_readout")
    counter.launches += 1
    return out


def film_readout_plain(accum: torch.Tensor, height: int, width: int,
                       xyz_from_sensor_rgb, rgb_from_xyz) -> torch.Tensor:
    """Plain version: the kernel's operations in its order, as tensor ops
    (NaN weight sums pass through the max, as np.maximum passes them)."""
    counter.plain += 1
    dev = accum.device
    s = torch.as_tensor(np.asarray(xyz_from_sensor_rgb, np.float32),
                        device=dev)
    m = torch.as_tensor(np.asarray(rgb_from_xyz, np.float64), device=dev)
    w = torch.maximum(accum[:, 3:4],
                      torch.tensor(1e-12, dtype=torch.float32, device=dev))
    rgb = accum[:, 0:3] / w
    xyz = ((rgb[:, 0:1] * s[:, 0] + rgb[:, 1:2] * s[:, 1])
           + rgb[:, 2:3] * s[:, 2]).double()
    out = ((xyz[:, 0:1] * m[:, 0] + xyz[:, 1:2] * m[:, 1])
           + xyz[:, 2:3] * m[:, 2])
    return out.float().reshape(height, width, 3)
