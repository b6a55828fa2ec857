"""Environment-map reparameterization (counterpart of
pbrt_tpu/utils/image_env.py; pbrt's imgtool makeequiarea): a lat-long
(equirectangular) image -> the equal-area octahedral square the image
infinite light reads."""
from __future__ import annotations

import numpy as np
import torch

from . import vecmath as vm


def equalarea_from_latlong(img: np.ndarray, res: int = None) -> np.ndarray:
    """img: (H, W, 3) equirectangular (theta down the rows, phi across the
    columns). Returns the (res, res, 3) float32 equal-area image, bilinear
    with phi wrapping and theta clamped; res defaults to the power of two
    nearest H, at least 16."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    if res is None:
        res = max(16, int(2 ** np.round(np.log2(max(h, 1)))))
    u, v = np.meshgrid((np.arange(res) + 0.5) / res,
                       (np.arange(res) + 0.5) / res, indexing="xy")
    uv = torch.as_tensor(np.stack([u, v], -1).reshape(-1, 2),
                         dtype=torch.float32)
    d = vm.equal_area_square_to_sphere(uv).numpy()
    theta = np.arccos(np.clip(d[:, 2], -1, 1))
    phi = np.arctan2(d[:, 1], d[:, 0])
    phi = np.where(phi < 0, phi + 2 * np.pi, phi)
    x = phi / (2 * np.pi) * w - 0.5
    y = theta / np.pi * h - 0.5
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    xs0 = np.mod(x0, w)
    xs1 = np.mod(x0 + 1, w)
    ys0 = np.clip(y0, 0, h - 1)
    ys1 = np.clip(y0 + 1, 0, h - 1)
    out = (img[ys0, xs0] * (1 - fx) * (1 - fy) + img[ys0, xs1] * fx * (1 - fy)
           + img[ys1, xs0] * (1 - fx) * fy + img[ys1, xs1] * fx * fy)
    return out.reshape(res, res, 3).astype(np.float32)
