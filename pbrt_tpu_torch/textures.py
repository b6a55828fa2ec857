"""Textures (counterpart of pbrt_tpu/textures.py): the subset an image
texture on uv needs.

Every image lives in one flat atlas whose texels are the image's RGB
already turned into sigmoid-polynomial coefficients and a scale (on the
host, at build), each texture a descriptor row, each image with its full
MIP pyramid (2x2 box filter of the image resampled to powers of two).
Evaluation returns (coeffs (N, 3), scale (N,)): the spectral albedo is
sigmoid(coeffs, lam) * scale. A lookup with a uv footprint (the ray
cone's, integrators/path.py) filters trilinearly between two MIP levels;
without one, bilinearly at level 0. The layout is the reference's, so the
two builders' tables can be compared array for array.

Only the constant and image textures under the uv mapping are ported;
the other mappings, EWA filtering, raw (float) images and the procedural
and mixing textures are refused (ROADMAP.md slice 3 item 21).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import device as dev_mod
from . import spans

TEX_CONSTANT = 0   # the reference's tags
TEX_IMAGE = 1
# descriptor columns: [0] tag [1] img_offset [2] width [3] height
# [4:7] value_a (rgb coeffs) [7:10] value_b (scale first) [10] su [11] sv
# [12] du [13] dv [14] octaves (unused here) [15] omega (unused here)
TEX_COLS = 16
MIP_COLS = 16   # [n_levels, offset of level 0 .. 14]


@dataclasses.dataclass(frozen=True)
class TexturePool:
    desc: torch.Tensor    # (K, 16) float32 descriptor rows
    atlas: torch.Tensor   # (A, 4) float32 texels [c0, c1, c2, scale]
    mips: torch.Tensor    # (K, 16) float32 [n_levels, off0 .. off14]
    has_image: bool = False
    has_mips: bool = False


class TextureBuilder:
    """Host-side accumulation of texture rows and atlas texels."""

    def __init__(self, colorspace):
        self.cs = colorspace
        self.rows = []
        self.mip_rows = []
        self.atlas = [np.zeros((1, 4), np.float32)]
        self.atlas_size = 1

    def _rgb_to_coeffs_scale(self, rgb):
        """RGB (any positive range) -> (coeffs (..., 3), scale (...)) with
        sigmoid(coeffs) * scale giving back rgb (RGBUnboundedSpectrum)."""
        rgb = np.asarray(rgb, np.float32).reshape(-1, 3)
        m = np.maximum(rgb.max(axis=-1), 1e-9)
        scale = np.where(rgb.max(axis=-1) > 1.0, 2.0 * m, 1.0).astype(
            np.float32)
        return self.cs.to_spectrum_coeffs(rgb / scale[:, None]), scale

    @staticmethod
    def _resample_pow2(img):
        """(H, W, C) to the next power-of-two sizes, nearest texel (the
        reference's MIPMap resampling)."""
        h, w = img.shape[:2]
        ph = 1 << max(int(np.ceil(np.log2(max(h, 1)))), 0)
        pw = 1 << max(int(np.ceil(np.log2(max(w, 1)))), 0)
        if (ph, pw) == (h, w):
            return img
        ys = np.minimum((np.arange(ph) * h) // ph, h - 1)
        xs = np.minimum((np.arange(pw) * w) // pw, w - 1)
        return img[ys][:, xs]

    @staticmethod
    def _pyramid(img):
        """[level 0, level 1, ...] by 2x2 box filter down to 1x1."""
        levels = [img]
        while img.shape[0] > 1 or img.shape[1] > 1:
            h, w = img.shape[:2]
            h2, w2 = max(h // 2, 1), max(w // 2, 1)
            if h > 1 and w > 1:
                img = 0.25 * (img[0::2, 0::2][:h2, :w2] +
                              img[1::2, 0::2][:h2, :w2] +
                              img[0::2, 1::2][:h2, :w2] +
                              img[1::2, 1::2][:h2, :w2])
            elif h > 1:
                img = 0.5 * (img[0::2][:h2] + img[1::2][:h2])
            else:
                img = 0.5 * (img[:, 0::2][:, :w2] + img[:, 1::2][:, :w2])
            levels.append(img)
        return levels

    def _add_mip_levels(self, img, to_texels):
        """Append the pyramid of img, resampled to powers of two, to the
        atlas. Returns (the resampled image, each level's offset)."""
        img = self._resample_pow2(img)
        offsets = []
        for lv in self._pyramid(img):
            offsets.append(self.atlas_size)
            t = to_texels(lv.reshape(-1, lv.shape[-1]))
            self.atlas.append(t)
            self.atlas_size += t.shape[0]
        return img, offsets

    def _add_row(self, tag, img_offset=0, width=0, height=0,
                 value_a=(0, 0, 0), value_b=(0, 0, 0), su=1.0, sv=1.0,
                 du=0.0, dv=0.0, mip_offsets=()):
        row = np.zeros(TEX_COLS, np.float32)
        row[0] = tag
        row[1:4] = (img_offset, width, height)
        row[4:7] = value_a
        row[7:10] = value_b
        row[10:14] = (su, sv, du, dv)
        row[14:16] = (6, 0.5)   # the reference's procedural defaults
        self.rows.append(row)
        mip = np.zeros(MIP_COLS, np.float32)
        mip[0] = len(mip_offsets)
        mip[1:1 + min(len(mip_offsets), 15)] = mip_offsets[:15]
        self.mip_rows.append(mip)
        return len(self.rows) - 1

    def add_constant(self, rgb) -> int:
        c, s = self._rgb_to_coeffs_scale(
            np.broadcast_to(np.asarray(rgb, np.float32), (1, 3)))
        return self._add_row(TEX_CONSTANT, value_a=c[0], value_b=(s[0], 0, 0))

    def add_image(self, img, su=1.0, sv=1.0, du=0.0, dv=0.0, scale=1.0) -> int:
        """img: (H, W, 3) float32 linear RGB (or (H, W) gray); its texels
        are turned into coefficients and a scale, its MIP pyramid built.
        su, sv, du, dv: the uv mapping's scale and offset."""
        img = np.asarray(img, np.float32)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, -1)

        def to_texels(flat_rgb):
            c, s = self._rgb_to_coeffs_scale(flat_rgb * scale)
            return np.concatenate([c, s[:, None]], 1)

        img, offs = self._add_mip_levels(img, to_texels)
        h, w = img.shape[:2]
        return self._add_row(TEX_IMAGE, img_offset=offs[0], width=w,
                             height=h, su=su, sv=sv, du=du, dv=dv,
                             mip_offsets=offs)

    def build(self, device="cuda") -> TexturePool:
        """The pool on device (a constant row when no texture was added,
        as in the reference)."""
        device = dev_mod.resolve(device)
        if not self.rows:
            self._add_row(TEX_CONSTANT, value_a=(0.5, 0.5, 0.5))
        mips = np.stack(self.mip_rows)

        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                   device=device)
        return TexturePool(
            desc=t(np.stack(self.rows)), atlas=t(np.concatenate(self.atlas)),
            mips=t(mips),
            has_image=any(int(r[0]) == TEX_IMAGE for r in self.rows),
            has_mips=bool((mips[:, 0] > 1).any()))


# ---------------------------------------------------------------------------
# Evaluation

def _bilinear_at(pool: TexturePool, base, w_img, h_img, u, v):
    """Bilinear four-texel fetch at one level (base offset and size per
    lane), the uv wrapping (repeat)."""
    uu = (u - torch.floor(u)) * w_img - 0.5
    vv = (v - torch.floor(v)) * h_img - 0.5
    x0 = torch.floor(uu)
    y0 = torch.floor(vv)
    fx = (uu - x0)[..., None]
    fy = (vv - y0)[..., None]

    def wrap(x, n):
        return torch.remainder(x, torch.clamp(n, min=1.0))

    xs = torch.stack([wrap(x0, w_img), wrap(x0 + 1, w_img)], -1)
    ys = torch.stack([wrap(y0, h_img), wrap(y0 + 1, h_img)], -1)
    idx = (base[..., None, None] + ys[..., :, None] * w_img[..., None, None]
           + xs[..., None, :])
    texels = pool.atlas[idx.round().to(torch.int64)]
    c00, c01 = texels[..., 0, 0, :], texels[..., 0, 1, :]
    c10, c11 = texels[..., 1, 0, :], texels[..., 1, 1, :]
    return (c00 * (1 - fx) * (1 - fy) + c01 * fx * (1 - fy) +
            c10 * (1 - fx) * fy + c11 * fx * fy)


def _image_bilinear(pool: TexturePool, row, u, v):
    """Level-0 bilinear fetch."""
    return _bilinear_at(pool, row[..., 1], torch.clamp(row[..., 2], min=1.0),
                        torch.clamp(row[..., 3], min=1.0), u, v)


def _mip_level_geom(row, mip_row, level):
    """(base offset, width, height) of the integer MIP level per lane."""
    n_lv = torch.clamp(mip_row[..., 0], min=1.0)
    level = torch.minimum(torch.clamp(level, min=0.0), n_lv - 1.0)
    lv_i = level[..., None] == torch.arange(15, dtype=torch.float32,
                                            device=level.device)
    base = torch.sum(mip_row[..., 1:16] * lv_i, dim=-1)
    scale = torch.exp2(-level)
    w = torch.clamp(torch.floor(torch.clamp(row[..., 2], min=1.0) * scale),
                    min=1.0)
    h = torch.clamp(torch.floor(torch.clamp(row[..., 3], min=1.0) * scale),
                    min=1.0)
    return base, w, h


def _image_trilinear(pool: TexturePool, row, mip_row, u, v, lod):
    """Trilinear MIP filtering (reference _image_trilinear): bilinear
    fetches at the two levels around lod (log2 of the footprint in level-0
    texels), lerped."""
    n_lv = torch.clamp(mip_row[..., 0], min=1.0)
    lod = torch.minimum(torch.clamp(lod, min=0.0), n_lv - 1.0)
    l0 = torch.floor(lod)
    f = (lod - l0)[..., None]
    v0 = _bilinear_at(pool, *_mip_level_geom(row, mip_row, l0), u, v)
    v1 = _bilinear_at(pool, *_mip_level_geom(row, mip_row, l0 + 1.0), u, v)
    return v0 * (1.0 - f) + v1 * f


@spans.span("texture.eval")
def eval_texture(pool: TexturePool, tex_idx, uv, footprint=None):
    """Texture tex_idx (N,) at uv (N, 2) (reference eval_texture, its
    constant and image branches). footprint (N,): the uv-space width of
    the ray cone, which picks the MIP level; None filters at level 0.
    Returns (coeffs (N, 3), scale (N,))."""
    row = pool.desc[torch.clamp(tex_idx.to(torch.int64), min=0)]
    tag = row[..., 0].round().to(torch.int32)
    u = uv[..., 0] * row[..., 10] + row[..., 12]
    v = uv[..., 1] * row[..., 11] + row[..., 13]
    c_const, s_const = row[..., 4:7], row[..., 7]
    if not pool.has_image:
        return c_const, s_const
    # image textures flip t (pbrt-v4 ImageTexture)
    v_img = 1.0 - v
    if footprint is not None and pool.has_mips:
        mip_row = pool.mips[torch.clamp(tex_idx.to(torch.int64), min=0)]
        res = torch.maximum(row[..., 2], row[..., 3])
        lod = torch.log2(torch.clamp(footprint * res, min=1.0))
        blend = _image_trilinear(pool, row, mip_row, u, v_img, lod)
    else:
        blend = _image_bilinear(pool, row, u, v_img)
    is_img = tag == TEX_IMAGE
    return (torch.where(is_img[..., None], blend[..., 0:3], c_const),
            torch.where(is_img, blend[..., 3], s_const))
