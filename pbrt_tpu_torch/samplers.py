"""Samplers as stateless functions (counterpart of pbrt_tpu/samplers.py).

Only the ZSobol sampler in its fast index-shuffling variant, which is what
the main path and the megakernel use. Pixel coordinates, sample indices
and dimensions are int tensors (or ints); u32 math is int64 masked to 32
bits (utils/rng.py). Bit-exact with the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import spans
from .utils import rng as prng
from .utils import lowdiscrepancy as ld

SAMPLER_ZSOBOL = 2   # the reference's kind code

_INDEX_SALT = 0x9dbf6d7c   # dimension-pair hash salt of the index shuffle
_SECOND_SALT = 0x4df5      # scramble-seed salt of a 2-D sample's second axis


@dataclasses.dataclass(frozen=True)
class SamplerParams:
    kind: int = SAMPLER_ZSOBOL
    spp: int = 16
    seed: int = 0
    log2_spp: int = 4
    n_base4_digits: int = 16


def make_sampler(kind="zsobol", spp=16, seed=0,
                 full_resolution=(1024, 1024)) -> SamplerParams:
    if kind != "zsobol":
        raise NotImplementedError(
            f"sampler {kind!r}: only zsobol is ported (ROADMAP.md, slice 4: "
            "the other samplers)")
    log2_spp = max(0, int(np.ceil(np.log2(max(spp, 1)))))
    res = max(full_resolution[0], full_resolution[1])
    n_base4 = int(np.ceil(np.log2(max(res, 2)))) + (log2_spp + 1) // 2
    return SamplerParams(kind=SAMPLER_ZSOBOL, spp=1 << log2_spp, seed=seed,
                         log2_spp=log2_spp, n_base4_digits=n_base4)


def zsobol_index_bits(params: SamplerParams) -> int:
    """Meaningful bits of the morton|spp index (at most 32)."""
    return min(2 * params.n_base4_digits - (params.log2_spp & 1), 32)


def morton_index(params: SamplerParams, px, py, sample_index):
    """(morton(px, py) << log2_spp) | sample_index as int64 u32 values."""
    morton = prng.encode_morton_2(px.to(torch.int64), py.to(torch.int64))
    return ((morton << params.log2_spp)
            | sample_index.to(torch.int64)) & prng.MASK32


def _zsobol_sample_index_fast(params: SamplerParams, px, py, sample_index,
                              dim):
    """Base-2 Owen shuffle of the z-curve index (reference samplers.py
    _zsobol_sample_index_fast)."""
    B = zsobol_index_bits(params)
    seed = prng.hash_u32(dim, params.seed, _INDEX_SALT)
    v = (morton_index(params, px, py, sample_index) << (32 - B)) & prng.MASK32
    v = ld.fast_owen_scramble(v, seed)
    return v >> (32 - B)


def _dims(px, dim):
    """An int dimension stays an int, so its seed hashes run once on the
    host; a tensor is broadcast over the lanes."""
    if isinstance(dim, int):
        return dim
    return torch.as_tensor(dim, dtype=torch.int64,
                           device=px.device).expand(px.shape)


@spans.span("sampler.draw")
def sample_1d(params: SamplerParams, px, py, sample_index, dim):
    """dim: int (one dimension for every lane) or int tensor, the sampler
    dimension. Returns (N,) f32."""
    dim = _dims(px, dim)
    idx = _zsobol_sample_index_fast(params, px, py, sample_index, dim)
    h = prng.hash_u32(dim, params.seed)
    return ld.u32_to_sample(
        ld.fast_owen_scramble(ld.sobol_sample_u32(idx, 0), h))


@spans.span("sampler.draw")
def sample_2d(params: SamplerParams, px, py, sample_index, dim):
    """Consumes dims (dim, dim + 1). Returns (N, 2) f32."""
    dim = _dims(px, dim)
    idx = _zsobol_sample_index_fast(params, px, py, sample_index, dim)
    ha = prng.hash_u32(dim, params.seed)
    hb = prng.hash_u32(dim, params.seed, _SECOND_SALT)
    ua = ld.u32_to_sample(ld.fast_owen_scramble(ld.sobol_sample_u32(idx, 0),
                                                ha))
    ub = ld.u32_to_sample(ld.fast_owen_scramble(ld.sobol_sample_u32(idx, 1),
                                                hb))
    return torch.stack([ua, ub], dim=-1)


@spans.span("sampler.draw")
def sample_pixel_2d(params: SamplerParams, px, py, sample_index, dim):
    """Pixel-position sample (reference GetPixel2D): sample_2d for ZSobol."""
    return sample_2d(params, px, py, sample_index, dim)
