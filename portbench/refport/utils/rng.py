"""32-bit hashing and morton codes (counterpart of pbrt_tpu/utils/rng.py).

Every function takes int64 tensors holding values in [0, 2^32) or plain
Python ints, and returns the same kind, masked to 32 bits. torch's uint32
has no shifts, adds or comparisons on the CPU, so the u32 arithmetic of the
reference is emulated here; products are split into 16-bit halves so no
intermediate leaves int64. Bit-exact with the reference.
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF


def mul32(a, b):
    """(a * b) mod 2^32 for values in [0, 2^32)."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def fmix32(h):
    """murmur3 finalizer (reference rng.fmix32)."""
    h = h ^ (h >> 16)
    h = mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def hash_u32(*words):
    """Combine uint32 words (ints or int64 tensors) into one uint32
    (reference rng.hash_u32). With only ints it is the host hash the
    megakernel bakes into its per-dimension seed table."""
    return hash_continue(0x9E3779B9, *words)


def hash_continue(h, *words):
    """hash_u32's fold from its state h on: hash_u32(a, b, c) is
    hash_continue(hash_u32(a, b), c), so a hash whose leading words stay
    fixed across calls is finished from its stored prefix."""
    for w in words:
        h = fmix32((w & MASK32) ^ ((mul32(h, 0x01000193) + 0x517CC1B7)
                                   & MASK32))
    return h


def u32_to_float01(u):
    """u32 values -> float32 in [0, 1): the top 24 bits times 2^-24
    (reference rng.u32_to_float01)."""
    return (u >> 8).to(torch.float32) * (2.0 ** -24)


def reverse_bits_32(n):
    n = ((n << 16) | (n >> 16)) & MASK32
    n = ((n & 0x00FF00FF) << 8) | ((n & 0xFF00FF00) >> 8)
    n = ((n & 0x0F0F0F0F) << 4) | ((n & 0xF0F0F0F0) >> 4)
    n = ((n & 0x33333333) << 2) | ((n & 0xCCCCCCCC) >> 2)
    return ((n & 0x55555555) << 1) | ((n & 0xAAAAAAAA) >> 1)


def left_shift_2(x):
    """Spread the low 16 bits into the even positions (reference
    rng.left_shift_2)."""
    x = x & 0xFFFF
    x = (x ^ (x << 8)) & 0x00FF00FF
    x = (x ^ (x << 4)) & 0x0F0F0F0F
    x = (x ^ (x << 2)) & 0x33333333
    return (x ^ (x << 1)) & 0x55555555


def encode_morton_2(x, y):
    return ((left_shift_2(y) << 1) | left_shift_2(x)) & MASK32


def compact_bits_2(v):
    """Gather the even bits of v (inverse of left_shift_2; reference
    megawave._compact_bits_2)."""
    v = v & 0x55555555
    v = (v | (v >> 1)) & 0x33333333
    v = (v | (v >> 2)) & 0x0F0F0F0F
    v = (v | (v >> 4)) & 0x00FF00FF
    return (v | (v >> 8)) & 0x0000FFFF
