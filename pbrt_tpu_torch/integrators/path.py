"""Path integrator (counterpart of pbrt_tpu/integrators/path.py): one wave
of camera paths through the megakernel.

Only the megakernel configuration is ported: an eligible scene, the zsobol
sampler, a pinhole perspective camera and a gaussian filter. The general
wave (the reference's trace_paths) is queued in ROADMAP.md.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import samplers as smp
from ..ops import megawave
from ..utils import spectrum as spc


@dataclasses.dataclass(frozen=True)
class PathOptions:
    max_depth: int = 5
    rr_start_depth: int = 1


def render_wave(scene, camera, sampler, filt, pixel_idx: torch.Tensor,
                sample_index: torch.Tensor, opts: PathOptions):
    """One wave over flat pixel ids (N,) and per-lane sample indices (N,).
    Returns (spectral L (N, 4), wavelengths, filter weight (N,))."""
    if not megawave.eligible_full(scene, sampler, camera, filt):
        raise NotImplementedError(
            "render_wave: only the megakernel configuration is ported "
            "(eligible scene, zsobol, pinhole camera, gaussian filter); the "
            "general wave is queued in ROADMAP.md")
    px = pixel_idx % camera.width
    py = pixel_idx // camera.width
    u_lam = smp.sample_1d(sampler, px, py, sample_index, 5)
    swl = spc.sample_visible_wavelengths(u_lam)
    L, fw = megawave.trace_full(scene, sampler, camera, filt, px, py,
                                sample_index, swl.lam,
                                max_depth=opts.max_depth,
                                rr_start=opts.rr_start_depth)
    return L, swl, fw
