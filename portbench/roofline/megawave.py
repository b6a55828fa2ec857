"""The whole-path megakernel (csrc/megawave.cu): the work of a wave as the
plain reference counts it on the same lanes (its `counter.work`), turned
into the least time by a frozen copy of chip_smoke.py's megawave_bound:
bytes: lam, le, mi (and o, d) read and L (and fw) written once a lane,
the tables once; f32 operations: the closest-hit tests of live lanes, the
shadow rays' tests, the shading; INT32: the sampler's."""
from __future__ import annotations

import contextlib

from . import Tally, least_seconds, patched

KERNEL = "megawave_kernel"

TRI_OPS = 60            # Moeller-Trumbore on rows with precomputed edges
# f32 operations of one unit of the kernel's work besides the triangle
# tests (a division, square root or transcendental counts one): the camera
# section a lane; shading a hit; an emissive hit's MIS; a shadow ray's
# origin offset and length; an unoccluded ray's contribution; a BSDF
# sample; the next ray (a lane that goes on); a roulette draw
CAMERA_OPS = 178
SHADE_OPS = 276
EMIT_OPS = 48
SHADOW_RAY_OPS = 49
UNOCCLUDED_OPS = 25
BSDF_OPS = 52
NEXT_RAY_OPS = 53
RR_OPS = 17
# the sampler's integer operations: a 1D draw, a 2D draw, the pixel decode
D1_INT_OPS = 27
D2_INT_OPS = 48
CAMERA_INT_OPS = 28


def wave_least_seconds(n, camera, table_words, seed_words, n_real, work):
    """The least time of one launch over n lanes (camera: the rays are
    made in the kernel), from the plain version's count of its work."""
    n_bytes = n * (16 + 16 + 4 + 16 + (4 if camera else 24)) \
        + 4 * table_words + 4 * seed_words
    closest = work["live_lane_depths"] * n_real * TRI_OPS
    shadow = work["shadow_tests"] * TRI_OPS
    shading = (work["hits"] * SHADE_OPS
               + work["emissions"] * EMIT_OPS
               + work["shadow_rays"] * SHADOW_RAY_OPS
               + work["unoccluded"] * UNOCCLUDED_OPS
               + work["bsdf_samples"] * BSDF_OPS
               + sum(work["live_by_depth"][1:]) * NEXT_RAY_OPS
               + work["rr_draws"] * RR_OPS
               + (n * CAMERA_OPS if camera else 0))
    int_ops = (work["hits"] * (D1_INT_OPS + D2_INT_OPS)
               + work["bsdf_samples"] * D2_INT_OPS
               + work["rr_draws"] * D1_INT_OPS
               + (n * (D2_INT_OPS + CAMERA_INT_OPS) if camera else 0))
    return least_seconds(n_bytes, closest + shadow + shading, int_ops)


@contextlib.contextmanager
def counting():
    """Tally the least time of every wave the reference's plain megakernel
    version runs while the context is open."""
    from portbench.refport.ops import megawave as mw
    tally = Tally()

    def after(_out, w):
        n = w.lam.shape[0]
        if n == 0:
            return
        tally.launches += 1
        tally.least_s += wave_least_seconds(
            n, w.o is None,
            sum(x.numel() for x in (w.tri, w.attr, w.light, w.mat)),
            w.seeds.size, w.n_real, mw.counter.work)
    with patched(mw, "wave_full_plain", after):
        yield tally
