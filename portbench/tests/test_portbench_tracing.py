"""The trace reduction and the roofline arithmetic on synthetic traces and
counts."""
import types

import pytest

from portbench import roofline, tracing
from portbench.metrics import (device_idle_pct, launches_per_wave,
                               megawave_roofline_pct)
from portbench.roofline import bvh8, megawave


def ev(name, start, end, device=True):
    return tracing.Event(name=name, device=device, start_us=start,
                         end_us=end)


def synthetic():
    """A 100 us window: kernels that overlap (10-30, 20-40), a copy (60-70)
    and one that runs past the window's end (90-120); host ops."""
    return [ev(tracing.SPAN, 0, 100, device=False),
            ev("aten::mul", 5, 12, device=False),
            ev("cudaLaunchKernel", 8, 9, device=False),
            ev("aten::index", 41, 59, device=False),
            ev("aten::add", 75, 80, device=False),
            ev("megawave_kernel(float const*)", 10, 30),
            ev("void at::native::elementwise_kernel<128, 2>", 20, 40),
            ev("Memcpy HtoD (Pageable -> Device)", 60, 70),
            ev("megawave_kernel(float const*)", 90, 120),
            ev("megawave_kernel(float const*)", 150, 160)]


def test_union_and_gaps():
    assert tracing.merged([(5, 7), (1, 3), (2, 4)]) == [(1, 4), (5, 7)]
    assert tracing.gaps([(1, 4), (5, 7)], 0, 10) == [(0, 1), (4, 5),
                                                       (7, 10)]
    s = tracing.summarize(synthetic())
    assert s.window_s == pytest.approx(100e-6)
    # 10-40, 60-70, 90-100 inside the window: overlaps count once
    assert s.busy_s == pytest.approx(50e-6)
    assert s.launches == 3                     # the copy is not a launch
    assert dict(s.device_ops)["megawave_kernel(float const*)"] == \
        pytest.approx(50e-6)
    # idle 0-10 (aten::mul running), 40-60 (aten::index running), 70-90
    # (nothing running: the next op, aten::add)
    gaps = dict(s.idle_gaps)
    assert gaps == pytest.approx({"aten::mul": 10e-6, "aten::index": 20e-6,
                                  "aten::add": 20e-6})


def test_idle_and_launch_readers():
    s = tracing.summarize(synthetic())
    # the untraced images took 200, 400 and 100 us, the traced one 100
    window = types.SimpleNamespace(image_s=[200e-6, 400e-6, 100e-6, 100e-6])
    ctx = types.SimpleNamespace(trace=s, waves_traced=3, window=window)
    assert device_idle_pct.read(ctx) == pytest.approx(75.0)
    assert launches_per_wave.read(ctx) == pytest.approx(1.0)
    none = types.SimpleNamespace(trace=None, waves_traced=None,
                                 rooflines={}, window=window)
    assert device_idle_pct.read(none) is None
    assert launches_per_wave.read(none) is None
    assert megawave_roofline_pct.read(none) is None


def test_summarize_needs_one_window():
    with pytest.raises(ValueError):
        tracing.summarize([ev("x", 0, 1)])


def test_least_seconds():
    assert roofline.least_seconds(3.35e12, 0) == pytest.approx(1.0)
    assert roofline.least_seconds(0, 67e12) == pytest.approx(1.0)
    assert roofline.least_seconds(0, 0, 33.5e12) == pytest.approx(1.0)
    assert roofline.least_seconds(3.35e12, 134e12) == pytest.approx(2.0)


def test_megawave_count():
    work = dict(live_lane_depths=10, shadow_tests=4, hits=3, emissions=1,
                shadow_rays=2, unoccluded=1, bsdf_samples=2,
                live_by_depth=[5, 3, 2], rr_draws=1)
    ops = (10 * 32 * 60 + 4 * 60 + 3 * 276 + 48 + 2 * 49 + 25 + 2 * 52
           + 5 * 53 + 17 + 2 * 178)
    got = megawave.wave_least_seconds(2, True, 100, 62 * 3, 32, work)
    n_bytes = 2 * 56 + 4 * 100 + 4 * 186
    assert got == pytest.approx(max(n_bytes / 3.35e12, ops / 67e12,
                                    (3 * 75 + 2 * 48 + 27 + 2 * 76)
                                    / 33.5e12))


def test_bvh8_count_and_share():
    work = dict(node_visits=1000, tri_tests=500)
    got = bvh8.query_least_seconds(160000, 10 ** 6, work)
    assert got == pytest.approx(max((160000 * 44 + 4e6) / 3.35e12,
                                    (1000 * 304 + 500 * 60) / 67e12))
    trace = types.SimpleNamespace(kernel_durations=[
        ("bvh8_kernel(float const*, int const*)", 2 * got),
        ("void bvh8_kernel_other", 1.0), ("megawave_kernel", 1.0)])
    ctx = types.SimpleNamespace(trace=trace, rooflines={
        "bvh8": roofline.Tally(launches=1, least_s=got)})
    assert roofline.share_pct(ctx, "bvh8") == pytest.approx(50.0)
    assert roofline.share_pct(ctx, "megawave") is None


def test_counting_patches_and_restores():
    from portbench.refport.ops import bvh8 as ref_bvh8
    fn = ref_bvh8.bvh8_intersect_plain
    with bvh8.counting() as tally:
        assert ref_bvh8.bvh8_intersect_plain is not fn
    assert ref_bvh8.bvh8_intersect_plain is fn and tally.launches == 0
