"""The reduction of a profiler trace of one image to what the per-layer
metrics read: the device's busy time as the union of its activity
intervals (kernels, copies and fills that overlap count once), the
launches, the device time of each kernel, and the longest idle gaps, each
named by what the host was doing when the card fell idle: the outermost
host op running then, or else the next one it started."""
from __future__ import annotations

import bisect
import dataclasses

TOP = 10
NAME_CHARS = 160
SPAN = "portbench.image"


@dataclasses.dataclass(frozen=True)
class Event:
    name: str
    device: bool          # an activity on the card, else a host op
    start_us: float
    end_us: float


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    launches: int                 # kernels (copies and fills not counted)
    kernel_durations: list        # (name, seconds) of every kernel
    device_ops: list              # the TOP kernels by device time
    idle_gaps: list               # the TOP host ops by idle time


def merged(intervals):
    """Sorted, non-overlapping union of (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def clipped(intervals, lo, hi):
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if min(b, hi) > max(a, lo)]


def gaps(union, lo, hi):
    """The stretches of [lo, hi] that the sorted union leaves free."""
    out, t = [], lo
    for a, b in union:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def _top(pairs):
    totals = {}
    for name, s in pairs:
        totals[name[:NAME_CHARS]] = totals.get(name[:NAME_CHARS], 0.0) + s
    return sorted(([k, v] for k, v in totals.items()),
                  key=lambda kv: -kv[1])[:TOP]


def outermost(host_events):
    """The host ops that no other op encloses, by start."""
    out, end = [], float("-inf")
    for e in sorted(host_events, key=lambda e: (e.start_us, -e.end_us)):
        if e.start_us >= end:
            out.append(e)
            end = e.end_us
    return out


def summarize(events, span=SPAN) -> TraceSummary:
    """Reduce the events of a trace whose window is the host span `span`
    (its one host event)."""
    windows = [e for e in events if not e.device and e.name == span]
    if len(windows) != 1:
        raise ValueError(f"trace: {len(windows)} spans named {span!r}")
    lo, hi = windows[0].start_us, windows[0].end_us
    # the span's own copy on the device's timeline is no device activity
    dev = [e for e in events if e.device and e.name != span
           and min(e.end_us, hi) > max(e.start_us, lo)]
    union = merged(clipped([(e.start_us, e.end_us) for e in dev], lo, hi))
    busy_us = sum(b - a for a, b in union)
    kernels = [(e.name, (e.end_us - e.start_us) * 1e-6) for e in dev
               if not is_copy(e.name)]
    host = outermost(e for e in events if not e.device and e.name != span
                     and lo <= e.start_us < hi)
    starts = [e.start_us for e in host]
    named_gaps = []
    for a, b in gaps(union, lo, hi):
        i = bisect.bisect_right(starts, a) - 1
        if i < 0 or host[i].end_us <= a:
            i += 1          # none running: the next one started
        who = host[i].name if i < len(host) else "(after the last host op)"
        named_gaps.append((who, (b - a) * 1e-6))
    return TraceSummary(window_s=(hi - lo) * 1e-6, busy_s=busy_us * 1e-6,
                        launches=len(kernels), kernel_durations=kernels,
                        device_ops=_top(kernels), idle_gaps=_top(named_gaps))


def events_from_profiler(prof):
    """The trace of a finished torch.profiler.profile as Events, read from
    its raw events (building the profiler's own event tree takes minutes
    at a few hundred thousand launches)."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() * 1e-3
        out.append(Event(name=e.name(),
                         device=e.device_type() == DeviceType.CUDA,
                         start_us=start,
                         end_us=start + e.duration_ns() * 1e-3))
    return out
