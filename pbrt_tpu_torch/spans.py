"""Spans and counters: where each render's time goes, stage by stage
(the counterpart of pbrt-v4's per-kernel timing table, gpu/util.cpp
ReportKernelStats, and its camera, indirect and shadow ray counts).

A span is `with spans.span("name", **attrs):` or `@spans.span("name")` on
a function. It records its name, its parent (the span open when it
began), its attributes and host start and end (time.perf_counter_ns()).
A name never nests inside itself: only the outermost call counts.

render.render() opens each image's root span, `render.image`, through
`spans.image(...)`; every span inside it carries that image's sequence
number. When the image closes, its record aggregates its spans by name
(calls, host ns, self ns: the duration less what child spans cover) and
holds the change of every counter over the image. `images()` keeps the
process's first image (the warm-up) and the newest KEEP_IMAGES; the raw
spans of the newest image are kept for `raw_spans()`. Spans outside any
image (set-up: kernel builds, parse, scene build) add up in `setup()`.

Each record stores one anchor pair (time.time_ns(), time.perf_counter_ns())
taken at its start: `trace_clock_us` turns its host stamps into the clock
of torch.profiler's events (Unix-epoch microseconds), so that an image can
be laid on a trace. Spans emit no profiler or NVTX range: those would
show on the device timeline as busy intervals.

Modes (`configure`): "host", the default, host stamps only (no device
work, no synchronize); "device" adds a timing torch.cuda.Event pair on the
current stream around every span of an image rendered on a card, read when
the image closes after render()'s final synchronize, and the device
counters (`tally`: live lanes a depth, shadow rays); "off" records no span
and no image. Host counters (`count`, the kernels' LaunchCounters) count
in every mode. One thread renders and records.
"""
from __future__ import annotations

import collections
import functools
import time

MODES = ("off", "host", "device")
# more than a benchmark window renders (cornell.1080p: ~580 images in
# 51 s on an H100), so that its per-image readers see every image
KEEP_IMAGES = 1024

# fields of an open or recorded span (a list, for speed)
_NAME, _PARENT, _START, _END, _CHILD, _ATTRS, _EV0, _EV1, _IDX = range(9)


class _Image:
    """The image being rendered: its raw spans and what it started from."""

    def __init__(self, seq, attrs, events, counts):
        self.seq = seq
        self.attrs = attrs
        self.events = events        # CUDA event pairs around its spans
        self.raw = []               # every recorded span, by start
        self.counts0 = counts       # the host counters at its start
        self.device_counts = {}     # name -> device tensor
        self.anchor = (time.time_ns(), time.perf_counter_ns())
        self.root = None


class _Recorder:
    def __init__(self):
        self.mode = "host"
        self.counts = {}            # host counters, never reset
        self.stack = []             # open spans, innermost last
        self.open_names = set()
        self.image = None
        self.outer = None           # (stack, open_names) around the image
        self.seq = 0
        self.first = None
        self.recent = collections.deque(maxlen=KEEP_IMAGES)
        self.last_raw = ()
        self.setup = {}             # name -> [calls, ns, self_ns]

    def open(self, name, attrs):
        if self.mode == "off" or name in self.open_names:
            return None
        self.open_names.add(name)
        stack, img = self.stack, self.image
        rec = [name, stack[-1][_IDX] if stack else -1, 0, 0, 0, attrs,
               None, None, -1]
        if img is not None:
            rec[_IDX] = len(img.raw)
            img.raw.append(rec)
            if img.events:
                rec[_EV0] = _event()
        stack.append(rec)
        rec[_START] = time.perf_counter_ns()
        return rec

    def close(self, rec):
        if rec is None:
            return
        end = time.perf_counter_ns()
        if rec[_EV0] is not None:
            rec[_EV1] = _event()
        rec[_END] = end
        self.stack.pop()
        self.open_names.discard(rec[_NAME])
        dur = end - rec[_START]
        if self.stack:
            self.stack[-1][_CHILD] += dur
        if self.image is None:
            tot = self.setup.setdefault(rec[_NAME], [0, 0, 0])
            tot[0] += 1
            tot[1] += dur
            tot[2] += dur - rec[_CHILD]

    def open_image(self, attrs, device):
        if self.mode == "off" or self.image is not None:
            return None
        img = _Image(self.seq, attrs, self.mode == "device"
                     and getattr(device, "type", device) == "cuda",
                     dict(self.counts))
        self.seq += 1
        self.outer = (self.stack, self.open_names)
        self.stack, self.open_names = [], set()
        self.image = img
        img.root = self.open("render.image", attrs)
        return img

    def close_image(self, img, ok: bool):
        if img is None:
            return
        self.close(img.root)
        self.image = None
        self.stack, self.open_names = self.outer
        if self.stack:
            self.stack[-1][_CHILD] += img.root[_END] - img.root[_START]
        if not ok:
            return
        record = _record(img, self.counts)
        if self.first is None:
            self.first = record
        else:
            self.recent.append(record)
        self.last_raw = (record, img.raw)


def _event():
    import torch
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _record(img: _Image, counts: dict) -> dict:
    """The image's record: its attributes, anchor, spans by name and the
    counters' change over it."""
    root = img.root
    if img.events:
        root[_EV1].synchronize()
    spans = {}
    for rec in img.raw:
        dur = rec[_END] - rec[_START]
        s = spans.get(rec[_NAME])
        if s is None:
            s = spans[rec[_NAME]] = dict(calls=0, ns=0, self_ns=0)
            if img.events:
                s["device_ns"] = 0
        s["calls"] += 1
        s["ns"] += dur
        s["self_ns"] += dur - rec[_CHILD]
        if rec[_EV0] is not None:
            s["device_ns"] += int(rec[_EV0].elapsed_time(rec[_EV1]) * 1e6)
            rec[_EV0] = rec[_EV1] = None
    c0 = img.counts0
    delta = {k: v - c0.get(k, 0) for k, v in counts.items()
             if v != c0.get(k, 0)}
    delta.update((k, int(v.item())) for k, v in img.device_counts.items())
    return dict(img.attrs, seq=img.seq, anchor=img.anchor,
                start_ns=root[_START], end_ns=root[_END], spans=spans,
                counters=delta)


_REC = _Recorder()


class span:
    """A span as a context manager, or as a decorator of a function (each
    call one span)."""
    __slots__ = ("name", "attrs", "rec")

    def __init__(self, name: str, **attrs):
        self.name = name
        self.attrs = attrs or None
        self.rec = None

    def __enter__(self):
        self.rec = _REC.open(self.name, self.attrs)
        return self

    def __exit__(self, *exc):
        _REC.close(self.rec)
        return False

    def __call__(self, fn):
        name, attrs = self.name, self.attrs

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            rec = _REC.open(name, attrs)
            try:
                return fn(*args, **kwargs)
            finally:
                _REC.close(rec)
        return spanned


class image:
    """The root span of one render() call, `render.image`, with its
    attributes (spp, width, height, lanes_per_wave, waves); device: where
    it renders (events only on a card). Its record is kept when it closes
    without an exception."""
    __slots__ = ("attrs", "device", "img")

    def __init__(self, device, **attrs):
        self.attrs = attrs
        self.device = device
        self.img = None

    def __enter__(self):
        self.img = _REC.open_image(self.attrs, self.device)
        return self

    def __exit__(self, exc_type, *exc):
        _REC.close_image(self.img, exc_type is None)
        return False


def configure(mode: str) -> None:
    """Set the mode for the images that start from now: "off", "host" or
    "device"."""
    if mode not in MODES:
        raise ValueError(f"spans mode must be one of {MODES}, not {mode!r}")
    _REC.mode = mode


def count(name: str, n: int = 1) -> None:
    """Add n to the host counter `name`."""
    _REC.counts[name] = _REC.counts.get(name, 0) + n


def counter(name: str) -> int:
    return _REC.counts.get(name, 0)


def set_counter(name: str, value: int) -> None:
    _REC.counts[name] = value


def tally(name: str, mask, index=None) -> None:
    """Device mode: add the true lanes of the bool tensor `mask` to the
    device counter name (name[index] with an index), summed on the device
    and read once when the image closes. A no-op in other modes and outside
    an image."""
    img = _REC.image
    if img is None or _REC.mode != "device":
        return
    key = name if index is None else f"{name}[{index}]"
    n = mask.sum()
    acc = img.device_counts.get(key)
    img.device_counts[key] = n if acc is None else acc + n


def images() -> list:
    """The kept image records, oldest first: the first image of the
    process (sequence number 0) and the newest KEEP_IMAGES. Each is a dict:
    seq, spp, width, height, lanes_per_wave, waves, anchor (time.time_ns(),
    time.perf_counter_ns()), start_ns and end_ns (perf_counter_ns of
    render.image), spans {name: {calls, ns, self_ns[, device_ns]}},
    counters {name: change over the image}."""
    first = [_REC.first] if _REC.first is not None else []
    return first + list(_REC.recent)


def raw_spans() -> list:
    """The newest image's spans, by start: dicts of name, parent (its index
    in this list, None for render.image), image (the sequence number),
    start_ns, end_ns (perf_counter_ns) and attrs."""
    if not _REC.last_raw:
        return []
    record, raw = _REC.last_raw
    return [dict(name=r[_NAME], parent=None if r[_PARENT] < 0 else r[_PARENT],
                 image=record["seq"], start_ns=r[_START], end_ns=r[_END],
                 attrs=dict(r[_ATTRS] or {})) for r in raw]


def trace_clock_us(record: dict, perf_ns: int) -> float:
    """A host stamp of the image `record` on torch.profiler's clock (its
    events' start_ns() over 1000: Unix-epoch microseconds)."""
    wall, perf = record["anchor"]
    return (wall + (perf_ns - perf)) * 1e-3


def setup() -> dict:
    """Spans outside any image, by name: {calls, ns, self_ns}."""
    return {k: dict(calls=c, ns=ns, self_ns=s)
            for k, (c, ns, s) in _REC.setup.items()}


def report(records=None) -> str:
    """pbrt-v4's per-stage table as text, over `records` (default: the
    kept images after the first, or the first alone): each span's calls,
    host ms, self ms and, from device mode, device ms, in total and a
    wave; then the counters' totals and the set-up spans."""
    if records is None:
        kept = images()
        records = kept[1:] if len(kept) > 1 else kept
    waves = sum(r["waves"] for r in records) or 1
    tot, counters = {}, {}
    for r in records:
        for name, s in r["spans"].items():
            t = tot.setdefault(name, [0, 0, 0, None])
            t[0] += s["calls"]
            t[1] += s["ns"]
            t[2] += s["self_ns"]
            if "device_ns" in s:
                t[3] = (t[3] or 0) + s["device_ns"]
        for k, v in r["counters"].items():
            counters[k] = counters.get(k, 0) + v
    lines = [f"{len(records)} image(s), {waves} wave(s); ms in total "
             f"and a wave"]
    head = (f"{'span':<22}{'calls':>8}{'host ms':>12}{'self ms':>12}"
            f"{'device ms':>12}{'host/wave':>11}{'self/wave':>11}"
            f"{'dev/wave':>11}")
    lines.append(head)

    def ms(ns):
        return "-" if ns is None else f"{ns * 1e-6:.3f}"

    for name, (calls, ns, self_ns, dev) in sorted(
            tot.items(), key=lambda kv: -kv[1][1]):
        lines.append(
            f"{name:<22}{calls:>8}{ms(ns):>12}{ms(self_ns):>12}{ms(dev):>12}"
            f"{ms(ns / waves):>11}{ms(self_ns / waves):>11}"
            f"{ms(None if dev is None else dev / waves):>11}")
    if counters:
        lines.append("counters: " + ", ".join(
            f"{k} {v}" for k, v in sorted(counters.items())))
    done = setup()
    if done:
        lines.append("set-up: " + ", ".join(
            f"{k} {s['ns'] * 1e-6:.3f} ms ({s['calls']})"
            for k, s in sorted(done.items(), key=lambda kv: -kv[1]["ns"])))
    return "\n".join(lines)
