"""The program's own image records (pbrt_tpu_torch.spans.images()), lined
up with the run's window, for the readers of the metrics they hold.

The window's records are the last len(ctx.window.images) records; in a
traced run the traced image, the last of them, is dropped (the profiler
slows it). The warm-up is the record with sequence number 0. A program
without those records (one older than its spans), or records that do not
line up with the window (too few, or another image size), give None."""
from __future__ import annotations

import statistics


def records():
    """The program's image records, oldest first, or None where it keeps
    none."""
    try:
        from pbrt_tpu_torch import spans
    except ImportError:
        return None
    return spans.images()


def window(ctx, recs=None):
    """The records of the window's untraced images, oldest first, or
    None."""
    recs = records() if recs is None else recs
    n = len(ctx.window.images)
    if not recs or n == 0 or len(recs) < n:
        return None
    win = recs[-n:]
    per_image = ctx.window.paths // n
    if any(r["spp"] * r["width"] * r["height"] != per_image for r in win):
        return None
    if ctx.trace is not None:
        win = win[:-1]
    return win or None


def warmup(ctx, recs=None):
    """The warm-up's record (sequence number 0), where the window's
    records line up, else None."""
    recs = records() if recs is None else recs
    if window(ctx, recs) is None:
        return None
    first = [r for r in recs if r["seq"] == 0]
    return first[0] if first else None


def median_span(ctx, names, per_wave=False, recs=None):
    """The median over the window's untraced images of the host ns of the
    spans `names`, summed (a span missing from an image counts 0), over
    each image's waves where per_wave; None where no image holds any of
    them."""
    win = window(ctx, recs)
    if win is None or not any(n in r["spans"] for r in win for n in names):
        return None
    return statistics.median(
        sum(r["spans"][n]["ns"] for n in names if n in r["spans"])
        / (r["waves"] if per_wave else 1) for r in win)
