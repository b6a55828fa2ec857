"""100 x (1 - the card's busy time in the traced image / the median wall
time of the window's untraced images). The busy time is the union of the
card's activity intervals in the profiler's trace; the wall time is taken
from the images the profiler did not slow (under it the host's launches
take about twice as long)."""
import statistics


def read(ctx):
    t, clean = ctx.trace, ctx.window.image_s[:-1]
    if t is None or not clean:
        return None
    return 100.0 * (1.0 - t.busy_s / statistics.median(clean))
