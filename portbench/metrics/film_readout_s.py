"""The film's read-out, `film.get_image` (the accumulator's copy to the
host and the colour conversion), host clock, from the program's spans:
the median over the window's untraced images."""
from portbench import program_spans


def read(ctx):
    ns = program_spans.median_span(ctx, ("film.get_image",))
    return None if ns is None else ns * 1e-9
