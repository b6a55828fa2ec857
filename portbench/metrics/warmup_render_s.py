"""The set-up's warm-up render, the program's first image (its
`render.image` span, sequence number 0): the render loop's first run,
which pays for lazy CUDA module loads, allocator growth and first
launches. Host clock, from the program's spans."""
from portbench import program_spans


def read(ctx):
    r = program_spans.warmup(ctx)
    return None if r is None else (r["end_ns"] - r["start_ns"]) * 1e-9
