"""Process start to the end of the warm-up: the imports, the CUDA
context, loading (or, in a fresh checkout, building) the kernel libraries
and the host BVH builder, parse and build, one warm-up wave."""


def read(ctx):
    return ctx.setup_s
