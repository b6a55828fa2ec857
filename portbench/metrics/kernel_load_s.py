"""Building (in a fresh checkout) or finding and loading every CUDA
library and the host BVH builder, host clock: warm, well under a second; a
broken compile cache shows here."""


def read(ctx):
    return ctx.setup.get("kernel_load_s")
