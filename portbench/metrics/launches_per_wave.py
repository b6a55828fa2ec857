"""Kernel launches on the card in the traced image (copies and fills not
counted) over its waves: the host-launched work a wave costs."""


def read(ctx):
    if ctx.trace is None or not ctx.waves_traced:
        return None
    return ctx.trace.launches / ctx.waves_traced
