"""Camera paths of every image the window rendered (W x H x spp each) over
the time from the window's start to the end of its last image; render()
synchronizes at both ends."""


def read(ctx):
    w = ctx.window
    return w.paths / w.seconds if w.images else None
