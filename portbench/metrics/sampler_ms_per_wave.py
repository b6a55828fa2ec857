"""The sampler's draws, `sampler.draw` spans (samplers.sample_1d,
sample_2d, sample_pixel_2d), host clock a wave: the median over the
window's untraced images of each image's total over its waves. Host
stamps time the launches: the stage's cost where the host sets the pace,
as on the general wave."""
from portbench import program_spans


def read(ctx):
    ns = program_spans.median_span(ctx, ("sampler.draw",), per_wave=True)
    return None if ns is None else ns * 1e-6
