"""The BxDFs, `bsdf.eval` (bxdfs.bsdf_f, bsdf_pdf) and `bsdf.sample`
(bxdfs.bsdf_sample) spans, host clock a wave: the median over the
window's untraced images of each image's total over its waves."""
from portbench import program_spans


def read(ctx):
    ns = program_spans.median_span(ctx, ("bsdf.eval", "bsdf.sample"),
                                   per_wave=True)
    return None if ns is None else ns * 1e-6
