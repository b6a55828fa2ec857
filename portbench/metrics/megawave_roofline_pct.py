"""The megakernel's least time (roofline/megawave.py, from the plain
reference's count of the same lanes' work) over its device time in the
traced image."""
from portbench import roofline

ROOFLINE = "megawave"


def read(ctx):
    return roofline.share_pct(ctx, ROOFLINE)
