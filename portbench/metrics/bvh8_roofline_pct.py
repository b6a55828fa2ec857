"""The BVH8 kernel's least time (roofline/bvh8.py, from the plain
reference's count of the same queries' work) over its device time in the
traced image."""
from portbench import roofline

ROOFLINE = "bvh8"


def read(ctx):
    return roofline.share_pct(ctx, ROOFLINE)
