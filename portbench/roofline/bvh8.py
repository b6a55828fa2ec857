"""The BVH8 traversal kernel (csrc/bvh8.cu): each query's node visits and
triangle tests as the plain reference counts them on the same rays (its
`counter.work`), turned into the least time by a frozen copy of
chip_smoke.py's traversal_bound: rays read once (o, d, t_max: 28 B), hits
written once (16 B), the tables read once; a node visit tests its eight
quantised children, a triangle test is Moeller-Trumbore on rows with
precomputed edges."""
from __future__ import annotations

import contextlib

from . import Tally, least_seconds, patched

KERNEL = "bvh8_kernel"

SLAB_OPS = 26           # 6 sub, 6 mul, 6 min/max, 6 for tmin/tmax, 2 test
CHILD_OPS = 12 + SLAB_OPS   # dequantise a child box, then its slab
VISIT_OPS = 8 * CHILD_OPS
TRI_OPS = 60
RAY_BYTES = 28
HIT_BYTES = 16


def query_least_seconds(n_rays, table_words, work):
    n_bytes = n_rays * (RAY_BYTES + HIT_BYTES) + 4 * table_words
    n_ops = work["node_visits"] * VISIT_OPS + work["tri_tests"] * TRI_OPS
    return least_seconds(n_bytes, n_ops)


@contextlib.contextmanager
def counting():
    """Tally the least time of every query the reference's plain BVH8
    traversal answers while the context is open."""
    from portbench.refport.ops import bvh8
    tally = Tally()

    def after(_out, b8, o, *_rest):
        if o.shape[0] == 0:
            return
        tally.launches += 1
        tally.least_s += query_least_seconds(
            o.shape[0], sum(x.numel() for x in (b8.nodes_f, b8.nodes_q,
                                                b8.tris, b8.prim_indices)),
            bvh8.counter.work)
    with patched(bvh8, "bvh8_intersect_plain", after):
        yield tally
