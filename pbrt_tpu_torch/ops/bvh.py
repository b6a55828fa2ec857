"""Binary BVH, host side (counterpart of pbrt_tpu/ops/bvh.py): the native
binned-SAH build, the packed triangle rows, and the tree depth.

The flattened depth-first node rows keep the reference layout:
[lo(3), hi(3), right_child | prim_offset, n_prims << 2 | axis], the two
int columns value-encoded as float32. Traversal runs on the BVH8 collapse
(ops/bvh8.py) or, for the binary tree itself and for instanced scenes, on
ops/bvh2.py; the reference's XLA while-loop traversal is a TPU workaround
and has no counterpart here.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .. import native
from .. import spans

MAX_LEAF_PRIMS = 4


@dataclasses.dataclass(frozen=True)
class BVH:
    nodes: np.ndarray          # (M, 8) float32
    prim_indices: np.ndarray   # (P,) int32: leaf order -> original prim


@spans.span("bvh.build")
def build_bvh(prim_lo, prim_hi, max_leaf=MAX_LEAF_PRIMS) -> BVH:
    """Binned SAH build (reference aggregates.cpp, 12 buckets), native
    only: raises if the C++ builder cannot be compiled."""
    nodes, order = native.build_bvh(prim_lo, prim_hi, max_leaf)
    return BVH(nodes=nodes, prim_indices=order)


def pack_tri_geo(tri_p0, tri_p1, tri_p2, order=None) -> np.ndarray:
    """(T, 10) float32 rows [p0, p1, p2, original index] (the index
    value-encoded), permuted into `order` (BVH leaf order) if given."""
    p0 = np.asarray(tri_p0, np.float32)
    p1 = np.asarray(tri_p1, np.float32)
    p2 = np.asarray(tri_p2, np.float32)
    orig = np.arange(len(p0), dtype=np.int32)
    if order is not None:
        order = np.asarray(order)
        p0, p1, p2, orig = p0[order], p1[order], p2[order], orig[order]
    return np.concatenate([p0, p1, p2, orig[:, None].astype(np.float32)],
                          axis=1)


def bvh_max_depth(nodes, root: int = 0) -> int:
    """Largest depth of a flattened tree below `root` (root depth 1; left
    child i + 1, right child at the encoded offset; a root other than 0
    walks one tree of a concatenation, ops/tlas.py)."""
    arr = np.asarray(nodes)
    nprim = arr[:, 7].astype(np.int64) >> 2
    n = len(arr)
    best = 0
    stack = [(int(root), 1)]
    while stack:
        i, d = stack.pop()
        if i < 0 or i >= n:
            continue
        best = max(best, d)
        if nprim[i] == 0:
            stack.append((i + 1, d + 1))
            stack.append((int(round(arr[i, 6])), d + 1))
    return best
