"""Two-level BVH tables for object instancing, host side (counterpart of
pbrt_tpu/ops/tlas.py).

Each prototype's triangles get a BLAS (a binary SAH tree, ops/bvh.py);
the world triangles are BLAS 0 under an identity instance. The BLAS node
arrays are concatenated with their child and prim offsets rebased, so a
node index is global; a TLAS over the instances' world bounds is appended
after them, from `tlas_root` on. Instance rows keep the reference's
INST_COLS = 66 layout so the two packages' tables compare array for array:
[w2o 3x4 row-major (12), o2w 3x4 (12), BLAS root, instance id, has_motion,
pad, o2w_end 3x4 (12), TRS payload (26)]. Traversal is ops/bvh2.py
(`two_level_intersect`), for static instances only: an animated instance
(o2w_end) raises here.
"""
from __future__ import annotations

import numpy as np

from . import bvh as bvh_mod

INST_COLS = 66   # 40 base + [q0(4), q1(4), S0(9), S1(9)] TRS payload
ANIMATED = "ROADMAP.md slice 3 item 10 (animated instances)"


def _f2i(f):
    """Node and instance int columns are value-encoded floats."""
    return np.round(np.asarray(f, np.float64)).astype(np.int64)


def _i2f(i):
    return np.asarray(i, np.float64).astype(np.float32)


def build_two_level(blas_list, instances):
    """Concatenate the BLASes and build the TLAS.

    blas_list: one (nodes (Nn, 8), prim_indices (T,), tri_lo, tri_hi) per
    prototype, nodes from ops/bvh.build_bvh over its triangles with prim
    offsets into its own BVH-ordered rows. instances: dicts(proto, w2o
    (3, 4), o2w (3, 4)).

    Returns (nodes_all (M, 8) f32, inst_rows (I, INST_COLS) f32 in TLAS
    leaf order with column 25 re-numbered to that order, prim_base (P,):
    each prototype's offset into the concatenated rows, tlas_root)."""
    node_arrays, node_base, prim_base = [], [], []
    nb = pb = 0
    for (nodes, order, _, _) in blas_list:
        nodes = np.array(nodes, np.float32)
        roff = _f2i(nodes[:, 6])
        is_leaf = (_f2i(nodes[:, 7]) >> 2) > 0
        nodes[:, 6] = _i2f(np.where(is_leaf, roff + pb, roff + nb))
        node_base.append(nb)
        prim_base.append(pb)
        node_arrays.append(nodes)
        nb += nodes.shape[0]
        pb += len(order)
    inst_rows = np.zeros((len(instances), INST_COLS), np.float32)
    ilo = np.zeros((len(instances), 3), np.float32)
    ihi = np.zeros((len(instances), 3), np.float32)
    for i, inst in enumerate(instances):
        if inst.get("o2w_end") is not None:
            raise NotImplementedError("an animated instance (o2w_end) is "
                                      f"not ported yet ({ANIMATED})")
        proto = inst["proto"]
        w2o = np.asarray(inst["w2o"], np.float32).reshape(3, 4)
        o2w = np.asarray(inst["o2w"], np.float32).reshape(3, 4)
        inst_rows[i, 0:12] = w2o.reshape(-1)
        inst_rows[i, 12:24] = o2w.reshape(-1)
        inst_rows[i, 24] = float(node_base[proto])
        inst_rows[i, 25] = float(i)
        inst_rows[i, 28:40] = o2w.reshape(-1)
        # world bounds: the prototype box's corners through o2w
        _, _, lo, hi = blas_list[proto]
        plo, phi = lo.min(axis=0), hi.max(axis=0)
        corners = np.stack(np.meshgrid(*zip(plo, phi), indexing="ij"),
                           -1).reshape(-1, 3)
        wc = corners @ o2w[:, :3].T + o2w[:, 3]
        ilo[i] = wc.min(axis=0)
        ihi[i] = wc.max(axis=0)
    tlas = bvh_mod.build_bvh(ilo, ihi)
    tnodes = np.array(tlas.nodes, np.float32)
    troff = _f2i(tnodes[:, 6])
    tleaf = (_f2i(tnodes[:, 7]) >> 2) > 0
    # a TLAS leaf's offset indexes the TLAS-ordered instance rows: bake the
    # order into the rows and re-number them so the recorded instance id
    # indexes the reordered table
    inst_rows = inst_rows[np.asarray(tlas.prim_indices)]
    inst_rows[:, 25] = np.arange(inst_rows.shape[0], dtype=np.float32)
    tnodes[:, 6] = _i2f(np.where(tleaf, troff, troff + nb))
    nodes_all = np.concatenate(node_arrays + [tnodes])
    return nodes_all, inst_rows, np.asarray(prim_base), nb


def stack_depth(nodes_all, inst_rows, tlas_root: int) -> int:
    """Traversal stack entries the tables can need: the TLAS depth, the
    deepest BLAS an instance enters, and 2 for the ENTER and RETURN tokens
    (the reference's headroom rule, scene_core.py:895-899, with the TLAS
    walked from its own root)."""
    nodes_all = np.asarray(nodes_all)
    roots = {int(r) for r in _f2i(np.asarray(inst_rows)[:, 24])}
    return (bvh_mod.bvh_max_depth(nodes_all, tlas_root)
            + max(bvh_mod.bvh_max_depth(nodes_all, r) for r in roots) + 2)
