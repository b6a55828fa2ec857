"""Curve shapes: cubic Bezier hair and fur (counterpart of
pbrt_tpu/ops/curves.py).

The reference's design, kept: at scene build each curve is split once into
2^depth linear sub-segments (`split_curve`), each a row of SEG_COLS
float32 columns [pa(3), pb(3), wa, wb, ua, ub, ribbon normal(3), type,
curve id, 0]; the sub-segments become the leaf primitives of their own
binary BVH (ops/bvh.py node rows, the segment rows in leaf order). A query
walks that BVH and tests each leaf segment with the width-aware 2-D test
in the ray's frame (`segment_test`, the reference's RecursiveIntersect base
case): the closest approach of the ray to the segment's chord, inside half
the lerped width; t at the axis depth, pulled toward the viewer by the
tube profile for a cylinder.

Traversal semantics of the plain version (`curves_intersect_plain`), one
ray at a time with a 64-entry stack; the kernel (csrc/curves.cu) walks a
table with both children's boxes in the parent (`wide_nodes`) and gives
the same bits (its header note says why):
- a visit tests the node's slab (ops/bvh8._slab, the 1.0000004 slack)
  against the running t_best;
- an interior node hit pushes its far child and descends into the near
  one, near being the left child (index + 1) unless the ray's direction
  along the node axis is negative (the TPU kernel takes the sign from its
  ray block's majority: per ray only the winner of an exact t tie and the
  segment an any-hit query reports can differ);
- a leaf hit tests its segments in order; a segment is accepted when it is
  inside, t > 1e-4 and t < t_best (strict, so the earlier segment of a
  leaf wins a tie); an any-hit query ends at its first accepted segment.
The query returns t and the winning segment's leaf-order index;
`intersect_curves` then re-runs `segment_test` on the gathered winner row,
as the reference's packet_intersect_curves does, for u, v, the normal, the
axis and the curve id.

`curves_intersect` is the wrapper: CPU tensors run the plain version; CUDA
tensors launch the kernel, or raise. The kernel's table is derived from
the node rows by `wide_nodes`; a scene keeps it beside them
(`Scene.curve_wide`) and passes it as `wide=`.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import spans
from . import LaunchCounter
from .bvh2 import STACK, _prepare
from .bvh8 import _slab
from ..utils import vecmath as vm

CURVE_FLAT = 0
CURVE_CYLINDER = 1
CURVE_RIBBON = 2
SEG_COLS = 16
MAX_LEAF = 4
T_MIN = 1e-4
# every curve is split into 2^SUBDIV sub-segments (the reference's default,
# the only depth its parser uses)
SUBDIV = 3
# a binary tree of depth D needs at most D - 1 entries of the 64-entry
# stack (STACK) in this walk
MAX_DEPTH = STACK
WIDE_COLS = 16

counter = LaunchCounter("curves")


def wide_nodes(nodes):
    """The kernel's node table, derived from the reference-layout rows
    nodes (Nn, 8) on their device: one row an interior node, in the order
    of the rows they come from (depth first, the root is row 0),
    (Nw, WIDE_COLS) int32: columns 0-5 the left child's box and 6-11 the
    right child's (the bits of the float32 rows they come from), 12 and 13
    the children's refs, 14 the node's split axis, 15 zero. The left child
    of node i is node i + 1, the right one node roff. A ref >= 0 is the
    child's row in this table; a ref < 0 is a leaf, ~ref = roff << 3 |
    min(nprim, MAX_LEAF). A tree whose root is a leaf has no rows."""
    nodes = nodes.reshape(-1, 8)
    roff = torch.round(nodes[:, 6]).to(torch.int64)
    meta = torch.round(nodes[:, 7]).to(torch.int64)
    nprim, axis = meta >> 2, meta & 3
    interior = nprim == 0
    if int(roff.max()) >= 1 << 28:
        raise ValueError("curves: a leaf ref holds segment offsets below "
                         "2^28")
    order = torch.nonzero(interior).squeeze(1)
    ref = torch.where(interior, torch.cumsum(interior, 0) - 1,
                      ~(roff << 3 | torch.clamp(nprim, max=MAX_LEAF)))
    left, right = order + 1, roff[order]
    wide = torch.zeros((order.numel(), WIDE_COLS), dtype=torch.int32,
                       device=nodes.device)
    wide[:, 0:6] = nodes[left, :6].contiguous().view(torch.int32)
    wide[:, 6:12] = nodes[right, :6].contiguous().view(torch.int32)
    wide[:, 12] = ref[left].to(torch.int32)
    wide[:, 13] = ref[right].to(torch.int32)
    wide[:, 14] = axis[order].to(torch.int32)
    return wide


def bezier_eval(cp, u):
    """cp: (4, 3) control points; u: scalar or array -> points."""
    u = np.asarray(u)[..., None]
    b0 = (1 - u) ** 3
    b1 = 3 * u * (1 - u) ** 2
    b2 = 3 * u ** 2 * (1 - u)
    b3 = u ** 3
    return b0 * cp[0] + b1 * cp[1] + b2 * cp[2] + b3 * cp[3]


def split_curve(cp, width0, width1, depth, ctype=CURVE_FLAT, normal0=None,
                normal1=None, curve_id=0):
    """Split one cubic Bezier into 2^depth linear sub-segments, in the
    reference's numpy arithmetic (rows bit-equal to its). Returns (rows
    (S, SEG_COLS) float32, lo (S, 3), hi (S, 3)): each chord's box padded
    by half its larger width."""
    cp = np.asarray(cp, np.float32).reshape(4, 3)
    n = 1 << int(depth)
    us = np.linspace(0.0, 1.0, n + 1)
    pts = bezier_eval(cp, us).astype(np.float32)
    ws = (width0 + (width1 - width0) * us).astype(np.float32)
    if normal0 is None:
        normal0 = (0.0, 0.0, 1.0)
    if normal1 is None:
        normal1 = normal0
    n0 = np.asarray(normal0, np.float32)
    n1 = np.asarray(normal1, np.float32)
    rows = np.zeros((n, SEG_COLS), np.float32)
    rows[:, 0:3] = pts[:-1]
    rows[:, 3:6] = pts[1:]
    rows[:, 6] = ws[:-1]
    rows[:, 7] = ws[1:]
    rows[:, 8] = us[:-1]
    rows[:, 9] = us[1:]
    # ribbon normal at the segment midpoint, lerped and normalised
    um = 0.5 * (us[:-1] + us[1:])[:, None]
    nm = n0 * (1 - um) + n1 * um
    nm /= np.maximum(np.linalg.norm(nm, axis=-1, keepdims=True), 1e-9)
    rows[:, 10:13] = nm
    rows[:, 13] = float(ctype)
    rows[:, 14] = float(curve_id)
    pad = 0.5 * np.maximum(ws[:-1], ws[1:])[:, None]
    lo = np.minimum(pts[:-1], pts[1:]) - pad
    hi = np.maximum(pts[:-1], pts[1:]) + pad
    return rows, lo, hi


def _ray_frame(d):
    """(dn, t1, t2, |d|): the ray's unit direction and its Duff frame."""
    dlen = vm.length(d)
    dn = vm.normalize(d)
    t1, t2 = vm.coordinate_system(dn)
    return dn, t1, t2, dlen


def _segment_core(rows, o, dn, t1, t2, dlen):
    """The 2-D segment test on matched (M, SEG_COLS) rows and rays, in the
    kernel's operation order. Returns (t, inside, w, cx, cy, ex, ey,
    hit width, edge)."""
    pa = rows[:, 0:3] - o
    pb = rows[:, 3:6] - o
    ax, ay, az = vm.dot(pa, t1), vm.dot(pa, t2), vm.dot(pa, dn)
    bx, by, bz = vm.dot(pb, t1), vm.dot(pb, t2), vm.dot(pb, dn)
    ex = bx - ax
    ey = by - ay
    seg_len2 = torch.clamp(ex * ex + ey * ey, min=1e-16)
    w = torch.clamp(-(ax * ex + ay * ey) / seg_len2, 0.0, 1.0)
    cx = ax + w * ex
    cy = ay + w * ey
    dist2 = cx * cx + cy * cy
    wa, wb = rows[:, 6], rows[:, 7]
    hw = wa + (wb - wa) * w
    inside = dist2 <= 0.25 * hw * hw
    z_axis = az + w * (bz - az)
    edge = torch.sqrt(torch.clamp(0.25 * hw * hw - dist2, min=0.0))
    z_hit = torch.where(rows[:, 13] == float(CURVE_CYLINDER), z_axis - edge,
                        z_axis)
    t = z_hit / torch.clamp(dlen, min=1e-12)
    return t, inside, w, cx, cy, ex, ey, hw, edge


def segment_test(o, d, t_max, rows):
    """Width-aware linear segment test in the ray's frame (reference
    _segment_test). o, d (N, 3); t_max (N,); rows (N, SEG_COLS) gathered
    sub-segments. Returns dict(hit, t (inf off a hit), u, v, n (N, 3) the
    geometric normal)."""
    dn, t1, t2, dlen = _ray_frame(d)
    t, inside, w, cx, cy, ex, ey, hw, edge = _segment_core(rows, o, dn, t1,
                                                           t2, dlen)
    hit = inside & (t > T_MIN) & (t < t_max)
    u = rows[:, 8] + (rows[:, 9] - rows[:, 8]) * w
    # v across the width, signed by the side of the axis the ray passes
    side = torch.sign(cx * ey - cy * ex)
    v = 0.5 + side * torch.sqrt(cx * cx + cy * cy) / torch.clamp(hw, min=1e-9)
    ctype = rows[:, 13].round()
    # flat faces the ray; cylinder: the ray-space offset from the axis,
    # made perpendicular to it, tilted toward the viewer by the profile;
    # ribbon: its fixed normal
    n_face = -dn
    axis = vm.normalize(rows[:, 3:6] - rows[:, 0:3])
    off = cx[:, None] * t1 + cy[:, None] * t2
    perp = off - vm.dot(off, axis)[:, None] * axis
    n_cyl_raw = perp - edge[:, None] * dn
    n_cyl = vm.normalize(torch.where((vm.length(n_cyl_raw) > 1e-9)[:, None],
                                     n_cyl_raw, n_face))
    n = torch.where((ctype == CURVE_CYLINDER)[:, None], n_cyl,
                    torch.where((ctype == CURVE_RIBBON)[:, None],
                                rows[:, 10:13], n_face))
    return dict(hit=hit, t=torch.where(hit, t, torch.inf), u=u, v=v, n=n)


def curves_intersect_plain(nodes, segs, o, d, t_max, any_hit: bool):
    """Plain version of the curve kernel. nodes (Nn, 8) the curve BVH;
    segs (S, SEG_COLS) in leaf order; o, d (N, 3); t_max (N,). Each loop
    pass runs one iteration of the kernel's loop on every lane that has not
    finished: visit the current node, then pop unless it descended.
    Returns (t (N,) = inf on a miss, seg (N,) int32 leaf-order index = -1
    on a miss) and records node visits and segment tests in
    counter.work."""
    counter.plain += 1
    dev = o.device
    N = o.shape[0]
    nodes = nodes.reshape(-1, 8)
    segs = segs.reshape(-1, SEG_COLS)
    roff_all = torch.round(nodes[:, 6]).to(torch.int64)
    meta_all = torch.round(nodes[:, 7]).to(torch.int64)
    nprim_all = meta_all >> 2
    axis_all = meta_all & 3
    inv = 1.0 / torch.where(d == 0.0, 1e-20, d)
    dn, t1, t2, dlen = _ray_frame(d)
    t_best = t_max.clone()
    seg = torch.full((N,), -1, dtype=torch.int64, device=dev)
    stack = torch.zeros((N, STACK), dtype=torch.int64, device=dev)
    sp = torch.zeros((N,), dtype=torch.int64, device=dev)
    cur = torch.zeros((N,), dtype=torch.int64, device=dev)
    ar = torch.arange(MAX_LEAF, device=dev)
    work = dict(node_visits=0, seg_tests=0)
    while True:
        lanes = torch.nonzero(cur >= 0).squeeze(1)
        n = lanes.numel()
        if n == 0:
            break
        work["node_visits"] += n
        c = cur[lanes]
        nd = nodes[c]
        roff, nprim, axis = roff_all[c], nprim_all[c], axis_all[c]
        tb = t_best[lanes]
        box = _slab(nd[:, 0:3], nd[:, 3:6], o[lanes], inv[lanes], tb)
        leaf = box & (nprim > 0)
        m = torch.clamp(nprim, max=MAX_LEAF)
        cand = leaf[:, None] & (ar[None, :] < m[:, None])
        jj, kk = torch.nonzero(cand, as_tuple=True)
        if jj.numel():
            work["seg_tests"] += jj.numel()
            s = roff[jj] + kk
            lj = lanes[jj]
            t, inside = _segment_core(segs[s], o[lj], dn[lj], t1[lj], t2[lj],
                                      dlen[lj])[:2]
            ok = inside & (t > T_MIN) & (t < tb[jj])
            if not any_hit:
                # the strict-< running minimum keeps the first of the
                # smallest t: reduce t, then the test order among its ties
                t_low = torch.full((n,), torch.inf, device=dev).scatter_reduce(
                    0, jj, torch.where(ok, t, torch.inf), "amin")
                ok = ok & (t == t_low[jj])
            first_ok = torch.full((n,), MAX_LEAF, dtype=torch.int64,
                                  device=dev).scatter_reduce(
                0, jj, torch.where(ok, kk, MAX_LEAF), "amin")
            win = ok & (kk == first_ok[jj])
            t_best[lj[win]] = t[win]
            seg[lj[win]] = s[win]
        # interior: push far, descend near
        spl = sp[lanes]
        desc = box & (nprim == 0)
        neg = d[lanes].gather(1, axis[:, None])[:, 0] < 0.0
        near = torch.where(neg, roff, c + 1)
        far = torch.where(neg, c + 1, roff)
        stack[lanes[desc], spl[desc]] = far[desc]
        spl = torch.where(desc, spl + 1, spl)
        # pop; an any-hit lane with a hit is done
        pop = ~desc
        if any_hit:
            pop = pop & (seg[lanes] < 0)
        has = pop & (spl > 0)
        tok = stack[lanes, torch.clamp(spl - 1, min=0)]
        spl = torch.where(has, spl - 1, spl)
        cur[lanes] = torch.where(desc, near, torch.where(has, tok, -1))
        sp[lanes] = spl
    counter.work = work
    hit = seg >= 0
    return torch.where(hit, t_best, torch.inf), seg.to(torch.int32)


def curves_intersect(nodes, segs, o, d, t_max, any_hit: bool = False, *,
                     depth: int, wide=None):
    """Closest (or any) hit through the curve BVH. nodes (Nn, 8), segs (S,
    SEG_COLS) in leaf order, o, d (N, 3), t_max (N,) or a scalar; depth:
    the tree's depth (ops/bvh.bvh_max_depth), held to the stack; wide: the
    kernel's table (wide_nodes(nodes); derived here when not given, which a
    caller with many queries avoids by keeping it). Returns (t (N,) = inf
    on a miss, seg (N,) int32 = -1 on a miss)."""
    t_max, cuda = _prepare("curves_intersect", o, d, t_max, (nodes, segs),
                           depth, MAX_DEPTH)
    if not cuda:
        with spans.span("curves.kernel"):
            return curves_intersect_plain(nodes, segs, o, d, t_max, any_hit)
    if wide is None:
        wide = wide_nodes(nodes)
    return _launch(nodes, wide, segs, o, d, t_max, any_hit)


def _launch(nodes, wide, segs, o, d, t_max, any_hit):
    from . import _build
    lib = _build.load_library("curves")
    with torch.cuda.device(o.device):
        args, out, _keep = launch_args(nodes, wide, segs, o, d, t_max,
                                       any_hit)
        if args is None:
            return out
        with spans.span("curves.kernel"):
            err = lib.curves_intersect_launch(*args)
    _build.check(err, "curves_intersect")
    counter.launches += 1
    return out


def launch_args(nodes, wide, segs, o, d, t_max, any_hit):
    """The arguments of curves_intersect_launch on the current device's
    current stream, the outputs they write and the scratch they point to
    (the ray counter, which the launch zeroes): (args, (t, seg), keep),
    args None when there are no rays; the caller holds keep while it
    launches with args. A timing tool calls the library with them again to
    time the launch without the wrapper's host work."""
    import ctypes
    for x in (nodes, segs, o, d, t_max):
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError("curves: float32 contiguous tensors only")
    if nodes.numel() % 8 or nodes.numel() == 0 or segs.numel() % SEG_COLS:
        raise ValueError(f"curves: node rows of 8 and segment rows of "
                         f"{SEG_COLS} floats")
    if (wide.dtype != torch.int32 or not wide.is_contiguous()
            or wide.device != nodes.device or wide.numel() % WIDE_COLS):
        raise ValueError(f"curves: wide must be wide_nodes(nodes), int32 "
                         f"rows of {WIDE_COLS}")
    if nodes.data_ptr() % 16 or segs.data_ptr() % 16 or wide.data_ptr() % 16:
        raise ValueError("curves: node and segment rows must be 16-byte "
                         "aligned")
    N = o.shape[0]
    t = torch.empty((N,), dtype=torch.float32, device=o.device)
    seg = torch.empty((N,), dtype=torch.int32, device=o.device)
    if N == 0:
        return None, (t, seg), None
    next_ray = torch.empty((1,), dtype=torch.int32, device=o.device)
    stream = torch.cuda.current_stream().cuda_stream
    args = (nodes.data_ptr(), wide.data_ptr(), segs.data_ptr(), o.data_ptr(),
            d.data_ptr(), t_max.data_ptr(), t.data_ptr(), seg.data_ptr(),
            next_ray.data_ptr(), N, int(any_hit), ctypes.c_void_p(stream))
    return args, (t, seg), next_ray


def intersect_curves(nodes, segs, o, d, t_max, *, depth: int, wide=None):
    """Closest curve hit with its attributes (reference
    packet_intersect_curves): the query's t and winning segment, then one
    re-run of segment_test on the gathered winner row (bound t * 1.0001 +
    1e-5) for u, v and the normal. Returns dict(hit, t (inf on a miss), u,
    v, n, axis (the segment's unit chord), curve_id (-1 on a miss))."""
    t, seg = curves_intersect(nodes, segs, o, d, t_max, False, depth=depth,
                              wide=wide)
    hit = seg >= 0
    rows = segs.reshape(-1, SEG_COLS)[torch.clamp(seg, min=0).to(torch.int64)]
    r = segment_test(o, d, torch.where(hit, t * 1.0001 + 1e-5, 0.0), rows)
    axis = vm.normalize(rows[:, 3:6] - rows[:, 0:3])
    cid = torch.where(hit, rows[:, 14].round().to(torch.int64), -1)
    return dict(hit=hit, t=t, u=r["u"], v=r["v"], n=r["n"], axis=axis,
                curve_id=cid)
