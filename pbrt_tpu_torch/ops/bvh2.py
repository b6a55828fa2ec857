"""Binary BVH traversal, one level or two (counterpart of
pbrt_tpu/ops/pallas_bvh.py).

Tables, in the reference's layouts: node rows (Nn, 8) float32 [lo(3),
hi(3), roff, meta] from ops/bvh.py, the two ints value-encoded, meta =
nprim << 2 | axis; triangle rows (T, 10) [p0, p1, p2, id] in BVH leaf
order, column 9 the value-encoded original id; in two-level mode the
concatenated BLAS and TLAS nodes and the instance rows (I, 66) of
ops/tlas.py. The reference's dense (R, 128) triangle pack is a VMEM layout
and has no counterpart.

Traversal semantics, shared by the plain version (`_traverse`) and the
kernel (csrc/bvh2.cu), one ray at a time with a 64-entry stack:
- a visit tests the node's slab on the current-space ray (ops/bvh8._slab);
- an interior node hit pushes its far child and descends into the near
  one, near being the left child (index + 1) unless the ray's world
  direction along the node axis is negative (the TPU kernel takes that
  sign from its ray block's majority; per ray only the winner of an exact
  t tie and the prim an any-hit query reports can differ);
- a BLAS leaf hit tests its triangles in order (Moeller-Trumbore on raw
  vertices, t > 1e-5, strict t < t_best, so the earlier triangle wins a
  tie) and records the prim id of column 9 and the current instance; an
  any-hit query ends at its first accepted triangle;
- in two-level mode a node index >= tlas_root is a TLAS node; a TLAS leaf
  hit pushes ENTER = -2 - instance for its instances in order; popping
  ENTER maps the world ray into the instance's object space by its w2o
  (columns 0:12; the direction is not normalised, so t stays the world
  ray's), sets the current instance (column 25), pushes RETURN = -1 and
  jumps to the BLAS root (column 24); popping RETURN restores the world ray
  and pops again.

`bvh2_intersect` (single level) and `two_level_intersect` are the
wrappers: CPU tensors run the plain version; CUDA tensors launch the
kernel, or raise. The two-level kernel reads two tables of its own,
derived from these at scene build (`kernel_tables`): 64 B instance rows
and 48 B triangle rows, the same floats as the rows they come from.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import spans
from . import LaunchCounter
from .bvh8 import _slab

STACK = 64
MAX_LEAF = 4
T_MIN = 1e-5
RETURN_TOKEN = -1
INST_COLS = 66
# stack bounds of the reference's packet kernels (scene_core.py:813, :903):
# the depth of a binary tree, and for two levels the TLAS depth + the
# deepest BLAS + 2 (ENTER tokens and RETURN), under the 64-entry stack
MAX_DEPTH = 60
MAX_DEPTH_TWO_LEVEL = 56

counter_bvh2 = LaunchCounter("bvh2")
counter_two_level = LaunchCounter("two_level")
INST_QUADS = 16      # floats of the kernel's instance row
TRI_ROW = 12         # floats of the kernel's triangle row


@dataclasses.dataclass
class TwoLevelTables:
    """The two-level kernel's own tables, derived from inst_rows and the
    raw triangle rows (`kernel_tables`): insts (I, 16) float32, a row an
    instance [w2o (12), then as int32 bits its BLAS root's node row (column
    24) and its instance id (column 25), 0, 0]; rows (T, 12) float32, a row
    a triangle [p0, p1 - p0, p2 - p0, id, 0, 0] (the edges rounded once, as
    the test rounds them)."""
    insts: torch.Tensor
    rows: torch.Tensor


def kernel_tables(inst_rows, tris):
    """The two-level kernel's tables for inst_rows (I, 66) and tris (T, 10),
    on their device."""
    inst_rows = inst_rows.reshape(-1, INST_COLS)
    tris = tris.reshape(-1, 10)
    # assembled as int32, so that every float keeps its bits
    insts = torch.zeros((inst_rows.shape[0], INST_QUADS), dtype=torch.int32,
                        device=tris.device)
    insts[:, :12] = inst_rows[:, :12].contiguous().view(torch.int32)
    insts[:, 12:14] = torch.round(inst_rows[:, 24:26]).to(torch.int32)
    rows = torch.zeros((tris.shape[0], TRI_ROW), dtype=torch.float32,
                       device=tris.device)
    rows[:, 0:3] = tris[:, 0:3]
    rows[:, 3:6] = tris[:, 3:6] - tris[:, 0:3]
    rows[:, 6:9] = tris[:, 6:9] - tris[:, 0:3]
    rows[:, 9] = tris[:, 9]
    return TwoLevelTables(insts=insts.view(torch.float32), rows=rows)


def _tri_test(r, o, d):
    """Moeller-Trumbore on matched (M, 10) raw vertex rows and (M, 3) rays,
    in the kernel's operation order. Returns (t, b1, b2, valid without the
    t_best bound)."""
    p0x, p0y, p0z = r[:, 0], r[:, 1], r[:, 2]
    e1x, e1y, e1z = r[:, 3] - p0x, r[:, 4] - p0y, r[:, 5] - p0z
    e2x, e2y, e2z = r[:, 6] - p0x, r[:, 7] - p0y, r[:, 8] - p0z
    d_x, d_y, d_z = d[:, 0], d[:, 1], d[:, 2]
    pvx = d_y * e2z - d_z * e2y
    pvy = d_z * e2x - d_x * e2z
    pvz = d_x * e2y - d_y * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    s = torch.where(det < 0.0, -1.0, 1.0)
    det_a = det * s
    tx, ty, tz = o[:, 0] - p0x, o[:, 1] - p0y, o[:, 2] - p0z
    u_n = (tx * pvx + ty * pvy + tz * pvz) * s
    qvx = ty * e1z - tz * e1y
    qvy = tz * e1x - tx * e1z
    qvz = tx * e1y - ty * e1x
    v_n = (d_x * qvx + d_y * qvy + d_z * qvz) * s
    t_n = (e2x * qvx + e2y * qvy + e2z * qvz) * s
    inv_det = 1.0 / torch.where(det_a == 0.0, 1.0, det_a)
    t = t_n * inv_det
    valid = ((det_a > 1e-12) & (u_n >= 0.0) & (v_n >= 0.0)
             & (u_n + v_n <= det_a) & (t > T_MIN))
    return t, u_n * inv_det, v_n * inv_det, valid


def _inv_dir(d):
    return 1.0 / torch.where(d == 0.0, 1e-20, d)


def transform_rows(a, x, points: bool):
    """x (M, 3) through the 3x4 row-major transforms a (M, >= 12), each
    output as a0 x + a1 y + a2 z (+ a3 for points), in the kernel's
    order: the instance transform of an ENTER, and of a hit back to
    world (scene_core.intersect)."""
    out = []
    for r in range(3):
        v = (a[:, 4 * r] * x[:, 0] + a[:, 4 * r + 1] * x[:, 1]
             + a[:, 4 * r + 2] * x[:, 2])
        out.append(v + a[:, 4 * r + 3] if points else v)
    return torch.stack(out, dim=1)


def _traverse(counter, nodes, tris, o, d, t_max, any_hit, insts=None,
              tlas_root=None):
    """Plain PyTorch traversal, one or two levels (two when insts is
    given). Each loop pass runs one iteration of the kernel's loop on every
    lane that has not finished: visit the current node, then pop unless it
    descended. Returns (t, prim int32, b1, b2, inst int32) and records what
    the run visited in counter.work (node visits, triangle tests, instance
    entries)."""
    counter.plain += 1
    dev = o.device
    N = o.shape[0]
    two = insts is not None
    nodes = nodes.reshape(-1, 8)
    tris = tris.reshape(-1, 10)
    roff_all = torch.round(nodes[:, 6]).to(torch.int64)
    meta_all = torch.round(nodes[:, 7]).to(torch.int64)
    nprim_all = meta_all >> 2
    axis_all = meta_all & 3
    inv_w = _inv_dir(d)
    co, cd, inv = o.clone(), d.clone(), inv_w.clone()
    t_best = t_max.clone()
    prim = torch.full((N,), -1, dtype=torch.int64, device=dev)
    inst = torch.full_like(prim, -1)
    cur_inst = torch.full_like(prim, -1)
    b1 = torch.zeros((N,), dtype=torch.float32, device=dev)
    b2 = torch.zeros_like(b1)
    stack = torch.zeros((N, STACK), dtype=torch.int32, device=dev)
    sp = torch.zeros((N,), dtype=torch.int64, device=dev)
    cur = torch.full((N,), tlas_root if two else 0, dtype=torch.int64,
                     device=dev)
    ar = torch.arange(MAX_LEAF, device=dev)
    work = dict(node_visits=0, tri_tests=0, instance_entries=0)
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
        box = _slab(nd[:, 0:3], nd[:, 3:6], co[lanes], inv[lanes], tb)
        leaf = box & (nprim > 0)
        in_tlas = c >= tlas_root if two else torch.zeros_like(box)
        spl = sp[lanes]
        m = torch.clamp(nprim, max=MAX_LEAF)
        # BLAS leaves: triangle tests in the current space
        cand = (leaf & ~in_tlas)[:, None] & (ar[None, :] < m[:, None])
        jj, kk = torch.nonzero(cand, as_tuple=True)
        if jj.numel():
            work["tri_tests"] += jj.numel()
            s = roff[jj] + kk
            rows = tris[s]
            lj = lanes[jj]
            t, u, v, valid = _tri_test(rows, co[lj], cd[lj])
            ok = valid & (t < tb[jj])
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
            w_lanes = lj[win]
            t_best[w_lanes] = t[win]
            prim[w_lanes] = torch.round(rows[win, 9]).to(torch.int64)
            inst[w_lanes] = cur_inst[w_lanes]
            b1[w_lanes] = u[win]
            b2[w_lanes] = v[win]
        # TLAS leaves: push ENTER tokens
        if two:
            push = (leaf & in_tlas)[:, None] & (ar[None, :] < m[:, None])
            pj, pk = torch.nonzero(push, as_tuple=True)
            stack[lanes[pj], spl[pj] + pk] = (-2 - (roff[pj] + pk)).to(
                torch.int32)
            spl = spl + push.sum(dim=1)
        # interior: push far, descend near
        desc = box & (nprim == 0)
        neg = d[lanes].gather(1, axis[:, None])[:, 0] < 0.0
        near = torch.where(neg, roff, c + 1)
        far = torch.where(neg, c + 1, roff)
        stack[lanes[desc], spl[desc]] = far[desc].to(torch.int32)
        spl = torch.where(desc, spl + 1, spl)
        new_cur = torch.where(desc, near, -1)
        # pop, with the two-level tokens; an any-hit lane with a hit is done
        pop = ~desc
        if any_hit:
            pop = pop & (prim[lanes] < 0)
        has = pop & (spl > 0)
        tok = stack[lanes, torch.clamp(spl - 1, min=0)].to(torch.int64)
        spl = torch.where(has, spl - 1, spl)
        valid_tok = has
        if two:
            ret = has & (tok == RETURN_TOKEN)
            rl = lanes[ret]
            co[rl], cd[rl], inv[rl] = o[rl], d[rl], inv_w[rl]
            cur_inst[rl] = -1
            has2 = ret & (spl > 0)
            tok = torch.where(
                has2, stack[lanes, torch.clamp(spl - 1, min=0)].to(
                    torch.int64), tok)
            spl = torch.where(has2, spl - 1, spl)
            valid_tok = torch.where(ret, has2, has)
            enter = valid_tok & (tok <= -2)
            if bool(enter.any()):
                el = lanes[enter]
                work["instance_entries"] += el.numel()
                a = insts[-2 - tok[enter]]
                co[el] = transform_rows(a, o[el], points=True)
                cd[el] = transform_rows(a, d[el], points=False)
                inv[el] = _inv_dir(cd[el])
                cur_inst[el] = torch.round(a[:, 25]).to(torch.int64)
                stack[el, spl[enter]] = RETURN_TOKEN
                spl = torch.where(enter, spl + 1, spl)
                new_cur[enter] = torch.round(a[:, 24]).to(torch.int64)
        node = valid_tok & (tok >= 0)
        new_cur = torch.where(node, tok, new_cur)
        cur[lanes] = new_cur
        sp[lanes] = spl
    counter.work = work
    hit = prim >= 0
    return (torch.where(hit, t_best, torch.inf), prim.to(torch.int32), b1,
            b2, inst.to(torch.int32))


def bvh2_intersect_plain(nodes, tris, o, d, t_max, any_hit: bool):
    """Plain version of the single-level kernel. nodes (Nn, 8), tris (T,
    10), o, d (N, 3), t_max (N,). Returns (t (N,) = inf on a miss, prim (N,)
    int32 original id = -1 on a miss, b1, b2 (N,) = 0 on a miss)."""
    t, prim, b1, b2, _inst = _traverse(counter_bvh2, nodes, tris, o, d,
                                       t_max, any_hit)
    return t, prim, b1, b2


def two_level_plain(nodes_all, inst_rows, tris, tlas_root: int, o, d,
                    t_max, any_hit: bool):
    """Plain version of the two-level kernel. nodes_all (Nn, 8) BLAS nodes
    then the TLAS from tlas_root on; inst_rows (I, 66); tris (T, 10) the
    concatenated BLAS-ordered rows. Returns (t, prim, b1, b2, inst (N,)
    int32 = -1 on a miss)."""
    return _traverse(counter_two_level, nodes_all, tris, o, d, t_max,
                     any_hit, insts=inst_rows.reshape(-1, INST_COLS),
                     tlas_root=int(tlas_root))


def _prepare(what, o, d, t_max, tables, depth, max_depth):
    N = o.shape[0]
    if not (o.shape == d.shape == (N, 3)):
        raise ValueError(f"{what}: o, d must be (N, 3)")
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=o.device)
    t_max = t_max.expand(N).contiguous() if t_max.dim() == 0 else t_max
    if t_max.shape != (N,):
        raise ValueError(f"{what}: t_max must be (N,) or a scalar")
    if depth > max_depth:
        raise ValueError(f"{what}: tree depth {depth} overflows the "
                         f"{STACK}-entry traversal stack (at most "
                         f"{max_depth})")
    devices = {x.device.type for x in (*tables, o, d, t_max)}
    if len(devices) != 1:
        raise ValueError(f"{what}: tensors on mixed devices {devices}")
    return t_max, devices.pop() == "cuda"


def _result(t, prim, b1, b2, inst=None):
    out = dict(hit=prim >= 0, t=t, prim=prim, b0=1.0 - b1 - b2, b1=b1,
               b2=b2)
    if inst is not None:
        out["inst"] = inst
    return out


def bvh2_intersect(nodes, tris, o, d, t_max, any_hit: bool = False, *,
                   depth: int):
    """Closest (or any) hit through a single-level binary BVH. t_max (N,)
    or a scalar; depth: the tree's depth (ops/bvh.bvh_max_depth), held to
    the stack. Returns dict(hit, t, prim (original id), b0, b1, b2)."""
    t_max, cuda = _prepare("bvh2_intersect", o, d, t_max, (nodes, tris),
                           depth, MAX_DEPTH)
    if not cuda:
        with spans.span("bvh2.kernel"):
            return _result(*bvh2_intersect_plain(nodes, tris, o, d, t_max,
                                                 any_hit))
    return _result(*_launch(nodes, tris, o, d, t_max, any_hit))


def two_level_intersect(nodes_all, inst_rows, tris, tlas_root: int, o, d,
                        t_max, any_hit: bool = False, *, depth: int,
                        kernel=None):
    """Closest (or any) hit through the TLAS over instances and their
    BLASes (static instances). depth: the stack need of the tables
    (ops/tlas.stack_depth); kernel: the kernel's tables derived from
    inst_rows and tris once (kernel_tables; Scene.tlas_kernel), required
    for tensors on the card. Returns dict(hit, t, prim (global original
    id), b0, b1, b2, inst (instance row, -1 on a miss))."""
    t_max, cuda = _prepare("two_level_intersect", o, d, t_max,
                           (nodes_all, inst_rows, tris), depth,
                           MAX_DEPTH_TWO_LEVEL)
    if not cuda:
        with spans.span("two_level.kernel"):
            return _result(*two_level_plain(nodes_all, inst_rows, tris,
                                            tlas_root, o, d, t_max, any_hit))
    if kernel is None:
        raise ValueError("two_level_intersect: on the card pass kernel=, the "
                         "tables of kernel_tables(inst_rows, tris) "
                         "(Scene.tlas_kernel)")
    if (kernel.insts.shape[0] * INST_COLS != inst_rows.numel()
            or kernel.rows.shape[0] * 10 != tris.numel()):
        raise ValueError("two_level_intersect: kernel's tables are not "
                         "those of inst_rows and tris")
    return _result(*_launch_two_level(nodes_all, kernel, int(tlas_root), o,
                                      d, t_max, any_hit))


def _outputs(N, device, n_out):
    t = torch.empty((N,), dtype=torch.float32, device=device)
    prim = torch.empty((N,), dtype=torch.int32, device=device)
    out = (t, prim, torch.empty_like(t), torch.empty_like(t))
    return out + ((torch.empty_like(prim),) if n_out == 5 else ())


def _launch(nodes, tris, o, d, t_max, any_hit, out=None):
    """The single-level kernel. out: (t, prim, b1, b2) to write into (a
    timing loop's); allocated here when None."""
    from . import _build
    lib = _build.load_library("bvh2")
    with torch.cuda.device(o.device):
        args, out = launch_args_single(nodes, tris, o, d, t_max, any_hit,
                                       out=out)
        if args is None:
            return out
        with spans.span("bvh2.kernel"):
            err = lib.bvh2_intersect_launch(*args)
    _build.check(err, "bvh2_intersect")
    counter_bvh2.launches += 1
    return out


def launch_args_single(nodes, tris, o, d, t_max, any_hit, out=None):
    """The arguments of bvh2_intersect_launch on the current device's
    current stream and the outputs they write: (args, (t, prim, b1, b2)),
    args None when there are no rays (as launch_args, for the single-level
    entry)."""
    import ctypes
    for x in (nodes, tris, o, d, t_max):
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError("bvh2: float32 contiguous tensors only")
    if nodes.numel() % 8 or tris.numel() % 10:
        raise ValueError("bvh2: node rows of 8 and triangle rows of 10 "
                         "floats")
    if nodes.data_ptr() % 16:
        raise ValueError("bvh2: node rows must be 16-byte aligned")
    N = o.shape[0]
    if out is None:
        out = _outputs(N, o.device, 4)
    if N == 0:
        return None, out
    stream = torch.cuda.current_stream().cuda_stream
    return (nodes.data_ptr(), tris.data_ptr(), o.data_ptr(), d.data_ptr(),
            t_max.data_ptr(), *(x.data_ptr() for x in out), N, int(any_hit),
            ctypes.c_void_p(stream)), out


def _launch_two_level(nodes, kt: TwoLevelTables, tlas_root, o, d, t_max,
                      any_hit, out=None):
    """The two-level kernel. out: (t, prim, b1, b2, inst) to write into (a
    timing loop's, allocated once); allocated here when None."""
    from . import _build
    lib = _build.load_library("bvh2")
    with torch.cuda.device(o.device):
        args, out = launch_args(nodes, kt, tlas_root, o, d, t_max, any_hit,
                                out=out)
        if args is None:
            return out
        with spans.span("two_level.kernel"):
            err = lib.two_level_launch(*args)
    _build.check(err, "two_level_intersect")
    counter_two_level.launches += 1
    return out


def launch_args(nodes, kt: TwoLevelTables, tlas_root, o, d, t_max, any_hit,
                out=None):
    """The arguments of two_level_launch on the current device's current
    stream, and the outputs they write: (args, (t, prim, b1, b2, inst)),
    args None when there are no rays. A timing tool calls the library with
    them again to time the launch without the wrapper's host work."""
    import ctypes
    for x in (nodes, kt.insts, kt.rows, o, d, t_max):
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError("two_level: float32 contiguous tensors only")
    if nodes.numel() % 8 or kt.insts.numel() % INST_QUADS or \
            kt.rows.numel() % TRI_ROW:
        raise ValueError(f"two_level: node rows of 8 floats, instance rows "
                         f"of {INST_QUADS} and triangle rows of {TRI_ROW} "
                         "(kernel_tables)")
    # the kernel reads every row as 16 B vectors
    if any(x.data_ptr() % 16 for x in (nodes, kt.insts, kt.rows)):
        raise ValueError("two_level: node, instance and triangle rows must "
                         "be 16-byte aligned")
    N = o.shape[0]
    if out is None:
        out = _outputs(N, o.device, 5)
    if N == 0:
        return None, out
    stream = torch.cuda.current_stream().cuda_stream
    return (nodes.data_ptr(), kt.insts.data_ptr(), kt.rows.data_ptr(),
            o.data_ptr(), d.data_ptr(), t_max.data_ptr(),
            *(x.data_ptr() for x in out), N, int(tlas_root), int(any_hit),
            ctypes.c_void_p(stream)), out
