"""8-wide BVH traversal (counterpart of pbrt_tpu/ops/pallas_bvh8.py).

Host build, in numpy, with the reference's layouts so the two packages'
tables can be compared array for array: the native binary SAH build
(ops/bvh.py), its native collapse into 8-wide nodes, CWBVH-style u8 child
boxes (`quantize_nodes`), and 9-float triangle rows [p0, e1, e2] in leaf
order (`pack_tris_flat`). The tables then live on a device as tensors
(`BVH8`).

Traversal semantics, shared by the plain version and the kernel
(csrc/bvh8.cu), one ray at a time with a 96-entry stack:
- the root union box (nodes_f[0:6]) is tested first;
- a visit tests the popped node's 8 child slabs against the ray's running
  t_best, with (plane - o) * inv_d, inv_d = 1 / (d == 0 ? 1e-20 : d), the
  entry t clamped below at 0, the exit t above at t_best, accepted when
  tmin <= tmax * 1.0000004; child boxes dequantise as origin + q * scale;
- leaf children are tested in slot order, each leaf's triangles in order:
  Moeller-Trumbore with tolerance 1e-6 * det, det > 1e-12, t > 1e-5, and
  t < t_best (strict: on equal t the earlier triangle wins); an any-hit
  query returns at the first accepted hit;
- interior children hit at the visit's entry are then pushed so the near
  side pops first: children are sorted along the node's axis at build
  time, so a ray whose direction along that axis is >= 0 pushes slots
  7..0 and a negative one 0..7. (The TPU kernel takes that sign from the
  majority of its ray block; per ray only the winner of an exact t tie
  and the prim an any-hit query reports can differ from it.)
- the leaf-ordered slot of the hit is remapped through prim_indices; a
  miss gives t = inf, prim = -1, b1 = b2 = 0.

`bvh8_intersect` is the wrapper: CPU tensors run `bvh8_intersect_plain`;
CUDA tensors launch the kernel, or raise. The TPU kernel's SMEM budget,
its chunking (chunked_intersect) and its block packets have no
counterpart: one kernel traverses any tree in global memory.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import device as dev_mod
from .. import native
from . import LaunchCounter
from . import bvh as bvh_mod

WIDTH = 8                 # children per node
STACK = 96
NF_F = 8                  # f32 frame floats per node
NQ_I = WIDTH * 3          # i32 words per node
CNT_EMPTY = 255
MAX_LEAF = 8
T_MIN = 1e-5

counter = LaunchCounter()


@dataclasses.dataclass
class BVH8:
    """Quantised 8-wide BVH tables on one device (reference BVH8).

    nodes_f (8 + n_nodes*8,) f32: root union box, then per node
    [origin(3), scale(3), axis, pad]; nodes_q (n_nodes*24,) i32: per child
    w0 = qlo.x | qlo.y<<8 | qlo.z<<16 | cnt<<24, w1 = qhi packed, w2 =
    first (triangle slot of a leaf, node index of an interior child);
    tris (T*9,) f32 [p0, e1, e2] in leaf order; prim_indices (T,) i32."""
    nodes_f: torch.Tensor
    nodes_q: torch.Tensor
    tris: torch.Tensor
    prim_indices: torch.Tensor
    n_nodes: int
    n_tris: int
    depth: int

    @property
    def device(self) -> torch.device:
        return self.nodes_f.device


# ---------------------------------------------------------------------------
# Host build (numpy)

def quantize_nodes(node_data: np.ndarray):
    """(n, 72) collapse output (8 floats per child [lo, hi, first, count],
    then [axis, root union lo, hi, pad]) -> (nodes_f, nodes_q). Boxes are
    rounded out so the dequantised f32 box always contains the exact child
    box."""
    nd = np.asarray(node_data, np.float64)
    n = nd.shape[0]
    ch = nd[:, :WIDTH * 8].reshape(n, WIDTH, 8)
    lo = ch[:, :, 0:3]
    hi = ch[:, :, 3:6]
    first = np.round(ch[:, :, 6]).astype(np.int64)
    cnt = np.round(ch[:, :, 7]).astype(np.int64)
    empty = cnt < 0
    valid = ~empty
    vlo = np.where(valid[:, :, None], lo, np.inf)
    vhi = np.where(valid[:, :, None], hi, -np.inf)
    origin = vlo.min(axis=1)
    extent = vhi.max(axis=1) - origin
    scale = np.maximum(extent, 1e-20) / 254.0      # headroom for round-out
    rel_lo = (lo - origin[:, None, :]) / scale[:, None, :]
    rel_hi = (hi - origin[:, None, :]) / scale[:, None, :]
    qlo = np.clip(np.floor(rel_lo), 0, 255).astype(np.int64)
    qhi = np.clip(np.ceil(rel_hi), 0, 255).astype(np.int64)
    # f32 round-out: traversal computes origin + q * scale in f32
    o32 = origin.astype(np.float32)[:, None, :]
    s32 = scale.astype(np.float32)[:, None, :]
    for _ in range(2):
        deq_lo = (o32 + qlo.astype(np.float32) * s32).astype(np.float32)
        qlo = np.where(valid[:, :, None] & (deq_lo > lo), qlo - 1, qlo)
        deq_hi = (o32 + qhi.astype(np.float32) * s32).astype(np.float32)
        qhi = np.where(valid[:, :, None] & (deq_hi < hi), qhi + 1, qhi)
    qlo = np.clip(qlo, 0, 255)
    qhi = np.clip(qhi, 0, 255)
    # empty slots: inverted box + the EMPTY count sentinel
    qlo = np.where(empty[:, :, None], 255, qlo)
    qhi = np.where(empty[:, :, None], 0, qhi)
    cnt = np.where(empty, CNT_EMPTY, cnt)
    w0 = (qlo[:, :, 0] | (qlo[:, :, 1] << 8) | (qlo[:, :, 2] << 16)
          | (cnt << 24))
    w1 = qhi[:, :, 0] | (qhi[:, :, 1] << 8) | (qhi[:, :, 2] << 16)
    nodes_q = np.stack([w0, w1, first], axis=2).astype(np.int64)
    nodes_q = nodes_q.reshape(-1).astype(np.uint32).view(np.int32)
    nodes_f = np.zeros(8 + n * NF_F, np.float32)
    nodes_f[0:3] = nd[0, WIDTH * 8 + 1:WIDTH * 8 + 4]   # root union lo
    nodes_f[3:6] = nd[0, WIDTH * 8 + 4:WIDTH * 8 + 7]   # root union hi
    frames = np.zeros((n, NF_F), np.float32)
    frames[:, 0:3] = origin.astype(np.float32)
    frames[:, 3:6] = scale.astype(np.float32)
    frames[:, 6] = nd[:, WIDTH * 8].astype(np.float32)  # axis
    nodes_f[8:] = frames.reshape(-1)
    return nodes_f, nodes_q


def collapse_to_bvh8(nodes_bin: np.ndarray, max_leaf: int = MAX_LEAF):
    """Collapse a flattened binary SAH BVH into 8-wide nodes (native).
    Returns (node_data (n, 72) f32, depth)."""
    node_data, depth = native.collapse_bvh8(nodes_bin, max_leaf)
    if depth * (WIDTH - 1) + 1 > STACK:
        raise ValueError(f"BVH8 depth {depth} overflows the {STACK}-entry "
                         "traversal stack")
    return node_data, depth


def pack_tris_flat(tri_geo_ordered) -> np.ndarray:
    """(T, 10) [p0, p1, p2, orig_id] -> flat (T*9,) [p0, e1, e2], the
    edges precomputed in f32."""
    t = np.asarray(tri_geo_ordered, np.float32)
    out = np.empty((t.shape[0], 9), np.float32)
    out[:, 0:3] = t[:, 0:3]
    out[:, 3:6] = t[:, 3:6] - t[:, 0:3]
    out[:, 6:9] = t[:, 6:9] - t[:, 0:3]
    return out.reshape(-1)


def build_bvh8(prim_lo, prim_hi, tri_geo, max_leaf: int = MAX_LEAF,
               binary_bvh=None, device="cuda") -> BVH8:
    """Binary SAH (max leaf 4) -> 8-wide collapse -> quantised tables on
    `device`. tri_geo: (T, 10) rows [p0, p1, p2, id] in original order.
    binary_bvh: an ops/bvh.BVH already built over the same boxes."""
    device = dev_mod.resolve(device)
    b = binary_bvh if binary_bvh is not None \
        else bvh_mod.build_bvh(prim_lo, prim_hi, max_leaf=4)
    order = np.asarray(b.prim_indices)
    node_data, depth = collapse_to_bvh8(np.asarray(b.nodes), max_leaf)
    nodes_f, nodes_q = quantize_nodes(node_data)
    tg = np.asarray(tri_geo)[order]
    return BVH8(nodes_f=torch.as_tensor(nodes_f, device=device),
                nodes_q=torch.as_tensor(nodes_q, device=device),
                tris=torch.as_tensor(pack_tris_flat(tg), device=device),
                prim_indices=torch.as_tensor(order.astype(np.int32),
                                             device=device),
                n_nodes=node_data.shape[0], n_tris=tg.shape[0],
                depth=int(depth))


# ---------------------------------------------------------------------------
# Plain PyTorch version: per-lane stacks, vectorised over the live lanes

def _slab(lo, hi, o, inv, t_best):
    """Slab test, (..., 3) boxes against broadcast rays -> bool (...)."""
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    tn = torch.minimum(t0, t1)
    tf = torch.maximum(t0, t1)
    zero = torch.zeros_like(tn[..., 2])
    tmin = torch.maximum(torch.maximum(tn[..., 0], tn[..., 1]),
                         torch.maximum(tn[..., 2], zero))
    tmax = torch.minimum(torch.minimum(tf[..., 0], tf[..., 1]),
                         torch.minimum(tf[..., 2], t_best))
    return tmin <= tmax * 1.0000004


def _tri_test(r, o, d):
    """Moeller-Trumbore on matched (M, 9) rows and (M, 3) rays, in the
    kernel's operation order. Returns (t, b1, b2, valid without the t
    bound)."""
    p0x, p0y, p0z = r[:, 0], r[:, 1], r[:, 2]
    e1x, e1y, e1z = r[:, 3], r[:, 4], r[:, 5]
    e2x, e2y, e2z = r[:, 6], r[:, 7], r[:, 8]
    o_x, o_y, o_z = o[:, 0], o[:, 1], o[:, 2]
    d_x, d_y, d_z = d[:, 0], d[:, 1], d[:, 2]
    pvx = d_y * e2z - d_z * e2y
    pvy = d_z * e2x - d_x * e2z
    pvz = d_x * e2y - d_y * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    sgn = torch.where(det < 0.0, -1.0, 1.0)
    det_a = det * sgn
    tx = o_x - p0x
    ty = o_y - p0y
    tz = o_z - p0z
    u_n = (tx * pvx + ty * pvy + tz * pvz) * sgn
    qvx = ty * e1z - tz * e1y
    qvy = tz * e1x - tx * e1z
    qvz = tx * e1y - ty * e1x
    v_n = (d_x * qvx + d_y * qvy + d_z * qvz) * sgn
    t_n = (e2x * qvx + e2y * qvy + e2z * qvz) * sgn
    tol = 1e-6 * det_a
    inv_det = 1.0 / torch.where(det_a == 0.0, 1.0, det_a)
    t = t_n * inv_det
    valid = ((det_a > 1e-12) & (u_n >= -tol) & (v_n >= -tol)
             & (u_n + v_n <= det_a + tol) & (t > T_MIN))
    return t, u_n * inv_det, v_n * inv_det, valid


def bvh8_intersect_plain(b8: BVH8, o, d, t_max, any_hit: bool):
    """Plain PyTorch traversal. o, d (N, 3) f32; t_max (N,) f32. Returns
    (t (N,) = inf on a miss, prim (N,) int32 original id = -1 on a miss,
    b1, b2 (N,) = 0 on a miss). Each loop pass pops one node on every lane
    whose stack is not empty. counter.work: node visits and triangle
    tests of the run."""
    counter.plain += 1
    work = dict(node_visits=0, tri_tests=0)
    dev = o.device
    N = o.shape[0]
    frames = b8.nodes_f[8:].view(-1, NF_F)
    q = b8.nodes_q.view(-1, WIDTH, 3)
    tris = b8.tris.view(-1, 9)
    inv = 1.0 / torch.where(d == 0.0, 1e-20, d)
    t_best = t_max.clone()
    slot = torch.full((N,), -1, dtype=torch.int64, device=dev)
    b1 = torch.zeros((N,), dtype=torch.float32, device=dev)
    b2 = torch.zeros_like(b1)
    go = _slab(b8.nodes_f[0:3], b8.nodes_f[3:6], o, inv, t_best)
    stack = torch.zeros((N, STACK), dtype=torch.int32, device=dev)
    sp = go.to(torch.int64)              # the root sits in stack[:, 0]
    ar8 = torch.arange(WIDTH, device=dev)
    big = WIDTH * MAX_LEAF
    while True:
        lanes = torch.nonzero(sp > 0).squeeze(1)
        n = lanes.numel()
        if n == 0:
            break
        work["node_visits"] += n
        spl = sp[lanes] - 1
        cur = stack[lanes, spl].to(torch.int64)
        fr = frames[cur]
        qq = q[cur]
        w0, w1, first = qq[..., 0], qq[..., 1], qq[..., 2]
        cnt = (w0 >> 24) & 255
        lo = torch.stack([fr[:, None, c] + ((w0 >> (8 * c)) & 255)
                          .to(torch.float32) * fr[:, None, 3 + c]
                          for c in range(3)], dim=-1)
        hi = torch.stack([fr[:, None, c] + ((w1 >> (8 * c)) & 255)
                          .to(torch.float32) * fr[:, None, 3 + c]
                          for c in range(3)], dim=-1)
        ol, dl, il = o[lanes], d[lanes], inv[lanes]
        tb = t_best[lanes]
        mask = _slab(lo, hi, ol[:, None, :], il[:, None, :], tb[:, None])
        leaf = mask & (cnt > 0) & (cnt < CNT_EMPTY)
        cand = leaf[:, :, None] & (ar8[None, None, :] < cnt[:, :, None])
        jj, cc, kk = torch.nonzero(cand, as_tuple=True)
        if jj.numel():
            work["tri_tests"] += jj.numel()
            s = first[jj, cc].to(torch.int64) + kk
            t, u, v, valid = _tri_test(tris[s], ol[jj], dl[jj])
            ok = valid & (t < tb[jj])
            order = cc * MAX_LEAF + kk     # the kernel's test order
            if not any_hit:
                # the strict-< running minimum keeps the first of the
                # smallest t: reduce t, then the order among its ties
                t_low = torch.full((n,), torch.inf, device=dev).scatter_reduce(
                    0, jj, torch.where(ok, t, torch.inf), "amin")
                ok = ok & (t == t_low[jj])
            first_ok = torch.full((n,), big, dtype=torch.int64,
                                  device=dev).scatter_reduce(
                0, jj, torch.where(ok, order, big), "amin")
            win = ok & (order == first_ok[jj])
            w_lanes = lanes[jj[win]]
            t_best[w_lanes] = t[win]
            slot[w_lanes] = s[win]
            b1[w_lanes] = u[win]
            b2[w_lanes] = v[win]
        # interior children hit at entry, near side last (pops first)
        axis = fr[:, 6].round().to(torch.int64)
        neg = dl.gather(1, axis[:, None])[:, 0] < 0.0
        perm = torch.where(neg[:, None], ar8, WIDTH - 1 - ar8)
        push = (mask & (cnt == 0)).gather(1, perm)
        rank = torch.cumsum(push.to(torch.int64), dim=1) - 1
        rows = lanes[:, None].expand(-1, WIDTH)
        stack[rows[push], (spl[:, None] + rank)[push]] = \
            first.gather(1, perm)[push]
        new_sp = spl + push.sum(dim=1)
        if any_hit:
            new_sp = torch.where(slot[lanes] >= 0, 0, new_sp)
        sp[lanes] = new_sp
    counter.work = work
    hit = slot >= 0
    prim = torch.where(hit, b8.prim_indices[slot.clamp(min=0)],
                       -1).to(torch.int32)
    return torch.where(hit, t_best, torch.inf), prim, b1, b2


def bvh8_intersect(b8: BVH8, o, d, t_max, any_hit: bool = False):
    """Closest (or any) hit of rays o, d (N, 3) with t below t_max ((N,)
    or a scalar). Returns dict(hit, t, prim (original id), b0, b1, b2)."""
    N = o.shape[0]
    if not (o.shape == d.shape == (N, 3)):
        raise ValueError("bvh8_intersect: o, d must be (N, 3)")
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=o.device)
    t_max = t_max.expand(N).contiguous() if t_max.dim() == 0 else t_max
    if t_max.shape != (N,):
        raise ValueError("bvh8_intersect: t_max must be (N,) or a scalar")
    devices = {x.device.type for x in (b8.nodes_f, o, d, t_max)}
    if devices == {"cpu"}:
        t, prim, b1, b2 = bvh8_intersect_plain(b8, o, d, t_max, any_hit)
    elif devices == {"cuda"}:
        t, prim, b1, b2 = _launch(b8, o, d, t_max, any_hit)
    else:
        raise ValueError(f"bvh8_intersect: tensors on mixed devices "
                         f"{devices}")
    return dict(hit=prim >= 0, t=t, prim=prim, b0=1.0 - b1 - b2, b1=b1,
                b2=b2)


def _launch(b8: BVH8, o, d, t_max, any_hit):
    import ctypes
    from . import _build
    for x in (b8.nodes_f, b8.tris, o, d, t_max):
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError("bvh8_intersect: float32 contiguous tensors "
                             "only")
    for x in (b8.nodes_q, b8.prim_indices):
        if x.dtype != torch.int32 or not x.is_contiguous():
            raise ValueError("bvh8_intersect: int32 contiguous node words "
                             "and prim indices only")
    lib = _build.load_library("bvh8")
    N = o.shape[0]
    t = torch.empty((N,), dtype=torch.float32, device=o.device)
    prim = torch.empty((N,), dtype=torch.int32, device=o.device)
    b1 = torch.empty_like(t)
    b2 = torch.empty_like(t)
    if N == 0:
        return t, prim, b1, b2
    with torch.cuda.device(o.device):
        err = lib.bvh8_intersect_launch(
            b8.nodes_f.data_ptr(), b8.nodes_q.data_ptr(), b8.tris.data_ptr(),
            b8.prim_indices.data_ptr(), o.data_ptr(), d.data_ptr(),
            t_max.data_ptr(), t.data_ptr(), prim.data_ptr(), b1.data_ptr(),
            b2.data_ptr(), N, int(any_hit),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    _build.check(err, "bvh8_intersect")
    counter.launches += 1
    return t, prim, b1, b2
