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
from .. import spans
from . import LaunchCounter
from . import bvh as bvh_mod

WIDTH = 8                 # children per node
STACK = 96
NF_F = 8                  # f32 frame floats per node
NQ_I = WIDTH * 3          # i32 words per node
CNT_EMPTY = 255
MAX_LEAF = 8
T_MIN = 1e-5

counter = LaunchCounter("bvh8")


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


def collapse_to_bvh8(nodes_bin: np.ndarray, max_leaf: int = MAX_LEAF,
                     prim_base: int = 0):
    """Collapse a flattened binary SAH BVH into 8-wide nodes (native) from
    its root, leaf starts relative to `prim_base`. Returns (node_data (n,
    72) f32, depth)."""
    node_data, depth = native.collapse_bvh8(nodes_bin, max_leaf,
                                            prim_base=prim_base)
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


def pack_tris_flat10(tri_geo_ordered) -> np.ndarray:
    """(T, 10) [p0, p1, p2, orig_id] -> flat (T*10,) [p0, e1, e2, orig_id]
    (the forest's triangle rows)."""
    t = np.asarray(tri_geo_ordered, np.float32)
    out = np.empty_like(t)
    out[:, 0:3] = t[:, 0:3]
    out[:, 3:6] = t[:, 3:6] - t[:, 0:3]
    out[:, 6:9] = t[:, 6:9] - t[:, 0:3]
    out[:, 9] = t[:, 9]
    return out.reshape(-1)


@spans.span("bvh.build")
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
# Paged builds (reference BVH8Chunked / BVH8Forest): the binary SAH tree cut
# into subtree chunks whose pages fit a block's shared memory; each chunk
# is a BVH8 of its own. Traversed by ops/bvh8_pages.py.

SMEM_BYTES = 232448       # the most dynamic shared memory an H100 block has
LANES = 128               # page rows of the reference's (rows, 128) layout


@dataclasses.dataclass
class BVH8Chunked:
    """Quantised BVH8 pages (reference BVH8Chunked): nodes_f (K, NFL) f32,
    nodes_q (K, NQL) i32, tris (K, TL) f32, each row one chunk's BVH8
    tables zero-padded to a multiple of 128; page_start (K,) i32, the
    chunk's first triangle in leaf order; prim_indices (T,) i32."""
    nodes_f: torch.Tensor
    nodes_q: torch.Tensor
    tris: torch.Tensor
    page_start: torch.Tensor
    prim_indices: torch.Tensor
    n_chunks: int
    n_tris: int
    depth: int

    @property
    def page_bytes(self) -> int:
        return 4 * (self.nodes_f.shape[1] + self.nodes_q.shape[1]
                    + self.tris.shape[1])


@dataclasses.dataclass
class BVH8Forest:
    """Unquantised BVH8 pages (reference BVH8Forest): meta (K*8,) f32 per
    chunk [n_nodes, tri_base (page floats before the triangles), root lo
    xyz, hi xyz]; pages (K, rows, 128) f32, each the chunk's 72-float nodes
    (children [lo3, hi3, first, cnt], cnt 0 interior, -1 empty; the axis
    at float 64) then its 10-float triangles [p0, e1, e2, original id];
    prim_indices (T,) i32."""
    meta: torch.Tensor
    pages: torch.Tensor
    prim_indices: torch.Tensor
    n_chunks: int
    rows: int
    n_tris: int
    depth: int

    @property
    def page_bytes(self) -> int:
        return 4 * self.rows * LANES


def partition_chunk_roots(nodes_bin: np.ndarray, budget: int):
    """Greedy DFS partition of a flattened binary SAH BVH into subtree
    chunk roots whose estimated page (50 B a triangle, 1.3x margin) fits
    `budget` bytes. Returns (chunk_roots, start, count, is_leaf, roff)."""
    nb = np.asarray(nodes_bin)
    roff = np.round(nb[:, 6]).astype(np.int64)
    is_leaf = (np.round(nb[:, 7]).astype(np.int64) >> 2) > 0
    start, count = native.subtree_ranges(nodes_bin)
    chunk_roots = []
    stack = [0]
    while stack:
        s = stack.pop()
        if int(count[s] * 50 * 1.3) <= budget or is_leaf[s]:
            chunk_roots.append(s)
        else:
            stack.append(roff[s])
            stack.append(s + 1)
    return chunk_roots, start, count, is_leaf, roff


def _pad_to_lanes(n: int) -> int:
    return -(-n // LANES) * LANES


def _collapse_chunk(nb, root: int, prim_base: int, max_leaf: int):
    """collapse_to_bvh8 of the subtree at binary node `root`, on a copy of
    just that subtree: in the depth-first layout it is the contiguous run
    from `root` to the leaf at the end of its rightmost path, so child
    offsets shift by `root` and the native collapse (which sweeps every
    node it is given) costs the chunk's size, not the tree's. Same rows as
    collapsing the whole array from `root`."""
    end = root
    while (int(round(float(nb[end, 7]))) >> 2) == 0:    # interior
        end = int(round(float(nb[end, 6])))
    sub = nb[root:end + 1].copy()
    interior = (np.round(sub[:, 7]).astype(np.int64) >> 2) == 0
    sub[interior, 6] -= root
    return collapse_to_bvh8(sub, max_leaf, prim_base=prim_base)


def build_bvh8_chunked(prim_lo, prim_hi, tri_geo, max_leaf: int = MAX_LEAF,
                       binary_bvh=None, budget: int = SMEM_BYTES,
                       device="cuda") -> BVH8Chunked:
    """Chunked quantised pages on `device`, each page (NFL + NQL + TL) * 4
    bytes at most `budget`: the partition shrinks and repeats until the
    padded pages fit. tri_geo: (T, 10) rows in original order."""
    device = dev_mod.resolve(device)
    b = binary_bvh if binary_bvh is not None \
        else bvh_mod.build_bvh(prim_lo, prim_hi, max_leaf=4)
    order = np.asarray(b.prim_indices)
    tg = np.asarray(tri_geo, np.float32)[order]
    nb = np.ascontiguousarray(np.asarray(b.nodes), np.float32)
    part_budget = budget
    for _ in range(8):
        chunk_roots, start, count, _, _ = partition_chunk_roots(
            nb, part_budget)
        nf_pages, nq_pages, tri_pages, starts = [], [], [], []
        max_depth = 0
        for s in chunk_roots:
            nd, dep = _collapse_chunk(nb, s, int(start[s]), max_leaf)
            max_depth = max(max_depth, dep)
            nf, nq = quantize_nodes(nd)
            nf_pages.append(nf)
            nq_pages.append(nq)
            tri_pages.append(
                pack_tris_flat(tg[start[s]:start[s] + count[s]]))
            starts.append(int(start[s]))
        widths = [_pad_to_lanes(max(p.shape[0] for p in pages))
                  for pages in (nf_pages, nq_pages, tri_pages)]
        if 4 * sum(widths) <= budget:
            break
        part_budget = int(part_budget * 0.7)
    else:
        raise RuntimeError(f"chunk pages ({4 * sum(widths)} B) exceed the "
                           f"budget of {budget} B after 8 partitions")
    K = len(nf_pages)
    tables = [np.zeros((K, w), dt) for w, dt in
              zip(widths, (np.float32, np.int32, np.float32))]
    for table, pages in zip(tables, (nf_pages, nq_pages, tri_pages)):
        for k, p in enumerate(pages):
            table[k, :p.shape[0]] = p
    nodes_f, nodes_q, tris = (torch.as_tensor(x, device=device)
                              for x in tables)
    return BVH8Chunked(nodes_f=nodes_f, nodes_q=nodes_q, tris=tris,
                       page_start=torch.as_tensor(np.asarray(starts,
                                                             np.int32),
                                                  device=device),
                       prim_indices=torch.as_tensor(order.astype(np.int32),
                                                    device=device),
                       n_chunks=K, n_tris=tg.shape[0], depth=max_depth)


def build_bvh8_forest(prim_lo, prim_hi, tri_geo, max_leaf: int = MAX_LEAF,
                      binary_bvh=None, page_budget: int = SMEM_BYTES,
                      device="cuda") -> BVH8Forest:
    """Forest pages on `device`, each at most `page_budget` bytes (the
    reference's partition estimate; a page over it raises). tri_geo: (T,
    10) rows in original order."""
    device = dev_mod.resolve(device)
    b = binary_bvh if binary_bvh is not None \
        else bvh_mod.build_bvh(prim_lo, prim_hi, max_leaf=4)
    order = np.asarray(b.prim_indices)
    tg = np.asarray(tri_geo, np.float32)[order]
    nb = np.ascontiguousarray(np.asarray(b.nodes), np.float32)
    chunk_roots, start, count, _, _ = partition_chunk_roots(nb, page_budget)
    pages, metas = [], []
    max_depth = 0
    for s in chunk_roots:
        nd, dep = _collapse_chunk(nb, s, int(start[s]), max_leaf)
        max_depth = max(max_depth, dep)
        node_flat = nd.reshape(-1)
        page = np.concatenate(
            [node_flat, pack_tris_flat10(tg[start[s]:start[s] + count[s]])])
        if page.nbytes > page_budget:
            raise ValueError(f"chunk page {page.nbytes} B exceeds the page "
                             f"budget of {page_budget} B")
        pages.append(page)
        metas.append([nd.shape[0], node_flat.shape[0], *nb[s, :6]])
    rows = max(-(-p.shape[0] // LANES) for p in pages)
    K = len(pages)
    pg = np.zeros((K, rows * LANES), np.float32)
    for k, p in enumerate(pages):
        pg[k, :p.shape[0]] = p
    return BVH8Forest(
        meta=torch.as_tensor(np.asarray(metas, np.float32).reshape(-1),
                             device=device),
        pages=torch.as_tensor(pg.reshape(K, rows, LANES), device=device),
        prim_indices=torch.as_tensor(order.astype(np.int32), device=device),
        n_chunks=K, rows=rows, n_tris=tg.shape[0], depth=max_depth)


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


def quantised_nodes(nodes_f, nodes_q, base_f=0, base_q=0):
    """Node decoder of quantised BVH8 tables for `walk`: flat nodes_f and
    nodes_q, each lane's page starting at base_f / base_q ((n,) or 0)."""
    ar_f = torch.arange(NF_F, device=nodes_f.device)
    ar_q = torch.arange(NQ_I, device=nodes_f.device)

    def decode(cur, lanes):
        bf = base_f[lanes] if torch.is_tensor(base_f) else base_f
        bq = base_q[lanes] if torch.is_tensor(base_q) else base_q
        fr = nodes_f[(bf + 8 + cur * NF_F)[:, None] + ar_f]
        qq = nodes_q[(bq + cur * NQ_I)[:, None] + ar_q].view(-1, WIDTH, 3)
        w0, w1, first = qq[..., 0], qq[..., 1], qq[..., 2]
        lo = torch.stack([fr[:, None, c] + ((w0 >> (8 * c)) & 255)
                          .to(torch.float32) * fr[:, None, 3 + c]
                          for c in range(3)], dim=-1)
        hi = torch.stack([fr[:, None, c] + ((w1 >> (8 * c)) & 255)
                          .to(torch.float32) * fr[:, None, 3 + c]
                          for c in range(3)], dim=-1)
        return (lo, hi, first.to(torch.int64), (w0 >> 24) & 255,
                fr[:, 6].round().to(torch.int64))
    return decode


def triangle_rows(tris, stride, base=0):
    """Triangle reader for `walk`: rows [p0, e1, e2] of `stride` floats in
    flat `tris`, each lane's page starting at `base` ((n,) or 0)."""
    ar9 = torch.arange(9, device=tris.device)

    def rows(slot, lanes):
        b = base[lanes] if torch.is_tensor(base) else base
        return tris[(b + slot * stride)[:, None] + ar9]
    return rows


def walk(decode, rows, o, d, t_best, b1, b2, go, any_hit, work):
    """Per-lane stack traversal of 8-wide nodes, vectorised over the lanes
    whose stack is not empty: each loop pass pops one node on each of them.
    decode(cur, lanes) -> (child lo, hi (n, 8, 3), first, count (n, 8),
    axis (n,)) of node cur of each lane's tree; rows(slot, lanes) -> (m,
    9) triangle rows. Lanes with `go` start at node 0. t_best, b1, b2 (N,)
    hold the running hit and are updated in place. Returns the winning
    triangle slot (N,) int64, -1 where none; adds node visits and triangle
    tests to `work`."""
    dev = o.device
    N = o.shape[0]
    inv = 1.0 / torch.where(d == 0.0, 1e-20, d)
    slot = torch.full((N,), -1, dtype=torch.int64, device=dev)
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
        lo, hi, first, cnt, axis = decode(cur, lanes)
        ol, dl, il = o[lanes], d[lanes], inv[lanes]
        tb = t_best[lanes]
        mask = _slab(lo, hi, ol[:, None, :], il[:, None, :], tb[:, None])
        leaf = mask & (cnt > 0) & (cnt < CNT_EMPTY)
        cand = leaf[:, :, None] & (ar8[None, None, :] < cnt[:, :, None])
        jj, cc, kk = torch.nonzero(cand, as_tuple=True)
        if jj.numel():
            work["tri_tests"] += jj.numel()
            s = first[jj, cc] + kk
            t, u, v, valid = _tri_test(rows(s, lanes[jj]), ol[jj], dl[jj])
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
        neg = dl.gather(1, axis[:, None])[:, 0] < 0.0
        perm = torch.where(neg[:, None], ar8, WIDTH - 1 - ar8)
        push = (mask & (cnt == 0)).gather(1, perm)
        rank = torch.cumsum(push.to(torch.int64), dim=1) - 1
        rows_ = lanes[:, None].expand(-1, WIDTH)
        stack[rows_[push], (spl[:, None] + rank)[push]] = \
            first.gather(1, perm)[push].to(torch.int32)
        new_sp = spl + push.sum(dim=1)
        if any_hit:
            new_sp = torch.where(slot[lanes] >= 0, 0, new_sp)
        sp[lanes] = new_sp
    return slot


def bvh8_intersect_plain(b8: BVH8, o, d, t_max, any_hit: bool):
    """Plain PyTorch traversal. o, d (N, 3) f32; t_max (N,) f32. Returns
    (t (N,) = inf on a miss, prim (N,) int32 original id = -1 on a miss,
    b1, b2 (N,) = 0 on a miss). counter.work: node visits and triangle
    tests of the run."""
    counter.plain += 1
    work = dict(node_visits=0, tri_tests=0)
    N = o.shape[0]
    inv = 1.0 / torch.where(d == 0.0, 1e-20, d)
    t_best = t_max.clone()
    b1 = torch.zeros((N,), dtype=torch.float32, device=o.device)
    b2 = torch.zeros_like(b1)
    go = _slab(b8.nodes_f[0:3], b8.nodes_f[3:6], o, inv, t_best)
    slot = walk(quantised_nodes(b8.nodes_f, b8.nodes_q),
                triangle_rows(b8.tris, 9), o, d, t_best, b1, b2, go,
                any_hit, work)
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
        with spans.span("bvh8.kernel"):
            t, prim, b1, b2 = bvh8_intersect_plain(b8, o, d, t_max, any_hit)
    elif devices == {"cuda"}:
        t, prim, b1, b2 = _launch(b8, o, d, t_max, any_hit)
    else:
        raise ValueError(f"bvh8_intersect: tensors on mixed devices "
                         f"{devices}")
    return dict(hit=prim >= 0, t=t, prim=prim, b0=1.0 - b1 - b2, b1=b1,
                b2=b2)


def grid(n: int, device) -> dict:
    """The kernel's persistent grid for n rays on `device`: blocks,
    blocks_per_sm, threads (a block), resident_lanes (threads in flight at
    once: blocks x threads when the rays fill the card)."""
    import ctypes
    from . import _build
    lib = _build.load_library("bvh8")
    out = [ctypes.c_int(0) for _ in range(3)]
    with torch.cuda.device(device):
        err = lib.bvh8_grid(n, *(ctypes.byref(x) for x in out))
    _build.check(err, "bvh8_grid")
    blocks, per_sm, threads = (x.value for x in out)
    return dict(blocks=blocks, blocks_per_sm=per_sm, threads=threads,
                resident_lanes=blocks * threads)


def _launch(b8: BVH8, o, d, t_max, any_hit, out=None):
    """out: (t, prim, b1, b2) to write into (a timing loop's, allocated
    once); allocated here when None."""
    from . import _build
    lib = _build.load_library("bvh8")
    with torch.cuda.device(o.device):
        args, out = launch_args(b8, o, d, t_max, any_hit, out=out)
        if args is None:
            return out
        with spans.span("bvh8.kernel"):
            err = lib.bvh8_intersect_launch(*args)
    _build.check(err, "bvh8_intersect")
    counter.launches += 1
    return out


def launch_args(b8: BVH8, o, d, t_max, any_hit, out=None):
    """The arguments of bvh8_intersect_launch on the current device's
    current stream, and the outputs they write: (args, (t, prim, b1, b2)),
    args None when there are no rays. A timing tool calls the library with
    them again to time the launch without the wrapper's host work."""
    import ctypes
    for x in (b8.nodes_f, b8.tris, o, d, t_max):
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError("bvh8_intersect: float32 contiguous tensors "
                             "only")
    for x in (b8.nodes_q, b8.prim_indices):
        if x.dtype != torch.int32 or not x.is_contiguous():
            raise ValueError("bvh8_intersect: int32 contiguous node words "
                             "and prim indices only")
    # the kernel reads node frames and child words as 16 B vectors
    if b8.nodes_f.data_ptr() % 16 or b8.nodes_q.data_ptr() % 16:
        raise ValueError("bvh8_intersect: nodes_f and nodes_q must be "
                         "16-byte aligned")
    N = o.shape[0]
    if out is None:
        t = torch.empty((N,), dtype=torch.float32, device=o.device)
        prim = torch.empty((N,), dtype=torch.int32, device=o.device)
        out = (t, prim, torch.empty_like(t), torch.empty_like(t))
    if N == 0:
        return None, out
    stream = torch.cuda.current_stream().cuda_stream
    return (b8.nodes_f.data_ptr(), b8.nodes_q.data_ptr(), b8.tris.data_ptr(),
            b8.prim_indices.data_ptr(), o.data_ptr(), d.data_ptr(),
            t_max.data_ptr(),
            *(x.data_ptr() for x in out), N, int(any_hit),
            ctypes.c_void_p(stream)), out
