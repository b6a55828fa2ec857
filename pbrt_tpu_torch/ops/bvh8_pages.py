"""Paged big-mesh BVH8 traversal (counterpart of pbrt_tpu/ops/pallas_bvh8.py
`forest_intersect` and `binned_intersect`).

Both walk a binary SAH tree cut into K subtree chunks (ops/bvh8.py
`build_bvh8_forest`, `build_bvh8_chunked`), each chunk a BVH8 of its own
whose page fits a block's shared memory. A block is 1,024 rays (the
reference's 8 x 128), one CTA of the kernels, one ray per thread.

- `forest_intersect`: every block walks the K chunks in order. A ray enters
  a chunk when the chunk's root box passes against its running t (in
  any-hit mode only while it holds no hit); the block copies the page
  (72-float unquantised nodes, then 10-float triangles [p0, e1, e2, id])
  into shared memory when one of its rays enters, and each such ray
  traverses it. csrc/bvh8_forest.cu.
- `binned_intersect`: a host loop of rounds. Each round slab-tests every
  ray against every chunk's root box (`page_entries`, plain torch, grouped
  by 16 chunks), reduces to each block's nearest entry per page, skips the
  pages the block was served already, and gives every block the P nearest
  live pages in order (`schedule`); one launch of csrc/bvh8_binned.cu then
  copies each scheduled page (quantised tables) into shared memory and
  traverses it with the whole-tree kernel's traversal
  (csrc/bvh8_traverse.cuh). A page-local hit becomes a leaf-ordered slot
  by the page's start. The loop ends when no block has a live page left;
  each round costs one host sync.

Per ray the semantics are those of ops/bvh8.py (`walk`): slab tests
against the running t, leaves in slot order with the strict-< triangle
test, interior children pushed by the ray's own direction sign. Where the
TPU kernels differ by design: they share one stack and the push order of
the block's majority direction among a block's rays, and test a leaf's
triangles on every lane when one lane enters it, so the winner of an exact
t tie can differ; binned serves pages nearest entry first, so a cross-page
t tie can give another triangle than a walk in page order. In any-hit
mode the TPU kernel's lane liveness counts the hit from earlier pages too,
so such a lane enters no node of its own, but its leaf gate checks only
the page-local hit: the lane takes another hit in a leaf that another lane
of its block entered. A per-ray traversal has no shared leaf entry, so
here a ray that holds a hit skips the page, by design; the hit flag is
the same. The forest stores ids as float32, exact up to 2^24 triangles;
its wrapper refuses more.

The wrappers run the plain versions (`forest_intersect_plain`,
`binned_round_plain` inside the same host loop) for CPU tensors and the
kernels for CUDA tensors, or raise; a page larger than a block's shared
memory (`bvh8.SMEM_BYTES`) raises too.
"""
from __future__ import annotations

import numpy as np
import torch

from . import LaunchCounter
from .bvh8 import (LANES, SMEM_BYTES, WIDTH, BVH8Chunked, BVH8Forest,
                   _slab, quantised_nodes, triangle_rows, walk)

BLOCK = 8 * LANES           # rays per block: the reference's 8 x 128
NODE_F = WIDTH * 8 + 8      # forest node: 8 children x 8 floats + axis pad
TRI_F10 = 10                # forest triangle row [p0, e1, e2, id]
META = 8                    # forest meta per chunk
BIG = float(np.float32(3e38))
MAX_FOREST_TRIS = 1 << 24   # float32 ids are exact up to here
PAGES_PER_ROUND = 16
ENTRY_GROUP = 16

counter_forest = LaunchCounter("bvh8_forest")
counter_binned = LaunchCounter("bvh8_binned")


def _rays(what, o, d, t_max):
    """Checks o, d (N, 3); returns t_max as (N,) float32 on o's device."""
    N = o.shape[0]
    if not (o.shape == d.shape == (N, 3)):
        raise ValueError(f"{what}: o, d must be (N, 3)")
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=o.device)
    t_max = t_max.expand(N).contiguous() if t_max.dim() == 0 else t_max
    if t_max.shape != (N,):
        raise ValueError(f"{what}: t_max must be (N,) or a scalar")
    return t_max


def _device(what, tensors):
    devices = {x.device.type for x in tensors}
    if devices not in ({"cpu"}, {"cuda"}):
        raise ValueError(f"{what}: tensors on mixed devices {devices}")
    return devices.pop()


def _inv(d):
    return 1.0 / torch.where(d == 0.0, 1e-20, d)


def _result(t, prim, b1, b2, **extra):
    return dict(hit=prim >= 0, t=t, prim=prim, b0=1.0 - b1 - b2, b1=b1,
                b2=b2, **extra)


# ---------------------------------------------------------------------------
# Forest

def forest_nodes(pages, base):
    """Node decoder of forest pages for `walk`: flat pages, each lane's
    page starting at `base` ((n,) or an int)."""
    ar = torch.arange(NODE_F, device=pages.device)

    def decode(cur, lanes):
        b = base[lanes] if torch.is_tensor(base) else base
        nd = pages[(b + cur * NODE_F)[:, None] + ar]
        ch = nd[:, :WIDTH * 8].view(-1, WIDTH, 8)
        return (ch[..., 0:3], ch[..., 3:6], ch[..., 6].round().long(),
                ch[..., 7].round().long(), nd[:, WIDTH * 8].round().long())
    return decode


def forest_intersect_plain(f: BVH8Forest, o, d, t_max, any_hit: bool):
    """Plain PyTorch version of the forest kernel: chunks in order, each
    entered by the rays whose root test passes, traversed with `walk`.
    Returns (t (N,) = inf on a miss, prim (N,) int32 = -1, b1, b2 (N,) = 0
    on a miss). counter_forest.work: root tests, node visits, triangle
    tests, and the page copies of the kernel (blocks that enter a chunk)."""
    counter_forest.plain += 1
    work = dict(root_tests=0, node_visits=0, tri_tests=0, page_copies=0)
    N = o.shape[0]
    pages = f.pages.reshape(-1)
    pf = f.rows * LANES
    meta = f.meta.view(-1, META)
    tri_base = meta[:, 1].round().long().tolist()
    inv = _inv(d)
    t = t_max.clone()
    prim = torch.full((N,), -1, dtype=torch.int64, device=o.device)
    b1 = torch.zeros((N,), dtype=torch.float32, device=o.device)
    b2 = torch.zeros_like(b1)
    for k in range(f.n_chunks):
        live = prim < 0 if any_hit else torch.ones_like(prim, dtype=bool)
        work["root_tests"] += int(live.sum())
        go = live & _slab(meta[k, 2:5], meta[k, 5:8], o, inv, t)
        work["page_copies"] += int(torch.nn.functional.pad(
            go, (0, -N % BLOCK)).view(-1, BLOCK).any(dim=1).sum())
        base = k * pf + tri_base[k]
        loc = walk(forest_nodes(pages, k * pf),
                   triangle_rows(pages, TRI_F10, base), o, d, t, b1, b2, go,
                   any_hit, work)
        ids = pages[base + loc.clamp(min=0) * TRI_F10 + 9].round().long()
        prim = torch.where(loc >= 0, ids, prim)
    counter_forest.work = work
    hit = prim >= 0
    return torch.where(hit, t, torch.inf), prim.to(torch.int32), b1, b2


def _check_forest(f: BVH8Forest):
    if f.page_bytes > SMEM_BYTES:
        raise ValueError(f"forest_intersect: a page of {f.page_bytes} B does "
                         f"not fit a block's {SMEM_BYTES} B of shared memory")
    if f.n_tris > MAX_FOREST_TRIS:
        raise ValueError(f"forest_intersect: {f.n_tris} triangles; float32 "
                         f"ids are exact up to {MAX_FOREST_TRIS}")


def forest_intersect(f: BVH8Forest, o, d, t_max, any_hit: bool = False):
    """Closest (or any) hit of rays o, d (N, 3) with t below t_max ((N,)
    or a scalar) over a forest. Returns dict(hit, t, prim (original id),
    b0, b1, b2)."""
    _check_forest(f)
    t_max = _rays("forest_intersect", o, d, t_max)
    if _device("forest_intersect", (f.pages, f.meta, o, d, t_max)) == "cpu":
        return _result(*forest_intersect_plain(f, o, d, t_max, any_hit))
    return _result(*_launch_forest(f, o, d, t_max, any_hit))


def _launch_forest(f: BVH8Forest, o, d, t_max, any_hit):
    import ctypes
    from . import _build
    for x in (f.meta, f.pages, o, d, t_max):
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError("forest_intersect: float32 contiguous tensors "
                             "only")
    lib = _build.load_library("bvh8_forest")
    N = o.shape[0]
    t = torch.empty((N,), dtype=torch.float32, device=o.device)
    prim = torch.empty((N,), dtype=torch.int32, device=o.device)
    b1 = torch.empty_like(t)
    b2 = torch.empty_like(t)
    if N == 0:
        return t, prim, b1, b2
    with torch.cuda.device(o.device):
        err = lib.bvh8_forest_launch(
            f.meta.data_ptr(), f.pages.data_ptr(), o.data_ptr(), d.data_ptr(),
            t_max.data_ptr(), t.data_ptr(), prim.data_ptr(), b1.data_ptr(),
            b2.data_ptr(), N, f.n_chunks, f.rows * LANES, int(any_hit),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    _build.check(err, "forest_intersect")
    counter_forest.launches += 1
    return t, prim, b1, b2


# ---------------------------------------------------------------------------
# Binned: the pre-pass, the schedule and the rounds

def page_entries(c: BVH8Chunked, o, d, te, group: int = ENTRY_GROUP):
    """(B, K) float32: per ray block and chunk, the least entry distance
    into the chunk's root box (nodes_f[k, 0:6]) among the block's rays
    whose bound te ((N,); -1 for none) the box still beats, BIG where none
    does (reference _page_entries). Chunks go `group` at a time, so the
    intermediates are (N, group, 3)."""
    N = o.shape[0]
    B = -(-N // BLOCK)
    pad = B * BLOCK - N
    if pad:
        o = torch.cat([o, o.new_full((pad, 3), 1e9)])
        d = torch.cat([d, d.new_full((pad, 3), 1.0)])
        te = torch.cat([te, te.new_full((pad,), -1.0)])
    K = c.n_chunks
    G = min(group, K)
    Kp = -(-K // G) * G
    lo = torch.cat([c.nodes_f[:, 0:3], c.nodes_f.new_full((Kp - K, 3), BIG)])
    hi = torch.cat([c.nodes_f[:, 3:6],
                    c.nodes_f.new_full((Kp - K, 3), -BIG)])
    inv = _inv(d)[:, None]
    o = o[:, None]
    out = []
    for g in range(0, Kp, G):
        t0 = (lo[g:g + G][None] - o) * inv
        t1 = (hi[g:g + G][None] - o) * inv
        tn = torch.clamp(torch.minimum(t0, t1).amax(dim=-1), min=0.0)
        tf = torch.minimum(torch.maximum(t0, t1).amin(dim=-1), te[:, None])
        ent = torch.where(tn <= tf * 1.0000004, tn, BIG)
        out.append(ent.view(B, BLOCK, G).amin(dim=1))
    return torch.cat(out, dim=1)[:, :K]


def schedule(ent, served, P: int):
    """Each block's P nearest live pages (reference binned_intersect body):
    (sched (B, P) int32, valid (B, P) uint8); marks them served in place.
    Entries are sorted ascending, so the valid ones are a prefix."""
    idx = torch.argsort(ent, dim=1, stable=True)[:, :P]
    valid = ent.gather(1, idx) < BIG
    served.scatter_(1, idx, valid | served.gather(1, idx))
    return (idx.to(torch.int32).contiguous(),
            valid.to(torch.uint8).contiguous())


def binned_round_plain(c: BVH8Chunked, sched, valid, o, d, t, slot, b1, b2,
                       any_hit: bool, work):
    """Plain PyTorch version of one round of the binned kernel: each ray
    takes its block's scheduled pages in order (a ray that holds a hit
    skips them in any-hit mode), tests the page's root box against its
    running t and traverses the page with `walk`. t, slot (leaf-ordered,
    int32), b1, b2 (N,) are updated in place; `work` gains root tests,
    node visits and triangle tests."""
    N = o.shape[0]
    blk = torch.arange(N, device=o.device) // BLOCK
    nfl, nql, tl = (x.shape[1] for x in (c.nodes_f, c.nodes_q, c.tris))
    nf, nq, tr = (x.reshape(-1) for x in (c.nodes_f, c.nodes_q, c.tris))
    inv = _inv(d)
    for p in range(sched.shape[1]):
        v = valid[blk, p].bool()
        if any_hit:
            v = v & (slot < 0)
        k = sched[blk, p].long()
        work["root_tests"] += int(v.sum())
        go = v & _slab(c.nodes_f[k, 0:3], c.nodes_f[k, 3:6], o, inv, t)
        loc = walk(quantised_nodes(nf, nq, k * nfl, k * nql),
                   triangle_rows(tr, 9, k * tl), o, d, t, b1, b2, go,
                   any_hit, work)
        slot.copy_(torch.where(loc >= 0, loc + c.page_start[k], slot))


def _binned(what, c: BVH8Chunked, o, d, t_max, any_hit, pages_per_round,
            round_fn, stages):
    """The host loop of rounds. round_fn(sched, valid, t, slot, b1, b2)
    runs one round in place. stages: None, or a list that gains (name,
    start event, end event) of every pre-pass, schedule and round (CUDA
    only). Returns (t, prim, b1, b2, rounds, page copies: the valid
    schedule entries, each a page the kernel copies)."""
    if c.page_bytes > SMEM_BYTES:
        raise ValueError(f"{what}: a page of {c.page_bytes} B does not fit a "
                         f"block's {SMEM_BYTES} B of shared memory")
    N = o.shape[0]
    dev = o.device
    t = t_max.clone()
    slot = torch.full((N,), -1, dtype=torch.int32, device=dev)
    b1 = torch.zeros((N,), dtype=torch.float32, device=dev)
    b2 = torch.zeros_like(b1)
    served = torch.zeros((-(-N // BLOCK), c.n_chunks), dtype=torch.bool,
                         device=dev)
    P = min(pages_per_round, c.n_chunks)

    def timed(name, fn, *args):
        if stages is None:
            return fn(*args)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = fn(*args)
        ev[1].record()
        stages.append((name, *ev))
        return out

    def live_entries():
        te = torch.where(slot >= 0, -1.0, t) if any_hit else t
        ent = page_entries(c, o, d, te)
        return torch.where(served, BIG, ent)

    rounds = 0
    copies = torch.zeros((), dtype=torch.int64, device=dev)
    ent = timed("entries", live_entries) if N else None
    while N and bool((ent < BIG).any()):
        sched, valid = timed("schedule", schedule, ent, served, P)
        timed("round", round_fn, sched, valid, t, slot, b1, b2)
        rounds += 1
        copies += valid.sum()
        ent = timed("entries", live_entries)
    hit = slot >= 0
    prim = torch.where(hit, c.prim_indices[slot.clamp(min=0).long()], -1)
    return torch.where(hit, t, torch.inf), prim.to(torch.int32), b1, b2, \
        rounds, int(copies)


def binned_intersect_plain(c: BVH8Chunked, o, d, t_max, any_hit: bool,
                           pages_per_round: int = PAGES_PER_ROUND):
    """The host loop of rounds with the plain round, on any device.
    Returns (t, prim, b1, b2, rounds, page copies). counter_binned.work:
    root tests,
    node visits and triangle tests of all rounds."""
    counter_binned.plain += 1
    work = dict(root_tests=0, node_visits=0, tri_tests=0)

    def round_fn(sched, valid, t, slot, b1, b2):
        binned_round_plain(c, sched, valid, o, d, t, slot, b1, b2, any_hit,
                           work)
    out = _binned("binned_intersect", c, o, d, t_max, any_hit,
                  pages_per_round, round_fn, None)
    counter_binned.work = work
    return out


def binned_intersect(c: BVH8Chunked, o, d, t_max, any_hit: bool = False,
                     pages_per_round: int = PAGES_PER_ROUND, stages=None):
    """Closest (or any) hit of rays o, d (N, 3) with t below t_max ((N,)
    or a scalar) over chunked pages. Returns dict(hit, t, prim (original
    id), b0, b1, b2, rounds, page_copies)."""
    t_max = _rays("binned_intersect", o, d, t_max)
    tensors = (c.nodes_f, c.nodes_q, c.tris, o, d, t_max)
    if _device("binned_intersect", tensors) == "cpu":
        *res, rounds, copies = binned_intersect_plain(
            c, o, d, t_max, any_hit, pages_per_round)
        return _result(*res, rounds=rounds, page_copies=copies)
    _check_binned_launch(c, o, d, t_max)

    def round_fn(sched, valid, t, slot, b1, b2):
        _launch_binned_round(c, sched, valid, o, d, t, slot, b1, b2, any_hit)
    *res, rounds, copies = _binned("binned_intersect", c, o, d, t_max,
                                   any_hit, pages_per_round, round_fn,
                                   stages)
    return _result(*res, rounds=rounds, page_copies=copies)


def _check_binned_launch(c: BVH8Chunked, o, d, t_max):
    for x in (c.nodes_f, c.tris, o, d, t_max):
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError("binned_intersect: float32 contiguous tensors "
                             "only")
    for x in (c.nodes_q, c.page_start):
        if x.dtype != torch.int32 or not x.is_contiguous():
            raise ValueError("binned_intersect: int32 contiguous node words "
                             "and page starts only")


def _launch_binned_round(c: BVH8Chunked, sched, valid, o, d, t, slot, b1,
                         b2, any_hit):
    import ctypes
    from . import _build
    lib = _build.load_library("bvh8_binned")
    with torch.cuda.device(o.device):
        err = lib.bvh8_binned_launch(
            c.nodes_f.data_ptr(), c.nodes_q.data_ptr(), c.tris.data_ptr(),
            c.page_start.data_ptr(), sched.data_ptr(), valid.data_ptr(),
            o.data_ptr(), d.data_ptr(), t.data_ptr(), slot.data_ptr(),
            b1.data_ptr(), b2.data_ptr(), o.shape[0], sched.shape[1],
            c.nodes_f.shape[1], c.nodes_q.shape[1], c.tris.shape[1],
            int(any_hit),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    _build.check(err, "binned_intersect")
    counter_binned.launches += 1
