"""Global -> shared page-copy probes (counterpart of the TPU copy probes
tools/exp_dma_var.py, tools/exp_dma_var2.py and tools/exp_dma_min.py).

A probe stages pages of `rows` x 128 float32 (rows * 512 bytes) in a
block's shared memory and adds one number per staged page to the block's
(8, 128) tile of x:

- `dma_var(pages, x, variant)`: one copy. `hbm_smem_slice`,
  `hbm_vmem_slice`: page 2; `hbm_smem_full`, `hbm_vmem_full`: all K pages,
  the number read from page 2 of the staged array; `vmem_smem`: page 2
  into one buffer, from there through registers into a second; `smem_1d`:
  page 2 of the flat (K, rows * 128) layout. x, out (8, 128).
- `dma_sched(pages, x, sched, P, mode)`: block b stages the pages
  sched[b * P + p], p = 0..P-1, and adds each one's number. mode
  "manual" (the TPU probes `ds_smem`, `ds_vmem`): one buffer, start then
  wait, every p. mode "pipelined" (`blockspec_vmem`, `blockspec_smem`:
  the TPU's BlockSpec pipeline prefetches block p + 1 under the body of
  p): two buffers, the copy of page p + 1 started before page p is
  consumed. x, out (B * 8, 128).
- `dma_ladder(pages, x, sched, P, stage)`: the binned kernel's ladder; a
  schedule entry < 0 means no page. Stage 1 copies page max(k, 0) always
  and adds at p = 0 only; 2 copies only where k >= 0; 3 adds at every
  valid p; 4 adds a loop of three scalar reads scr[i, 1] * 0.

The TPU's SMEM and VMEM are both a block's shared memory on the card, so
the `_smem` and `_vmem` names of a probe share one body. What differs
there is the copy path, `copy=`: "ld" (cooperative float4 loads and shared
stores), "cp_async" (cp.async, 16 B a thread a step) or "bulk" (the 1-D
bulk copy, one thread, completion on an mbarrier). `reduce=`: "first" adds
the staged page's first element (the TPU probes' function); "sum" adds the
sum of the whole staged page, so the consumer reads every staged byte.
`make_pages(fill="small")` fills pages with integers 0..7, so every f32
sum of up to 2^21 staged floats is an exact integer in any order and the
kernel equals the plain version bit for bit.

Each wrapper runs its plain version (`*_plain`: indexing and sums) for CPU
tensors and launches csrc/dma_probe.cu for CUDA tensors, or raises. The
staged buffers and the kernels' 256 B of static shared memory must fit a
block's 232,448 B: one page up to 453 rows, two buffers (pipelined,
`vmem_smem`) up to 226 rows each.
"""
from __future__ import annotations

import numpy as np
import torch

from . import LaunchCounter
from .bvh8 import LANES, SMEM_BYTES
from ..device import resolve

ROW_BYTES = LANES * 4       # 512
# reduction scratch (128 B) and the mbarriers, padded to the buffers' 128 B
# alignment, as ptxas reports it
STATIC_BYTES = 256
VAR_PAGE = 2                # the page dma_var stages
VAR_BLOCKS = 2              # dma_var's grid, the TPU probe's
TILE_ROWS = 8               # a block's tile of x and out: (8, 128)
COPIES = ("ld", "cp_async", "bulk")
REDUCES = ("first", "sum")
# dma_var variant -> (kernel switch, staged buffers in pages: None = K)
VARIANTS = {"hbm_smem_slice": (0, 1), "hbm_vmem_slice": (0, 1),
            "hbm_smem_full": (1, None), "hbm_vmem_full": (1, None),
            "vmem_smem": (2, 2), "smem_1d": (0, 1)}
MODES = ("pipelined", "manual")
STAGES = (1, 2, 3, 4)
SCHEDULES = ("var2", "min", "seeded", "ordered")

counter_var = LaunchCounter()
counter_pipelined = LaunchCounter()
counter_manual = LaunchCounter()
counter_ladder = LaunchCounter()


def make_pages(K: int, R: int, device="cuda", fill: str = "arange"):
    """(K, R, 128) float32 pages. fill "arange": 0, 1, 2, ... (the TPU
    probes' input; exact up to 2^24 elements); "small": integers 0..7 by a
    multiplicative hash of the index, for exact sums of whole pages."""
    dev = resolve(device)
    n = K * R * LANES
    i = torch.arange(n, dtype=torch.int64, device=dev)
    if fill == "arange":
        if n > 1 << 24:
            raise ValueError(f"make_pages: an arange of {n} elements is not "
                             "exact in float32 (2^24); use fill='small'")
    elif fill == "small":
        i = ((i * 2654435761) >> 13) & 7
    else:
        raise ValueError(f"make_pages: unknown fill {fill!r}")
    return i.to(torch.float32).view(K, R, LANES)


def probe_schedule(kind: str, B: int, P: int, K: int, device="cuda",
                   seed: int = 0):
    """(B * P,) int32 schedule. "var2": tools/exp_dma_var2.py's, entry p of
    block b is (b + 1 + 2 p) % K; "min": tools/exp_dma_min.py's, entry 0 is
    b % K and the others (b + p) % K for even b, -1 (no page) for odd b;
    "seeded": uniform in [0, K) from `seed`; "ordered": P of the K pages
    drawn from `seed` without repeats, ascending in every block."""
    dev = resolve(device)
    b = np.arange(B)[:, None]
    p = np.arange(P)[None, :]
    if kind == "var2":
        s = (b + 1 + 2 * p) % K
    elif kind == "min":
        s = np.where((p == 0) | (b % 2 == 0), (b + p) % K, -1)
    elif kind == "seeded":
        s = np.random.default_rng(seed).integers(0, K, (B, P))
    elif kind == "ordered":
        if P > K:
            raise ValueError(f"probe_schedule: {P} entries without repeats "
                             f"need at least as many pages, got {K}")
        s = np.sort(np.random.default_rng(seed).random((B, K))
                    .argsort(axis=1)[:, :P], axis=1)
    else:
        raise ValueError(f"probe_schedule: unknown kind {kind!r}; one of "
                         f"{SCHEDULES}")
    return torch.as_tensor(s.reshape(-1).astype(np.int32), device=dev)


def _page_value(pages, reduce):
    """(K,): the number each page adds when it is staged."""
    if reduce == "first":
        return pages[:, 0, 0]
    return pages.sum(dim=(1, 2))


def _tiles(x, v):
    """x (B * 8, 128) plus v (B,), one number a tile."""
    return x + v.repeat_interleave(TILE_ROWS)[:, None]


def dma_var_plain(pages, x, reduce: str = "first"):
    """Plain version of every dma_var variant: they differ only in how
    page 2 reaches shared memory."""
    return x + _page_value(pages, reduce)[VAR_PAGE]


def dma_sched_plain(pages, x, sched, P: int, reduce: str = "first"):
    """Plain version of both dma_sched modes."""
    return _tiles(x, _page_value(pages, reduce)[sched.view(-1, P).long()]
                  .sum(dim=1))


def dma_ladder_plain(pages, x, sched, P: int, stage: int,
                     reduce: str = "first"):
    s = sched.view(-1, P).long()
    valid = s >= 0
    kc = s.clamp(min=0)
    add = valid if stage >= 3 else valid & (torch.arange(
        P, device=s.device) == 0)
    v = torch.where(add, _page_value(pages, reduce)[kc], 0.0).sum(dim=1)
    if stage >= 4:
        # the scalar reads scr[i, 1] * 0 of every valid page
        zero = (pages[:, :3, 1] * 0.0).sum(dim=1)
        v = v + torch.where(valid, zero[kc], 0.0).sum(dim=1)
    return _tiles(x, v)


def _check(what, pages, x, n_tiles, buffers, copy, reduce, sched=None,
           P=None):
    """Validates a probe's arguments; returns (device type, K, R, bytes of
    dynamic shared memory)."""
    if copy not in COPIES:
        raise ValueError(f"{what}: unknown copy path {copy!r}; one of "
                         f"{COPIES}")
    if reduce not in REDUCES:
        raise ValueError(f"{what}: unknown reduce {reduce!r}; one of "
                         f"{REDUCES}")
    if pages.dim() != 3 or pages.shape[2] != LANES:
        raise ValueError(f"{what}: pages must be (K, R, {LANES})")
    K, R = pages.shape[:2]
    if x.shape != (n_tiles * TILE_ROWS, LANES):
        raise ValueError(f"{what}: x must be ({n_tiles * TILE_ROWS}, "
                         f"{LANES}), got {tuple(x.shape)}")
    tensors = [pages, x] + ([] if sched is None else [sched])
    devices = {t.device.type for t in tensors}
    if devices not in ({"cpu"}, {"cuda"}):
        raise ValueError(f"{what}: tensors on mixed devices {devices}")
    for t in (pages, x):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{what}: float32 contiguous tensors only")
    if sched is not None:
        if sched.dtype != torch.int32 or not sched.is_contiguous() \
                or sched.shape != (n_tiles * P,):
            raise ValueError(f"{what}: sched must be ({n_tiles * P},) int32")
    n_buf = K if buffers is None else buffers
    smem = n_buf * R * ROW_BYTES
    if smem + STATIC_BYTES > SMEM_BYTES:
        raise ValueError(
            f"{what}: {n_buf} buffer(s) of {R} rows x {ROW_BYTES} B = {smem} "
            f"B, with {STATIC_BYTES} B of static shared memory, do not fit a "
            f"block's {SMEM_BYTES} B of shared memory (one buffer takes at "
            f"most {(SMEM_BYTES - STATIC_BYTES) // ROW_BYTES} rows, two at "
            f"most {(SMEM_BYTES - STATIC_BYTES) // (2 * ROW_BYTES)} each)")
    return devices.pop(), K, R, smem


def _check_entries(what, sched, lo, K):
    """On the CPU, where it costs no sync: schedule entries name pages
    (the kernels trap on one that does not)."""
    if sched.numel() and (int(sched.max()) >= K or
                          (lo is not None and int(sched.min()) < lo)):
        raise ValueError(f"{what}: a schedule entry is outside the {K} "
                         "pages")


def _stream():
    import ctypes
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def dma_var(pages, x, variant: str, copy: str = "ld", reduce: str = "first"):
    """out (8, 128) = x + the number of page 2, staged as `variant` says.
    pages (K, R, 128), or (K, R * 128) for `smem_1d`. Both blocks of the
    grid (the TPU probe's two steps) write the whole tile."""
    if variant not in VARIANTS:
        raise ValueError(f"dma_var: unknown variant {variant!r}; one of "
                         f"{tuple(VARIANTS)}")
    if variant == "smem_1d":
        if pages.dim() != 2 or pages.shape[1] % LANES:
            raise ValueError("dma_var: smem_1d takes pages (K, R * 128)")
        pages = pages.view(pages.shape[0], -1, LANES)
    switch, buffers = VARIANTS[variant]
    dev, K, R, smem = _check("dma_var", pages, x, 1, buffers, copy, reduce)
    if K <= VAR_PAGE:
        raise ValueError(f"dma_var: needs more than {VAR_PAGE} pages")
    if dev == "cpu":
        counter_var.plain += 1
        return dma_var_plain(pages, x, reduce)
    from . import _build
    lib = _build.load_library("dma_probe")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.dma_var_launch(
            pages.data_ptr(), x.data_ptr(), out.data_ptr(), K, R, VAR_PAGE,
            switch, COPIES.index(copy), REDUCES.index(reduce), VAR_BLOCKS, smem,
            _stream())
    _build.check(err, "dma_var")
    counter_var.launches += 1
    return out


def dma_sched(pages, x, sched, P: int, mode: str = "pipelined",
              copy: str = "ld", reduce: str = "first"):
    """out (B * 8, 128): block b's tile of x plus the numbers of the pages
    sched[b * P : (b + 1) * P]. sched (B * P,) int32 in [0, K)."""
    if mode not in MODES:
        raise ValueError(f"dma_sched: unknown mode {mode!r}; one of {MODES}")
    pipelined = mode == "pipelined"
    if P < 1 or sched.numel() % P:
        raise ValueError("dma_sched: sched must hold B rows of P >= 1")
    B = sched.numel() // P
    dev, K, R, smem = _check(f"dma_sched ({mode})", pages, x, B,
                             2 if pipelined else 1, copy, reduce, sched, P)
    counter = counter_pipelined if pipelined else counter_manual
    if dev == "cpu":
        _check_entries("dma_sched", sched, 0, K)
        counter.plain += 1
        return dma_sched_plain(pages, x, sched, P, reduce)
    from . import _build
    lib = _build.load_library("dma_probe")
    out = torch.empty_like(x)
    if B == 0:
        return out
    with torch.cuda.device(x.device):
        err = lib.dma_sched_launch(
            pages.data_ptr(), sched.data_ptr(), x.data_ptr(), out.data_ptr(),
            K, R, B, P, int(pipelined), COPIES.index(copy),
            REDUCES.index(reduce), smem, _stream())
    _build.check(err, f"dma_sched ({mode})")
    counter.launches += 1
    return out


def dma_ladder(pages, x, sched, P: int, stage: int, copy: str = "ld",
               reduce: str = "first"):
    """out (B * 8, 128): the ladder's stage `stage` (1..4) over sched
    (B * P,) int32, entries < 0 meaning no page."""
    if stage not in STAGES:
        raise ValueError(f"dma_ladder: unknown stage {stage!r}; one of "
                         f"{STAGES}")
    if P < 1 or sched.numel() % P:
        raise ValueError("dma_ladder: sched must hold B rows of P >= 1")
    B = sched.numel() // P
    dev, K, R, smem = _check("dma_ladder", pages, x, B, 1, copy, reduce,
                             sched, P)
    if stage >= 4 and R < 3:
        raise ValueError("dma_ladder: stage 4 reads rows 0..2 of a page")
    if dev == "cpu":
        _check_entries("dma_ladder", sched, None, K)
        counter_ladder.plain += 1
        return dma_ladder_plain(pages, x, sched, P, stage, reduce)
    from . import _build
    lib = _build.load_library("dma_probe")
    out = torch.empty_like(x)
    if B == 0:
        return out
    with torch.cuda.device(x.device):
        err = lib.dma_ladder_launch(
            pages.data_ptr(), sched.data_ptr(), x.data_ptr(), out.data_ptr(),
            K, R, B, P, stage, COPIES.index(copy), REDUCES.index(reduce),
            smem, _stream())
    _build.check(err, "dma_ladder")
    counter_ladder.launches += 1
    return out
