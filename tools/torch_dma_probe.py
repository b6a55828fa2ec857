#!/usr/bin/env python3
"""The page-copy probes of the PyTorch + CUDA port (pbrt_tpu_torch only; no
jax): the counterpart of tools/exp_dma_var.py, tools/exp_dma_var2.py and
tools/exp_dma_min.py.

Run from the repository root:
    python3 tools/torch_dma_probe.py --probe var  --variant hbm_vmem_slice
    python3 tools/torch_dma_probe.py --probe var2 --variant blockspec_vmem
    python3 tools/torch_dma_probe.py --probe min  --stage 3
    python3 tools/torch_dma_probe.py --matrix            (needs the card)
--variant and --stage take the TPU tools' names (VAR, STAGE). --copy picks
the global -> shared copy path (ld, cp_async, bulk), --rows the page size
(rows * 512 bytes; 16 is the TPU probes' 8,192 B), --reduce what a staged
page adds (first: its first element, the TPU probes' function; sum: the
sum of all of it). --device defaults to cuda and raises without a card;
with --device cpu the plain versions run.

A probe prints the TPU tool's lines (`value: ... expected: ... OK|WRONG`;
`got: ... exp: ... OK|WRONG`; `result row means: ...` then OK|WRONG), the
expected numbers computed with numpy from the pages and the schedule, and
exits 1 on WRONG.

--matrix times the copy paths at the paged traversal's sizes, one JSON
line a row: K = 420 pages; B = 1,024 blocks of 1,024 threads (2^20 rays /
1,024) with P seeded schedule entries each; copy path x {manual at 16, 298
and 378 rows with P = 20, the forest kernel's raster query with the
traversal taken out: 20,480 copies, 3.96 GB at 378 rows, on a seeded
schedule in any order and, at 298 and 378 rows, on one where every block
walks its pages in ascending order as the forest kernel walks its chunks;
manual and pipelined at 16 and 226 rows with P scaled to the same bytes;
dma_var at its own grid of two blocks, one page each; the ladder's stage 4
on a schedule with empty entries, at 16, 298 and 378 rows} x {reduce
first: the copy alone; sum: the copy and a full read of the page}. CUDA events around each launch, the median of --reps
after a warm-up; each row's output is held to the plain version's bit for
bit; the pipelined probe's ld rows run unpipelined (plain loads have no
asynchronous form) and say so. bound_ms is the bytes staged over 3.35 TB/s, the device memory's
rate: 420 pages of 298 or 378 rows (64 and 81 MB) exceed the 50 MB L2, the
TPU probes' 64 KB of pages and dma_var's one page stay in it. library_ms
is torch.index_select(pages, 0, schedule), the one PyTorch call that moves
the same pages; it writes them back to device memory, so it moves twice
the bytes.
"""
import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

PEAK_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
VAR2 = {"blockspec_vmem": "pipelined", "blockspec_smem": "pipelined",
        "ds_smem": "manual", "ds_vmem": "manual"}
# the TPU tools' sizes
K_PROBE, R_PROBE, B_PROBE, P_PROBE = 8, 16, 4, 2
# the matrix: the terrain's forest (378 rows) and chunked (298) pages, the
# largest page two buffers hold (226) and the TPU probes' (16)
K_MATRIX, B_MATRIX, P_MATRIX = 420, 1024, 20
R_FOREST, R_CHUNKED, R_TWO, R_SMALL = 378, 298, 226, 16


def configurations():
    """The 14 configurations of the TPU tools: (probe, variant or stage)."""
    from pbrt_tpu_torch.ops import dma_probe as dp
    return ([("var", v) for v in dp.VARIANTS] + [("var2", v) for v in VAR2]
            + [("min", s) for s in dp.STAGES])


def probe_inputs(probe, rows=R_PROBE, device="cuda", fill="arange"):
    """(pages, x, schedule or None) of one probe at the TPU tool's grid."""
    import torch
    from pbrt_tpu_torch.ops import dma_probe as dp
    if probe not in ("var", "var2", "min"):
        raise ValueError(f"unknown probe {probe!r}; one of var, var2, min")
    pages = dp.make_pages(K_PROBE, rows, device, fill)
    if probe == "var":
        return pages, torch.zeros((8, 128), device=pages.device), None
    x = torch.zeros((B_PROBE * 8, 128), device=pages.device)
    return pages, x, dp.probe_schedule(probe, B_PROBE, P_PROBE, K_PROBE,
                                       device)


def run_probe(probe, which, copy="ld", rows=R_PROBE, reduce="first",
              device="cuda", fill="arange"):
    """One probe at the TPU tool's grid, through its wrapper. Returns (out
    tensor, got, expected: numpy arrays of one number a block, the expected
    ones from numpy)."""
    import numpy as np
    from pbrt_tpu_torch.ops import dma_probe as dp
    pages, x, sched = probe_inputs(probe, rows, device, fill)
    host = pages.cpu().numpy().astype(np.float64)
    val = host[:, 0, 0] if reduce == "first" else host.sum(axis=(1, 2))
    if probe == "var":
        arg = pages.view(K_PROBE, -1) if which == "smem_1d" else pages
        out = dp.dma_var(arg, x, which, copy=copy, reduce=reduce)
        exp = val[[dp.VAR_PAGE]]
    else:
        s = sched.cpu().numpy().reshape(B_PROBE, P_PROBE)
        if probe == "var2":
            if which not in VAR2:
                raise ValueError(f"unknown var2 variant {which!r}; one of "
                                 f"{tuple(VAR2)}")
            out = dp.dma_sched(pages, x, sched, P_PROBE, mode=VAR2[which],
                               copy=copy, reduce=reduce)
            exp = val[s].sum(axis=1)
        else:
            out = dp.dma_ladder(pages, x, sched, P_PROBE, int(which),
                                copy=copy, reduce=reduce)
            add = (s >= 0) if int(which) >= 3 else \
                (s >= 0) & (np.arange(P_PROBE) == 0)
            exp = np.where(add, val[np.maximum(s, 0)], 0.0).sum(axis=1)
    got = out.cpu().numpy().reshape(len(exp), -1)
    return out, got, exp.astype(np.float32)


def run_plain(probe, which, rows=R_PROBE, reduce="first", device="cuda",
              fill="arange"):
    """The plain version's output on run_probe's inputs."""
    from pbrt_tpu_torch.ops import dma_probe as dp
    pages, x, sched = probe_inputs(probe, rows, device, fill)
    if probe == "var":
        return dp.dma_var_plain(pages, x, reduce)
    if probe == "var2":
        return dp.dma_sched_plain(pages, x, sched, P_PROBE, reduce)
    return dp.dma_ladder_plain(pages, x, sched, P_PROBE, int(which), reduce)


def print_probe(probe, which, got, exp, device, copy, reduce, rows):
    """The TPU tool's lines. Returns True on OK."""
    import numpy as np
    ok = bool((got == exp[:, None]).all())
    word = "OK" if ok else "WRONG"
    label = "stage" if probe == "min" else "var"
    print(f"device: {device} {label}: {which} copy: {copy} reduce: "
          f"{reduce} rows: {rows}", flush=True)
    if probe == "var":
        print("value:", float(got[0, 0]), "expected:", float(exp[0]), word,
              flush=True)
    elif probe == "var2":
        print("got:", got[:, 0], "exp:", exp, word, flush=True)
    else:
        print("result row means:", got.mean(axis=1), flush=True)
        print(word, flush=True)
    return ok


def median_ms(fn, reps, warmup=2):
    """(median milliseconds of one call of fn, CUDA events around each of
    reps calls after warmup calls; fn's last result)."""
    import torch
    for _ in range(warmup):
        out = fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        z.record()
        z.synchronize()
        times.append(a.elapsed_time(z))
    return statistics.median(times), out


def matrix_cases():
    """(probe, mode, rows, entries a block, schedule): P_MATRIX at 378
    rows, scaled to the same bytes where a row says so. Schedule "seeded":
    uniform pages in any order; "ordered": every block walks its pages in
    ascending order, as the forest kernel walks its chunks; "min": the
    ladder's, odd blocks empty after entry 0; "fixed": dma_var's page 2."""
    P = P_MATRIX

    def scaled(r):
        return P * R_FOREST // r
    return [("sched", "manual", R_SMALL, P, "seeded"),
            ("sched", "manual", R_CHUNKED, P, "seeded"),
            ("sched", "manual", R_FOREST, P, "seeded"),
            ("sched", "manual", R_CHUNKED, P, "ordered"),
            ("sched", "manual", R_FOREST, P, "ordered"),
            ("sched", "manual", R_SMALL, scaled(R_SMALL), "seeded"),
            ("sched", "pipelined", R_SMALL, scaled(R_SMALL), "seeded"),
            ("sched", "manual", R_TWO, scaled(R_TWO), "seeded"),
            ("sched", "pipelined", R_TWO, scaled(R_TWO), "seeded"),
            ("var", "hbm_vmem_slice", R_SMALL, 1, "fixed"),
            ("var", "hbm_vmem_slice", R_CHUNKED, 1, "fixed"),
            ("var", "hbm_vmem_slice", R_FOREST, 1, "fixed"),
            ("ladder", "stage4", R_SMALL, P, "min"),
            ("ladder", "stage4", R_CHUNKED, P, "min"),
            ("ladder", "stage4", R_FOREST, P, "min")]


def run_matrix(device="cuda", reps=10, emit=print):
    """The timed matrix; emits the card's line, then one JSON line a row,
    and returns the rows."""
    import torch
    from pbrt_tpu_torch.device import resolve
    from pbrt_tpu_torch.ops import dma_probe as dp
    dev = resolve(device)
    if dev.type != "cuda":
        raise RuntimeError("the timed matrix needs the card: a time from a "
                           "CPU run is not a device time")
    emit(f"card: {card_line()}")
    K, B = K_MATRIX, B_MATRIX
    rows_out = []
    pages_of = {}
    for probe, mode, R, Pc, kind in matrix_cases():
        if R not in pages_of:
            pages_of[R] = dp.make_pages(K, R, dev, fill="small")
        pages = pages_of[R]
        n_tiles = 1 if probe == "var" else B
        x = torch.zeros((n_tiles * 8, 128), device=dev)
        if probe == "var":
            # the two blocks of its grid stage page 2 each
            sched = torch.full((dp.VAR_BLOCKS,), dp.VAR_PAGE,
                               dtype=torch.int32, device=dev)
        else:
            sched = dp.probe_schedule(kind, B, Pc, K, dev, seed=R)
        copies = int((sched >= 0).sum())
        staged = copies * R * dp.ROW_BYTES
        moved = sched.clamp(min=0).long()
        lib_ms, _ = median_ms(
            lambda: torch.index_select(pages, 0, moved[sched >= 0]), reps)
        for reduce in dp.REDUCES:
            if probe == "var":
                def plain():
                    return dp.dma_var_plain(pages, x, reduce)
            elif probe == "ladder":
                def plain():
                    return dp.dma_ladder_plain(pages, x, sched, Pc, 4,
                                               reduce)
            else:
                def plain():
                    return dp.dma_sched_plain(pages, x, sched, Pc, reduce)
            plain_ms, want = median_ms(plain, 3, warmup=1)
            for copy in dp.COPIES:
                if probe == "var":
                    def kernel():
                        return dp.dma_var(pages, x, mode, copy=copy,
                                          reduce=reduce)
                elif probe == "ladder":
                    def kernel():
                        return dp.dma_ladder(pages, x, sched, Pc, 4,
                                             copy=copy, reduce=reduce)
                else:
                    def kernel():
                        return dp.dma_sched(pages, x, sched, Pc, mode=mode,
                                            copy=copy, reduce=reduce)
                ms, got = median_ms(kernel, reps)
                row = dict(probe=probe, mode=mode, copy=copy, reduce=reduce,
                           rows=R, page_bytes=R * dp.ROW_BYTES, K=K,
                           B=n_tiles, P=Pc, schedule=kind, copies=copies, staged_bytes=staged, ms=ms,
                           gb_per_s=staged / ms / 1e6,
                           bound_ms=staged / PEAK_BYTES_PER_S * 1e3,
                           equals_plain=bool(torch.equal(got, want)),
                           plain_ms=plain_ms, library_ms=lib_ms)
                if mode == "pipelined" and copy == "ld":
                    row["note"] = ("unpipelined: plain loads have no "
                                   "asynchronous form")
                emit(json.dumps(row))
                rows_out.append(row)
    return rows_out


def card_line():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "--id=0"],
                         capture_output=True, text=True, timeout=60)
    return smi.stdout.strip()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--probe", choices=("var", "var2", "min"), default="var")
    ap.add_argument("--variant", default=None,
                    help="var: hbm_smem_slice, hbm_vmem_slice, hbm_smem_full,"
                    " hbm_vmem_full, vmem_smem, smem_1d; var2: blockspec_vmem,"
                    " blockspec_smem, ds_smem, ds_vmem")
    ap.add_argument("--stage", type=int, default=1, help="min: 1..4")
    ap.add_argument("--copy", default="ld", help="ld, cp_async or bulk")
    ap.add_argument("--rows", type=int, default=R_PROBE)
    ap.add_argument("--reduce", default="first", help="first or sum")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--matrix", action="store_true")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    if args.matrix:
        rows = run_matrix(args.device, reps=args.reps)
        return 0 if all(r["equals_plain"] for r in rows) else 1
    which = args.stage if args.probe == "min" else (
        args.variant or {"var": "hbm_vmem_slice",
                         "var2": "blockspec_vmem"}[args.probe])
    fill = "arange" if args.reduce == "first" else "small"
    _out, got, exp = run_probe(args.probe, which, args.copy, args.rows,
                               args.reduce, args.device, fill)
    ok = print_probe(args.probe, which, got, exp, args.device, args.copy,
                     args.reduce, args.rows)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
