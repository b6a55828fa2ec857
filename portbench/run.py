"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with as many CUDA cards as the
cell asks for. The last line of standard output is one JSON object
(correct, attempted, failed, metrics, device, with --trace 1 breakdown,
and last the numbers compared beside their limits, which also end
standard error). With --trace 0 the metrics are the cell's end-to-end
metrics; with --trace 1 its per-layer metrics, read from a profile of the
window's last image.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
# every cache the program or torch may write, at fixed paths inside the
# checkout, so that only a checkout's first run builds
CACHE_DIRS = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR":
              "torch_extensions", "TORCHINDUCTOR_CACHE_DIR": "inductor",
              "CUDA_CACHE_PATH": "cuda"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = str(BENCH_DIR / ".cache" / sub)
    # one host thread for the host's numerical libraries: the work is the
    # launches from one python thread, and idle pools add jitter
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    sys.path.insert(0, str(BENCH_DIR.parent))
    from portbench import harness, spec

    cell = spec.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}",
              file=sys.stderr)
        return 3
    try:
        result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                             "cuda", T_START)
        harness.guard("before the result")
    except harness.ForbiddenImport as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
