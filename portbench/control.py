"""The control of the check: the plain reference put in the program's
place and computed in bfloat16 (checks.BF16), the precision below the
configuration's float32, compared with the float32 reference on the same
image and with pbrt-v4's render (the golden), at the cell's own size. It
has to read far above a limit. Each line also gives the float32
reference's own golden_mrse.
With --fault, the float32 reference with that fault planted
(portbench/faults.py) takes the control's place.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 \
        [--fault unchanged|half|altered] [--device cuda]

Prints one JSON line a seed: the numbers compared beside the limits.
The benchmark's own runs do not run it."""
import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def readings(cell, seed: int, device: str, fault: str = None) -> dict:
    """The numbers compared for the control's image of seed `seed`: the
    rows that a run's check would render (all, or the workload's sample),
    against the float32 reference's; where the cell has a golden, the
    control's own render of the film that the golden shows, against it
    (rendered apart where the rows are a sample)."""
    from portbench import checks, faults, spec
    from portbench.refport import film
    from portbench.refport.integrators import path
    wl = cell.workload
    ref = checks.Reference(spec.scene_text(cell, wl), cell.scene_path.parent,
                           wl, device)
    s = checks.image_seed(seed, 0)
    rows = checks.sample_rows(seed, 0, wl.height, wl.reference_rows)
    t = time.perf_counter()
    want = ref.render(s, rows)
    t_ref = time.perf_counter() - t
    golden = checks.read_golden(wl.golden) if wl.golden else None
    x0, y0, x1, y1 = wl.golden_window or (0, 0, wl.width, wl.height)
    with faults.planted(fault, film, path) if fault else checks.BF16():
        low = checks.Reference(spec.scene_text(cell, wl),
                               cell.scene_path.parent, wl, device)
        t = time.perf_counter()
        got = low.render(s, rows)
        shown = None
        if golden is not None and rows is not None:
            shown = low.render(s, np.arange(y0, y1), range(x0, x1))
    t_low = time.perf_counter() - t
    numbers = checks.compare(got, want)
    ref_golden = None
    if golden is not None:
        if shown is None:
            shown = got[y0:y1, x0:x1]
            ref_golden = checks.golden_mrse(
                checks.resample(want, (x0, y0, x1, y1), golden.shape[:2]),
                golden, wl.golden_trim)
        numbers["golden_mrse"] = checks.golden_mrse(
            checks.resample(shown, (0, 0, x1 - x0, y1 - y0),
                            golden.shape[:2]), golden, wl.golden_trim) \
            if np.isfinite(shown).all() else float("inf")
    return dict(cell=cell.name, seed=seed, fault=fault, image_seed=s,
                rows=None if rows is None else len(rows), numbers=numbers,
                reference_golden_mrse=ref_golden, limits=wl.limits,
                reference_s=t_ref, control_s=t_low,
                nonfinite_pixels=int((~np.isfinite(got)).sum()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", choices=("unchanged", "half", "altered"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from portbench import spec
    cell = spec.load_cell(args.workload)
    for seed in args.seeds:
        print(json.dumps(readings(cell, seed, args.device, args.fault)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
