#!/usr/bin/env python3
"""Name the card's idle gaps in one image by the program's own spans.

Run from the repository root on a machine with an NVIDIA GPU:
    python3 tools/span_gaps.py [--workload cornell.1080p] [--seed N]

Sets the benchmark's cell up as portbench does (its scene text through
parser.parse_string, one warm-up image), then renders one image under
torch.profiler (host and device activity). The image's raw spans
(pbrt_tpu_torch.spans.raw_spans) are laid on the trace's clock through
the image record's anchor; the card's busy intervals are the union of its
activities inside the image's render.image span (portbench.tracing's
events_from_profiler, merged, clipped and gaps). Each of the ten longest
idle gaps is named by the innermost span open at its start, with the
chain of spans above it; then the idle time of every gap is summed by
that span. The profiler slows the host's launches, so the gaps are
longer than in an untraced image; their order is what this shows.
(pbrt_tpu_torch only; no jax.)
"""
import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

TOP = 10


def innermost(spans_us, t):
    """Index of the innermost span open at t (the latest started of those
    that hold it), or None."""
    best = None
    for i, (s, e) in enumerate(spans_us):
        if s <= t < e and (best is None or s >= spans_us[best][0]):
            best = i
    return best


def chain(raw, i):
    names = []
    while i is not None:
        names.append(raw[i]["name"])
        i = raw[i]["parent"]
    return " < ".join(names)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="cornell.1080p")
    ap.add_argument("--seed", type=int, default=2 ** 31 + 17)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("span_gaps: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from pbrt_tpu_torch import samplers, spans
    from pbrt_tpu_torch.integrators import path, render
    from pbrt_tpu_torch.scene import parser
    from portbench import checks, spec, tracing

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "--id=0"],
                          capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    cell = spec.load_cell(args.workload)
    wl = cell.workload
    desc = parser.parse_string(spec.scene_text(cell, wl),
                               base_dir=str(cell.scene_path.parent),
                               device="cuda")

    def one(i):
        return render.render(
            desc.scene, desc.camera, wl.spp, device="cuda",
            sampler=samplers.make_sampler(
                "zsobol", wl.spp, checks.image_seed(args.seed, i),
                full_resolution=(wl.width, wl.height)),
            opts=path.PathOptions(max_depth=wl.max_depth,
                                  megakernel=wl.megakernel))

    one(0)
    print(f"untraced image: {one(1)[1]['seconds']:.4f} s of rendering",
          flush=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        one(2)
    record, raw = spans.images()[-1], spans.raw_spans()
    lo = spans.trace_clock_us(record, record["start_ns"])
    hi = spans.trace_clock_us(record, record["end_ns"])
    events = tracing.events_from_profiler(prof)
    dev = [(e.start_us, e.end_us) for e in events if e.device]
    union = tracing.merged(tracing.clipped(dev, lo, hi))
    busy = sum(b - a for a, b in union)
    gaps = tracing.gaps(union, lo, hi)
    spans_us = [(spans.trace_clock_us(record, r["start_ns"]),
                 spans.trace_clock_us(record, r["end_ns"])) for r in raw]
    print(f"{args.workload}, traced image (seq {record['seq']}): "
          f"{(hi - lo) * 1e-3:.3f} ms, the card busy {busy * 1e-3:.3f} ms, "
          f"{len(gaps)} idle gaps, {len(raw)} spans", flush=True)
    print(f"{'idle ms':>10} {'at ms':>10}  innermost span (< its parents)")
    by_span = {}
    named = []
    for a, b in gaps:
        i = innermost(spans_us, a)
        name = raw[i]["name"] if i is not None else "(outside every span)"
        by_span[name] = by_span.get(name, 0.0) + (b - a)
        named.append((b - a, a, i))
    for length, a, i in sorted(named, key=lambda x: -x[0])[:TOP]:
        where = chain(raw, i) if i is not None else "(outside every span)"
        print(f"{length * 1e-3:>10.3f} {(a - lo) * 1e-3:>10.3f}  {where}")
    print("idle ms by innermost span: " + ", ".join(
        f"{k} {v * 1e-3:.3f}" for k, v in
        sorted(by_span.items(), key=lambda kv: -kv[1])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
