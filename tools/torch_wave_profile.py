#!/usr/bin/env python3
"""Where one wave of the PyTorch + CUDA port's main path spends its time.

Run from the repository root on a machine with an NVIDIA GPU:
    python3 tools/torch_wave_profile.py

Cornell box 400x400, 64 spp, max depth 5 (pbrt_tpu_torch only; no jax).
Prints the card's name and power limit, then
  1. each stage of one 160,000-lane wave timed on its own with a
     synchronize around it (median of --reps waves after one warm-up):
     the wavelength sample at zsobol dim 5, sample_visible_wavelengths,
     megawave.prepare_full, the megakernel, the sensor projection and the
     film add;
  2. --renders full renders (64 spp), unprofiled: paths/s of each;
  3. a render of --profiled-spp samples under torch.profiler: wall time,
     the sum of device self times and their ratio (the device busy share;
     the profiler slows the host side, so the share without it is higher).
The last line is one JSON object with these numbers.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--renders", type=int, default=5)
    ap.add_argument("--profiled-spp", type=int, default=8)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("torch_wave_profile: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pbrt_tpu_torch import film as film_mod
    from pbrt_tpu_torch import filters as flt
    from pbrt_tpu_torch import samplers as smp
    from pbrt_tpu_torch import scenes
    from pbrt_tpu_torch.integrators import render
    from pbrt_tpu_torch.ops import megawave
    from pbrt_tpu_torch.utils import spectrum as spc

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "--id=0"],
                          capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda", 0)
    W = H = 400
    scene, cam = scenes.make_cornell_box(W, H, device=dev)
    render.render(scene, cam, spp=4, device=dev)   # builds the kernels
    sampler = smp.make_sampler("zsobol", spp=64, full_resolution=(W, H))
    filt = flt.make_filter("gaussian")
    sensor = film_mod.make_pixel_sensor()
    film = film_mod.make_film(W, H, dev)
    pix = torch.arange(W * H, device=dev)
    si = torch.zeros_like(pix)

    def stage(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, (time.perf_counter() - t) * 1e3

    names = ("sample_1d_lambda", "sample_visible_wavelengths",
             "prepare_full", "megakernel", "sensor_to_sensor_rgb",
             "add_samples")
    times = {k: [] for k in names}
    for rep in range(args.reps + 1):
        px, py = pix % W, pix // W
        u, t1 = stage(lambda: smp.sample_1d(sampler, px, py, si, 5))
        swl, t2 = stage(lambda: spc.sample_visible_wavelengths(u))
        w, t3 = stage(lambda: megawave.prepare_full(
            scene, sampler, cam, filt, px, py, si, swl.lam, 5, 1))
        out, t4 = stage(lambda: megawave.wave_full(w))
        rgb, t5 = stage(lambda: film_mod.sensor_to_sensor_rgb(
            sensor, out[0], swl))
        _, t6 = stage(lambda: film_mod.add_samples(film, pix, rgb, out[1],
                                                   identity=True))
        if rep:   # the first wave is the warm-up
            for k, v in zip(names, (t1, t2, t3, t4, t5, t6)):
                times[k].append(v)
    stage_ms = {k: statistics.median(v) for k, v in times.items()}
    print(f"stage ms, median of {args.reps} waves of {W * H} lanes: "
          f"{json.dumps(stage_ms)}", flush=True)

    renders = [render.render(scene, cam, spp=64, device=dev)[1]
               ["paths_per_sec"] for _ in range(args.renders)]
    print(f"renders, 64 spp, paths/s: {renders}", flush=True)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        render.render(scene, cam, spp=args.profiled_spp, device=dev)
        wall_ms = (time.perf_counter() - t) * 1e3
    ka = prof.key_averages()
    # the device's own events only: an aten op's row repeats the time of
    # the kernels it launched, so summing every row counts it twice
    dev_ms = sum(e.self_device_time_total for e in ka
                 if e.device_type == DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False)) / 1e3
    print(f"profiled render, {args.profiled_spp} spp: wall {wall_ms:.3f} ms, "
          f"device self time {dev_ms:.3f} ms, busy share "
          f"{dev_ms / wall_ms:.4f}", flush=True)
    print(ka.table(sort_by="self_device_time_total", row_limit=12))
    print(json.dumps(dict(card=card, stage_ms=stage_ms,
                          render_paths_per_sec=renders,
                          profiled_spp=args.profiled_spp,
                          profiled_wall_ms=wall_ms, device_ms=dev_ms,
                          busy_share=dev_ms / wall_ms)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
