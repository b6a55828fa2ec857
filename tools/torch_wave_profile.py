#!/usr/bin/env python3
"""Where the renders of the PyTorch + CUDA port spend their time, stage by
stage, from the program's own spans (pbrt_tpu_torch/spans.py).

Run from the repository root on a machine with an NVIDIA GPU:
    python3 tools/torch_wave_profile.py [--scene NAME] [--renders N]
    (NAME: cornell, meshfield, instances, hair, envlit, manylight,
    manylight16k, killeroo, plytex, volume or all, the default)

cornell: the main path, 400x400, 64 spp, max depth 5, on the megakernel.
The others are the scene files under scenes/ at their own size and spp
(hair: tools/hair_scene.py's 8,192-strand patch at 400x400, 16 spp), at
max depth meshfield 4, instances 3, hair 5, envlit 5, manylight 3,
manylight16k 3, killeroo 5, plytex 5, volume 6: the general wave on the
triangle, BVH8, two-level or curve kernel, and for volume the volumetric
wave. (pbrt_tpu_torch only; no jax.)

Prints the card's name and power limit, then for each scene its set-up
(parse and build) time, one warm-up render, N renders in the spans'
default "host" mode (paths/s each), and N renders in "device" mode, whose
spans.report() gives each stage's calls, host ms and device ms (CUDA
events around every span) in total and a wave, and the counters: live
lanes a depth (lanes.alive[d]), shadow rays, the flight loops' calls and
steps, the kernels' launches. Host stamps time the launches; where the
host sets the pace they are the stage's cost, and the device ms say what
the card ran. The last line is one JSON object with these numbers.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

DEPTHS = dict(cornell=5, meshfield=4, instances=3, hair=5, envlit=5,
              manylight=3, manylight16k=3, killeroo=5, plytex=5, volume=6)


def load(name, dev):
    """(scene, camera, sampler, max depth) of a scene, and its set-up
    seconds."""
    from pbrt_tpu_torch import samplers as smp
    from pbrt_tpu_torch import scenes
    from pbrt_tpu_torch.scene import parser
    t = time.perf_counter()
    if name == "cornell":
        scene, cam = scenes.make_cornell_box(400, 400, device=dev)
        sampler = smp.make_sampler("zsobol", spp=64,
                                   full_resolution=(400, 400))
    else:
        path = ROOT / "scenes" / f"{name}.pbrt"
        if name == "hair":
            from pbrt_tpu_torch.ops import _build
            sys.path.insert(0, str(ROOT / "tools"))
            from hair_scene import hair_scene_text
            _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
            path = _build.BUILD_DIR / "hair.pbrt"
            path.write_text(hair_scene_text(8192, 0, 400, 400, 16))
        desc = parser.parse_file(path, device=dev)
        scene, cam, sampler = desc.scene, desc.camera, desc.sampler
    return (scene, cam, sampler), time.perf_counter() - t


def profile(name, dev, renders):
    from pbrt_tpu_torch import spans
    from pbrt_tpu_torch.integrators import path as path_mod
    from pbrt_tpu_torch.integrators import render
    (scene, cam, sampler), setup_s = load(name, dev)
    opts = path_mod.PathOptions(max_depth=DEPTHS[name])

    def one():
        return render.render(scene, cam, sampler=sampler, device=dev,
                             opts=opts)[1]["paths_per_sec"]

    one()   # builds the kernels, grows the allocator
    rates = [one() for _ in range(renders)]
    spans.configure("device")
    try:
        for _ in range(renders):
            one()
    finally:
        spans.configure("host")
    recs = spans.images()[-renders:]
    waves = sum(r["waves"] for r in recs)
    print(f"{name}: set-up {setup_s:.2f} s; {sampler.spp} spp, "
          f"{recs[0]['lanes_per_wave']} lanes a wave, {recs[0]['waves']} "
          f"waves an image; host mode paths/s {rates}", flush=True)
    print(spans.report(recs), flush=True)
    stages = {k: dict(host_ms_per_wave=sum(
        r["spans"][k]["ns"] for r in recs if k in r["spans"]) * 1e-6 / waves,
        device_ms_per_wave=sum(
            r["spans"][k].get("device_ns", 0) for r in recs
            if k in r["spans"]) * 1e-6 / waves)
        for k in sorted({k for r in recs for k in r["spans"]})}
    counters = {}
    for r in recs:
        for k, v in r["counters"].items():
            counters[k] = counters.get(k, 0) + v / len(recs)
    return dict(setup_s=setup_s, host_paths_per_sec=rates, stages=stages,
                counters_per_image=counters)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scene", choices=(*DEPTHS, "all"), default="all")
    ap.add_argument("--renders", type=int, default=3)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("torch_wave_profile: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "--id=0"],
                          capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda", 0)
    out = dict(card=card)
    for name in DEPTHS:
        if args.scene in (name, "all"):
            out[name] = profile(name, dev, args.renders)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
