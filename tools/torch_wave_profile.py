#!/usr/bin/env python3
"""Where one wave of the PyTorch + CUDA port spends its time.

Run from the repository root on a machine with an NVIDIA GPU:
    python3 tools/torch_wave_profile.py [--scene NAME]  (NAME: cornell,
    meshfield, instances, hair, envlit, manylight, manylight16k, killeroo,
    plytex, volume or all, the default)

cornell: the main path, 400x400, 64 spp, max depth 5, on the megakernel.
meshfield: scenes/meshfield.pbrt, 200x200, 32 spp, max depth 4, on the
general wave and the BVH8 kernel. instances: scenes/instances.pbrt,
200x200, 32 spp, max depth 3, on the general wave and the two-level
kernel. hair: tools/hair_scene.py's 8,192-strand fur patch (524,288 curve
sub-segments, the hair material, 4 triangles), 400x400, 16 spp, max depth
5, on the general wave, the curve kernel and the triangle kernel. envlit:
scenes/envlit.pbrt (an image infinite light, a rough conductor, a smooth
dielectric, 1,538 triangles), 200x200, 64 spp, max depth 5, on the general
wave and the triangle kernel. manylight and manylight16k:
scenes/manylight.pbrt (1,152 emissive triangles of 1,324) and
scenes/manylight16k.pbrt (16,928 of 17,100), 200x200, 32 spp, max depth 3,
on the general wave, the light-BVH sampler and the triangle or the BVH8
kernel. killeroo: scenes/killeroo.pbrt (163,842 triangles, a MIP-mapped
imagemap texture, the sky image light, a rough conductor and a rough
dielectric), 200x200, 32 spp, max depth 5, on the general wave and the
BVH8 kernel. plytex: scenes/plytex.pbrt (killeroo's floor, sky and
materials on blob.ply, 5,122 triangles, and an exact rough dielectric
sphere), 200x200, 64 spp, max depth 5, on the general wave and the BVH8
kernel. volume: scenes/volume.pbrt (a 24^3 uniformgrid medium inside a
12-triangle interface box over a 2-triangle floor, a uniform infinite
light), 200x200, 32 spp, max depth 6, on the volumetric wave
(integrators/volpath.py) and the triangle kernel. (pbrt_tpu_torch only; no
jax.)
Prints the card's name and power limit, then for each scene
  1. the stages of one wave (160,000 lanes), each timed with a synchronize
     around it, median of --reps waves after one warm-up. cornell: the
     wavelength sample at zsobol dim 5, sample_visible_wavelengths,
     megawave.prepare_full, the megakernel, the sensor projection and the
     film add. meshfield and instances: the host-launched sampler
     dimensions, the camera
     (filter sample and pinhole rays), the closest-hit queries
     (scene_core.intersect), the NEE shadow queries (intersect_p), the
     rest of the wave (shading: emission, lights, BSDF, roulette), and
     the film (sensor projection and add); hair also times the hair
     BxDF's evaluations and samples (part of shading) on their own, and
     the curve kernel's launches (CUDA events around
     ops/curves.curves_intersect) inside the closest-hit and the shadow
     queries: the kernel's share of "intersect", the rest being tensor code
     (the triangle query's hit records, the gathered re-test of the winning
     segment, the merge); envlit also times the image light (its Le of
     escaped rays, its pdf and its samples) and the conductor's and
     dielectric's evaluations and samples (parts of shading) on their own,
     and the triangle kernel's launches (CUDA events around
     ops/tri_intersect.tri_intersect) inside the closest-hit and the
     shadow queries; a scene under the bvh light sampler also times the
     light-BVH walks (lightsampler_bvh.sample_bvh_light at each NEE and
     pmf_bvh_light at each emitter hit, tensor code) and a textured one the
     texture lookups (textures.eval_texture, inside shading); on the BVH8
     route the BVH8 kernel's launches (CUDA events around
     ops/bvh8.bvh8_intersect) inside the queries; a scene with media also
     times the free flights (volpath.sample_t_maj), the shadow rays'
     ratio tracking (volpath.transmittance_ratio) and the interface
     queries (scene_core.intersect_interfaces), and prints the flight
     loops' steps per call (volpath.flight_stats): the loop's
     iterations a bounce;
  2. --renders full renders, unprofiled: paths/s of each;
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


def profiled_share(render_fn, label):
    """Device busy share of one render under torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        render_fn()
        wall_ms = (time.perf_counter() - t) * 1e3
    ka = prof.key_averages()
    # the device's own events only: an aten op's row repeats the time of
    # the kernels it launched, so summing every row counts it twice
    dev_ms = sum(e.self_device_time_total for e in ka
                 if e.device_type == DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False)) / 1e3
    print(f"{label}: profiled render wall {wall_ms:.3f} ms, device self "
          f"time {dev_ms:.3f} ms, busy share {dev_ms / wall_ms:.4f}",
          flush=True)
    print(ka.table(sort_by="self_device_time_total", row_limit=12))
    return wall_ms, dev_ms


class StageTimers:
    """Wrap module functions so each call is timed with a synchronize
    around it and added to its stage; nested timed calls count once, in
    the outermost stage."""

    def __init__(self):
        self.ms = {}
        self._depth = 0
        self._saved = []

    def wrap(self, module, name, stage):
        """Time module.name, or the entry module[name] of a dict."""
        import torch
        table = isinstance(module, dict)
        fn = module[name] if table else getattr(module, name)

        def timed(*a, **k):
            if self._depth:
                return fn(*a, **k)
            self._depth += 1
            torch.cuda.synchronize()
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                self.ms[stage] = self.ms.get(stage, 0.0) + \
                    (time.perf_counter() - t) * 1e3
                self._depth -= 1
        self._saved.append((module, name, fn))
        self._set(module, name, timed)

    @staticmethod
    def _set(module, name, fn):
        if isinstance(module, dict):
            module[name] = fn
        else:
            setattr(module, name, fn)

    def wrap_events(self, module, name, key_of):
        """Bracket every call of module.name with CUDA events (no
        synchronize); event_ms() sums them by key_of(args)."""
        import torch
        fn = getattr(module, name)
        self.events = []

        def timed(*a, **k):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            try:
                return fn(*a, **k)
            finally:
                ev[1].record()
                self.events.append((key_of(a), *ev))
        self._saved.append((module, name, fn))
        setattr(module, name, timed)

    def event_ms(self):
        import torch
        torch.cuda.synchronize()
        out = {}
        for key, a, b in self.events:
            out[key] = out.get(key, 0.0) + a.elapsed_time(b)
        return out

    def restore(self):
        for module, name, fn in reversed(self._saved):
            self._set(module, name, fn)
        self._saved.clear()


def profile_parsed(args, dev, name, max_depth, path=None):
    """Stage times, renders and busy share of a parsed scene's general
    wave (path, by default scenes/<name>.pbrt, at its own size and spp)."""
    import torch
    from pbrt_tpu_torch import bxdfs
    from pbrt_tpu_torch import cameras as cam_mod
    from pbrt_tpu_torch import film as film_mod
    from pbrt_tpu_torch import filters as flt
    from pbrt_tpu_torch import lightsampler_bvh as lbvh
    from pbrt_tpu_torch import lights as lgt
    from pbrt_tpu_torch import samplers as smp
    from pbrt_tpu_torch import scene_core as sc
    from pbrt_tpu_torch import textures as tex_mod
    from pbrt_tpu_torch.integrators import path as path_mod
    from pbrt_tpu_torch.integrators import render
    from pbrt_tpu_torch.integrators import volpath
    from pbrt_tpu_torch.ops import bvh8
    from pbrt_tpu_torch.ops import curves as crv
    from pbrt_tpu_torch.ops import tri_intersect as ti
    from pbrt_tpu_torch.scene import parser

    root = Path(__file__).resolve().parent.parent
    t = time.perf_counter()
    desc = parser.parse_file(path or root / "scenes" / f"{name}.pbrt",
                             device=dev)
    setup_s = time.perf_counter() - t
    scene, cam, sampler = desc.scene, desc.camera, desc.sampler
    opts = path_mod.PathOptions(max_depth=max_depth)
    W, H = cam.width, cam.height
    render.render(scene, cam, sampler=sampler, device=dev, opts=opts)
    filt = flt.make_filter("gaussian")
    sensor = film_mod.make_pixel_sensor()
    film = film_mod.make_film(W, H, dev)
    m = 1     # sample indices per wave (render.py's rule)
    while m * 2 * W * H <= render.MAX_WAVE_LANES and \
            sampler.spp % (m * 2) == 0:
        m *= 2
    pix = torch.arange(W * H, device=dev).repeat(m)
    si = torch.arange(W * H * m, device=dev) // (W * H)
    hair = bxdfs.BXDF_HAIR in scene.bxdf_tags
    env = scene.env is not None
    specular = [t for t in (bxdfs.BXDF_CONDUCTOR, bxdfs.BXDF_DIELECTRIC)
                if t in scene.bxdf_tags]
    light_bvh = scene.light_sampler.kind == lbvh.LS_BVH
    # the kernel whose launches are timed inside the queries: the curve
    # kernel, else the triangle kernel on the brute-force route or the
    # BVH8 kernel on its route
    tri_route = not scene.has_curves and scene.tri_pallas is not None
    b8_route = not scene.has_curves and scene.bvh8 is not None
    kernel_names = ("curve kernel, closest hit", "curve kernel, any hit") \
        if scene.has_curves else (
            ("triangle kernel, closest hit", "triangle kernel, any hit")
            if tri_route else (
                ("BVH8 kernel, closest hit", "BVH8 kernel, any hit")
                if b8_route else ()))
    names = ("sampler dims", "camera", "intersect", "NEE shadow", "shading",
             "film") + (("hair BxDF",) if hair else ()) + \
        (("image light",) if env else ()) + \
        (("conductor, dielectric",) if specular else ()) + \
        (("light BVH",) if light_bvh else ()) + \
        (("textures",) if scene.has_textures else ()) + \
        (("flight", "shadow transmittance") if scene.has_media else ()) + \
        (("interfaces",) if scene.has_medium_interfaces else ()) + \
        kernel_names
    wave = render.wave_module(scene)
    per_wave = {k: [] for k in names}
    flights = []
    for rep in range(args.reps + 1):
        timers = StageTimers()
        for fn in ("sample_1d", "sample_2d", "sample_pixel_2d"):
            timers.wrap(smp, fn, "sampler dims")
        timers.wrap(flt, "sample", "camera")
        timers.wrap(cam_mod, "generate_ray_weighted", "camera")
        timers.wrap(sc, "intersect", "intersect")
        timers.wrap(sc, "intersect_p", "NEE shadow")
        if hair:
            timers.wrap(bxdfs._F_PDF_FNS, bxdfs.BXDF_HAIR, "hair BxDF")
            timers.wrap(bxdfs, "_hair_sample", "hair BxDF")
        if env:
            for fn in ("env_radiance", "env_pdf_li", "env_sample_li"):
                timers.wrap(lgt, fn, "image light")
        for t in specular:
            timers.wrap(bxdfs._F_PDF_FNS, t, "conductor, dielectric")
            timers.wrap(bxdfs, {bxdfs.BXDF_CONDUCTOR: "_conductor_sample",
                                bxdfs.BXDF_DIELECTRIC: "_dielectric_sample"}
                        [t], "conductor, dielectric")
        if light_bvh:
            timers.wrap(lbvh, "sample_bvh_light", "light BVH")
            timers.wrap(lbvh, "pmf_bvh_light", "light BVH")
        if scene.has_textures:
            timers.wrap(tex_mod, "eval_texture", "textures")
        if scene.has_media:
            timers.wrap(volpath, "sample_t_maj", "flight")
            timers.wrap(volpath, "transmittance_ratio",
                        "shadow transmittance")
        if scene.has_medium_interfaces:
            timers.wrap(sc, "intersect_interfaces", "interfaces")
        volpath.flight_stats.update(calls=0, steps=0, shadow_calls=0,
                                    shadow_steps=0)
        if scene.has_curves:
            timers.wrap_events(crv, "curves_intersect",
                               lambda a: kernel_names[bool(a[5])])
        elif tri_route:
            timers.wrap_events(ti, "tri_intersect",
                               lambda a: kernel_names[bool(a[5])])
        elif b8_route:
            timers.wrap_events(bvh8, "bvh8_intersect",
                               lambda a: kernel_names[bool(a[4])])
        try:
            torch.cuda.synchronize()
            t = time.perf_counter()
            L, swl, fw = wave.render_wave(scene, cam, sampler, filt, pix,
                                          si + (m * rep) % sampler.spp, opts)
            torch.cuda.synchronize()
            wave_ms = (time.perf_counter() - t) * 1e3
        finally:
            timers.restore()
        torch.cuda.synchronize()
        t = time.perf_counter()
        rgb = film_mod.sensor_to_sensor_rgb(sensor, L, swl)
        film_mod.add_samples(film, pix, rgb, fw, identity=True)
        torch.cuda.synchronize()
        timers.ms["film"] = (time.perf_counter() - t) * 1e3
        timers.ms["shading"] = wave_ms - sum(
            v for k, v in timers.ms.items() if k != "film")
        if kernel_names:   # inside "intersect" and "NEE shadow"
            timers.ms.update(timers.event_ms())
        if rep:   # the first wave is the warm-up
            for k in names:
                per_wave[k].append(timers.ms.get(k, 0.0))
            flights.append(dict(volpath.flight_stats))
    stage_ms = {k: statistics.median(v) for k, v in per_wave.items()}
    print(f"{name} stage ms, median of {args.reps} waves of {W * H * m} "
          f"lanes: {json.dumps(stage_ms)}; set-up {setup_s:.2f} s",
          flush=True)
    flight = None
    if scene.has_media:
        fs = flights[-1]
        flight = dict(fs, steps_per_flight=fs["steps"] / max(fs["calls"], 1),
                      steps_per_shadow=fs["shadow_steps"]
                      / max(fs["shadow_calls"], 1),
                      share=(stage_ms["flight"]
                             + stage_ms["shadow transmittance"])
                      / sum(v for k, v in stage_ms.items()
                            if k not in kernel_names))
        print(f"{name}: flight loops of the last wave {json.dumps(fs)}: "
              f"{flight['steps_per_flight']:.1f} steps a free flight, "
              f"{flight['steps_per_shadow']:.1f} a shadow ray's (one flight "
              "and one shadow loop a bounce); the two loops are "
              f"{flight['share']:.4f} of the wave", flush=True)
    if hair:
        share = stage_ms["hair BxDF"] / (stage_ms["hair BxDF"]
                                         + stage_ms["shading"])
        print(f"{name}: the hair BxDF is {share:.4f} of shading",
              flush=True)
    if kernel_names:
        k_ms = stage_ms[kernel_names[0]]
        print(f"{name}: the {kernel_names[0].split(',')[0]}'s launches are "
              f"{k_ms:.4f} ms of the "
              f"{stage_ms['intersect']:.4f} ms of \"intersect\" "
              f"({k_ms / stage_ms['intersect']:.4f}; the rest is tensor "
              f"code), and {stage_ms[kernel_names[1]]:.4f} ms of the "
              f"{stage_ms['NEE shadow']:.4f} ms of \"NEE shadow\"",
              flush=True)
    renders = [render.render(scene, cam, sampler=sampler, device=dev,
                             opts=opts)[1]["paths_per_sec"]
               for _ in range(args.renders)]
    print(f"{name} renders, {sampler.spp} spp, paths/s: {renders}",
          flush=True)
    wall_ms, dev_ms = profiled_share(
        lambda: render.render(scene, cam, spp=args.profiled_spp,
                              sampler=smp.make_sampler(
                                  "zsobol", spp=args.profiled_spp,
                                  full_resolution=(W, H)),
                              device=dev, opts=opts),
        f"{name}, {args.profiled_spp} spp")
    return dict(stage_ms=stage_ms, render_paths_per_sec=renders,
                profiled_wall_ms=wall_ms, device_ms=dev_ms,
                busy_share=dev_ms / wall_ms, setup_s=setup_s, flight=flight)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scene", choices=("cornell", "meshfield", "instances",
                                        "hair", "envlit", "manylight",
                                        "manylight16k", "killeroo",
                                        "plytex", "volume", "all"),
                    default="all")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--renders", type=int, default=5)
    ap.add_argument("--profiled-spp", type=int, default=8)
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
    if args.scene in ("cornell", "all"):
        out["cornell"] = profile_cornell(args, dev)
    for name, depth in (("meshfield", 4), ("instances", 3)):
        if args.scene in (name, "all"):
            out[name] = profile_parsed(args, dev, name, depth)
    if args.scene in ("hair", "all"):
        from pbrt_tpu_torch.ops import _build
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        from hair_scene import hair_scene_text
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        path = _build.BUILD_DIR / "hair.pbrt"
        path.write_text(hair_scene_text(8192, 0, 400, 400, 16))
        out["hair"] = profile_parsed(args, dev, "hair", 5, path)
    for name, depth in (("envlit", 5), ("manylight", 3),
                        ("manylight16k", 3), ("killeroo", 5), ("plytex", 5),
                        ("volume", 6)):
        if args.scene in (name, "all"):
            out[name] = profile_parsed(args, dev, name, depth)
    print(json.dumps(out))
    return 0


def profile_cornell(args, dev):
    """Stage times, renders and busy share of the cornell main path."""
    import torch
    from pbrt_tpu_torch import film as film_mod
    from pbrt_tpu_torch import filters as flt
    from pbrt_tpu_torch import lights as lgt
    from pbrt_tpu_torch import samplers as smp
    from pbrt_tpu_torch import scenes
    from pbrt_tpu_torch.integrators import render
    from pbrt_tpu_torch.ops import megawave
    from pbrt_tpu_torch.utils import spectrum as spc

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
    wall_ms, dev_ms = profiled_share(
        lambda: render.render(scene, cam, spp=args.profiled_spp,
                              device=dev),
        f"cornell, {args.profiled_spp} spp")
    return dict(stage_ms=stage_ms, render_paths_per_sec=renders,
                profiled_spp=args.profiled_spp, profiled_wall_ms=wall_ms,
                device_ms=dev_ms, busy_share=dev_ms / wall_ms)


if __name__ == "__main__":
    sys.exit(main())
