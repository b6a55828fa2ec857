"""One run of one cell: set-up, the measured window, the traced image, the
check against the plain reference, and the result line's contents.

The timed path is the program's user entry: parse_string(the scene text)
once at set-up, then render(scene, camera, spp, sampler=zsobol with the
image's own seed, opts=PathOptions(max_depth, megakernel)) for one image
after another until the window's seconds have passed."""
from __future__ import annotations

import contextlib
import dataclasses
import subprocess
import sys
import time
import types

from portbench import checks, spec, tracing
from portbench import roofline

FORBIDDEN = ("jax", "jaxlib", "flax", "pbrt_tpu")


class ForbiddenImport(RuntimeError):
    pass


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is the JAX package's, or
    jax's, jaxlib's or flax's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def guard(when: str) -> None:
    found = forbidden_modules()
    if found:
        raise ForbiddenImport(f"{when}: loaded {', '.join(found)}")


@dataclasses.dataclass
class Window:
    images: list            # (H, W, 3) float32 arrays, in order
    seeds: list             # each image's sampler seed
    image_s: list           # each image's wall time (the traced one's too)
    seconds: float          # from the window's start to its last image's end
    paths: int              # camera paths of every image rendered


def wave_images(wl, max_wave_lanes: int) -> int:
    """Images' sample indices a wave holds (the program's own rule: the
    largest power of two that fits its lanes and divides spp)."""
    n_pix, m = wl.width * wl.height, 1
    while m * 2 * n_pix <= max_wave_lanes and wl.spp % (m * 2) == 0:
        m *= 2
    return m


class Program:
    """The system under test, imported and set up."""

    def __init__(self, cell, device: str, seed: int):
        import torch
        from pbrt_tpu_torch import native
        from pbrt_tpu_torch.ops import _build
        from pbrt_tpu_torch.scene import parser
        self.torch, self.wl, self.device = torch, cell.workload, device
        self.timings = {}
        t = time.perf_counter()
        if device == "cuda":
            _build.build()
            for name in _build.SIGNATURES:
                _build.load_library(name)
        native.load_library()
        self.timings["kernel_load_s"] = time.perf_counter() - t
        text = spec.scene_text(cell, self.wl)
        self._sync()
        t = time.perf_counter()
        self.desc = parser.parse_string(text, base_dir=str(
            cell.scene_path.parent), device=device)
        self._sync()
        self.timings["scene_build_s"] = time.perf_counter() - t
        from pbrt_tpu_torch.integrators import render
        # the warm-up: one wave of the cell's own shape
        self.render(checks.image_seed(seed, -1),
                    spp=wave_images(self.wl, render.MAX_WAVE_LANES))

    def _sync(self):
        if self.device == "cuda":
            self.torch.cuda.synchronize()

    def render(self, seed: int, spp: int = None):
        from pbrt_tpu_torch import samplers
        from pbrt_tpu_torch.integrators import path, render
        wl = self.wl
        spp = spp or wl.spp
        return render.render(
            self.desc.scene, self.desc.camera, spp, device=self.device,
            sampler=samplers.make_sampler("zsobol", spp, seed,
                                          full_resolution=(wl.width,
                                                           wl.height)),
            opts=path.PathOptions(max_depth=wl.max_depth,
                                  megakernel=wl.megakernel))

    def close(self):
        del self.desc
        if self.device == "cuda":
            self.torch.cuda.empty_cache()


def traced(program, seed):
    """Render one image under the profiler: (image, stats, the profile)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if program.device == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(tracing.SPAN):
            img, stats = program.render(seed)
    return img, stats, prof


def measure(program, seed: int, seconds: float, trace: bool):
    """The window: images back to back, none started once `seconds` have
    passed; a traced run then renders one more image, its last, under the
    profiler (the profiler slows the host's launches, and what runs after
    it, so it comes last). Returns (Window, traced (index, stats, the
    profile) or None)."""
    images, seeds, image_s, paths, traced_one = [], [], [], 0, None
    t0 = time.perf_counter()
    while True:
        i, t = len(images), time.perf_counter()
        last = i > 0 and t - t0 >= seconds
        if last and not trace:
            break
        s = checks.image_seed(seed, i)
        if last:
            img, stats, prof = traced(program, s)
            traced_one = (i, stats, prof)
        else:
            img, stats = program.render(s)
        images.append(img)
        seeds.append(s)
        image_s.append(time.perf_counter() - t)
        paths += program.wl.paths
        if last:
            break
    return Window(images, seeds, image_s, time.perf_counter() - t0,
                  paths), traced_one


def log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def power_limit_w():
    """The card's power limit by nvidia-smi, or None where it says nothing."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    try:
        return float(out.stdout.split()[0])
    except (IndexError, ValueError):
        return None


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        t_start: float) -> dict:
    """One run of `cell`; t_start: the process's start (perf_counter).
    Returns the result line's object (the numbers compared last)."""
    import torch
    program = Program(cell, device, seed)
    guard("after set-up")
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s ({program.timings})")
    window, traced_one = measure(program, seed, seconds, trace)
    log(f"window: {len(window.images)} images in {window.seconds:.3f} s; "
        f"each {[round(x, 4) for x in window.image_s]}")
    dev_info = dict(platform="gpu" if device == "cuda" else device,
                    kind=torch.cuda.get_device_name(0) if device == "cuda"
                    else device, count=cell.chips if device == "cuda" else 1,
                    memory_peak_bytes=int(torch.cuda.max_memory_allocated())
                    if device == "cuda" else 0)
    guard("after the window")
    timings = program.timings
    program.close()
    wl = cell.workload
    summary = i = waves = None
    if traced_one is not None:
        i, stats, prof = traced_one
        waves = stats["spp"] * wl.width * wl.height // stats["lanes_per_wave"]
        t = time.perf_counter()
        summary = tracing.summarize(tracing.events_from_profiler(prof))
        del prof, traced_one
        log(f"trace of image {i}: {summary.launches} launches, read in "
            f"{time.perf_counter() - t:.3f} s")

    # the check: one image of the window drawn from the seed, and in a
    # traced run the traced image too, rendered again by the reference and
    # held to pbrt-v4's render of the scene
    t_ref = time.perf_counter()
    ref = checks.Reference(spec.scene_text(cell, wl), cell.scene_path.parent,
                           wl, device)
    golden = checks.read_golden(wl.golden) \
        if wl.golden else None
    k = checks.sample_index(seed, len(window.images))
    kernels = [r.ROOFLINE for r in
               (spec.metric_reader(m["name"]) for m in cell.per_layer)
               if getattr(r, "ROOFLINE", None)] if i is not None else []
    compared, tallies = {}, {}
    for j in sorted({k} | ({i} if i is not None else set())):
        rows = checks.sample_rows(seed, j, wl.height, wl.reference_rows)
        with contextlib.ExitStack() as stack:
            if j == i:      # the traced image: its kernels' work tallied
                for kern in kernels:
                    tallies[kern] = stack.enter_context(
                        roofline.kernel_module(kern).counting())
            compared[j] = checks.compare(
                window.images[j], ref.render(window.seeds[j], rows), golden,
                wl.golden_trim, rows=rows, window=wl.golden_window)
        if j == i and rows is not None:
            # the reference counted the sampled rows' work: the image's,
            # estimated from the rows, one drawn from each band
            for tally in tallies.values():
                tally.least_s *= wl.height / len(rows)
    log(f"reference: images {sorted(compared)} in "
        f"{time.perf_counter() - t_ref:.3f} s")
    limits = wl.limits
    worst = {name: max(c[name] for c in compared.values())
             for name in limits}
    failed = sum(not checks.within(c, limits) for c in compared.values())

    ctx = types.SimpleNamespace(setup_s=setup_s, setup=timings, window=window,
                                trace=summary, waves_traced=waves,
                                rooflines=tallies)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.metric_reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = dict(value=float(value), unit=m["unit"])
    result = dict(correct=failed == 0 and len(window.images) > 0,
                  attempted=len(window.images), failed=failed,
                  metrics=metrics, device=dev_info)
    if summary is not None:
        dev_info.update(busy_s=summary.busy_s, window_s=summary.window_s,
                        power_limit_w=power_limit_w()
                        if device == "cuda" else None)
        result["breakdown"] = dict(device_ops=summary.device_ops,
                                   idle_gaps=summary.idle_gaps)
    result["checks"] = {name: dict(value=worst[name], limit=limits[name])
                        for name in limits}
    return result
