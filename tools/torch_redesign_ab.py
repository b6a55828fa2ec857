#!/usr/bin/env python3
"""Old against new: the triangle kernel, the megakernels that share its
scan, and the curve kernel, each timed in turns against the same kernel of
an earlier checkout, in one process on one card.

Run from the repository root on a machine with an NVIDIA GPU and nvcc:
    python3 tools/torch_redesign_ab.py --parent DIR [--reps 10] [--only ...]
DIR holds a checkout of the commit to compare with (for instance
`git archive <commit> | tar -x -C DIR`); its csrc/tri_intersect.cu,
megawave.cu and curves.cu are compiled with this tree's flags into
pbrt_tpu_torch/_build/ as ab_*.so. (pbrt_tpu_torch only; no jax.)

Every time is the median of --reps rounds with the range beside it; a
round times each variant once, in the order old, new, new, old (CUDA events
around --inner launches), so drift hits both alike. --reps 0 times nothing:
it builds, prints the ptxas reports and checks every variant against the
parent. Sections (--only):
  tri      the triangle kernel at 32 (cornell), 1,280 (a subdivision-3
           icosphere) and 4,096 (a seeded soup) triangles x 160,000 rays,
           closest and any hit: through the wrapper and as the bare launch
           with the outputs allocated once (the device's share); the parent
           kernel where it launches at all; the BVH8 kernel on the same
           meshes and rays;
  mega     the two megakernels (in-kernel camera, rays in) on the main
           path's 160,000-lane cornell wave at depth 5, the parent kernel
           against this tree's, through the wrappers and as the bare
           launches (arguments prepared once); L and the filter weight
           equal to the parent's there and on the 64x64x16 cornell waves of
           both light samplers, with this tree's grid and the warp busy
           share of the plain version's schedule (one path a thread, 32
           consecutive lanes side by side);
  curves   the curve kernel on the hair scene's 524,288 segments: 2^20 box
           rays and one hair wave's own queries (camera rays, bounces, the
           shadow rays), the parent kernel against this tree's: as the
           package builds it, without refill (32 idle lanes), and built
           with other tuning knobs (--curve-builds, each
           THREADS,MIN_BLOCKS[,REFILL_IDLE[,MIN_WALKERS]]: csrc/curves.cu's
           CURVES_* macros and the wrapper's two thresholds).
The last line is one JSON object with these numbers.
"""
import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the parent's entry points (the triangle kernel's is this tree's too; the
# megakernel's is the one before its persistent grid)
PARENT_SIGNATURES = {
    "tri_intersect": ("tri_intersect_launch", [_P] * 8 + [_I] * 4 + [_P]),
    "megawave": ("megawave_launch", [_P] * 14 + [_I] * 11 + [_F] * 9 + [_P]),
    "curves": ("curves_intersect_launch", [_P] * 7 + [_I] * 2 + [_P]),
}


def build_extra(parent: Path, curve_builds) -> dict:
    """Compile the parent's three sources and this tree's curves.cu once
    for each (threads, min blocks) of curve_builds, one nvcc each,
    all at once. Returns {"parent": {name: lib}, "curves": {knobs: lib}}."""
    from pbrt_tpu_torch.ops import _build
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {("parent", name): (
        parent / "pbrt_tpu_torch" / "csrc" / f"{name}.cu", [], sig)
        for name, sig in PARENT_SIGNATURES.items()}
    for knobs in curve_builds:
        t, b = knobs
        jobs["curves", knobs] = (
            _build.CSRC / "curves.cu",
            [f"-DCURVES_THREADS={t}", f"-DCURVES_MIN_BLOCKS={b}"],
            ("curves_intersect_launch",
             _build.SIGNATURES["curves"]["curves_intersect_launch"]))
    procs = {}
    for key, (src, flags, _sig) in jobs.items():
        tag = key[1] if key[0] == "parent" else "_".join(map(str, key[1]))
        out = _build.BUILD_DIR / f"ab_{key[0]}_{tag}.so"
        procs[key] = (out, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(out),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {"parent": {}, "curves": {}}
    for key, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{key}: nvcc failed:\n{log}")
        print(f"{key[0]} {key[1]}: {ptxas_lines(log)}", flush=True)
        lib = ctypes.CDLL(str(out))
        fn_name, argtypes = jobs[key][2]
        fn = getattr(lib, fn_name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        libs[key[0]][key[1]] = lib
    return libs


def ptxas_lines(log):
    """The registers, stack frame and spill lines of an nvcc -Xptxas -v
    log."""
    return "; ".join(ln.strip() for ln in log.splitlines()
                     if "registers" in ln or "spill" in ln
                     or "stack frame" in ln)


class use_library:
    """Within the block, the wrappers of ops/ launch `lib` for `name`."""

    def __init__(self, name, lib):
        self.name, self.lib = name, lib

    def __enter__(self):
        from pbrt_tpu_torch.ops import _build
        self._load = _build.load_library
        _build.load_library = lambda n: self.lib if n == self.name \
            else self._load(n)

    def __exit__(self, *exc):
        from pbrt_tpu_torch.ops import _build
        _build.load_library = self._load


def alternate(variants: dict, reps: int, inner: int) -> dict:
    """{name: dict(ms=median, lo, hi)} of the callables in `variants`, each
    timed once a round in the order first .. last, last .. first."""
    import torch
    names = list(variants)
    order = names + names[::-1]
    for fn in variants.values():
        fn()
    torch.cuda.synchronize()
    if not reps:
        return {}
    samples = {k: [] for k in names}
    for _ in range(reps):
        seen = {k: [] for k in names}
        for k in order:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _i in range(inner):
                variants[k]()
            b.record()
            b.synchronize()
            seen[k].append(a.elapsed_time(b) / inner)
        for k in names:
            samples[k].append(statistics.mean(seen[k]))
    return {k: dict(ms=statistics.median(v), lo=min(v), hi=max(v))
            for k, v in samples.items()}


def show(label, res):
    print(f"{label}: " + "; ".join(
        f"{k} {v['ms']:.4f} ms ({v['lo']:.4f}-{v['hi']:.4f})"
        for k, v in res.items()), flush=True)
    return res


def section_tri(args, dev, parent):
    import torch
    import chip_smoke as cs
    from pbrt_tpu_torch import scenes
    from pbrt_tpu_torch.ops import bvh8
    from pbrt_tpu_torch.ops import tri_intersect as ti
    cornell, _cam = scenes.make_cornell_box(400, 400, device=dev)
    n = cs.LAUNCH_RAYS
    cases = [(32, cornell.tri_pallas, cornell.mega.n_tris, None,
              cs.seeded_rays(n, dev, seed=8)[:2])]
    for which in ("sphere", "soup"):
        p = cs.big_pool(which, dev)
        cases.append((p["n_real"], p["pool"], p["n_real"], p["bvh8"],
                      cs.seeded_box_rays(p["lo"], p["hi"], n, dev, seed=33)))
    out = {}
    for n_tris, pool, n_real, b8, (o, d) in cases:
        for any_hit, t_max in ((False, 1e30), (True, 1.5 if b8 else 700.0)):
            tv = torch.full((n,), t_max, device=dev)
            res = ti.tri_intersect(pool, o, d, tv, n_real, any_hit)

            def old(bare):
                with use_library("tri_intersect", parent["tri_intersect"]):
                    return ti._launch(pool, o, d, tv, n_real, any_hit,
                                      out=res if bare else None)
            variants = {
                "new": lambda: ti.tri_intersect(pool, o, d, tv, n_real,
                                                any_hit),
                "new bare": lambda: ti._launch(pool, o, d, tv, n_real,
                                               any_hit, out=res)}
            try:
                old(True)
                variants = {"old": lambda: old(False),
                            "old bare": lambda: old(True), **variants}
            except RuntimeError as e:
                print(f"tri {n_tris} triangles: the parent kernel does not "
                      f"launch: {e}", flush=True)
            if b8 is not None:
                variants["bvh8"] = lambda: bvh8.bvh8_intersect(b8, o, d, tv,
                                                               any_hit)
            b_ms, b_by = cs.bound(n * 44 + 4 * pool.numel(),
                                  n * n_real * cs.TRI_OPS)
            key = f"{n_tris}_{'any' if any_hit else 'closest'}"
            out[key] = dict(bound_ms=b_ms, bound_by=b_by, **show(
                f"tri {n_tris} triangles x {n} rays, any_hit={any_hit}, "
                f"bound {b_ms:.5f} ms by {b_by}",
                alternate(variants, args.reps, args.inner)))
    return out


def parent_args(w):
    """The parent megakernel's launch arguments for wave w (its signature:
    one block a 128 lanes, the Sobol' columns copied on every launch):
    (args, L, fw, keep), as megawave.launch_args."""
    import torch
    from pbrt_tpu_torch import filters as flt
    from pbrt_tpu_torch.ops import megawave
    rays = w.o is not None
    N = w.mi.shape[0]
    dev = w.lam.device
    mi32 = torch.where(w.mi >= 2 ** 31, w.mi - 2 ** 32, w.mi) \
        .to(torch.int32).contiguous()
    seeds = megawave._device_seeds(dev, w.seed, w.max_depth)
    cols = megawave._on_card(megawave.sobol_cols01(), dev)
    L = torch.empty((N, 4), dtype=torch.float32, device=dev)
    fw = None if rays else torch.empty((N,), dtype=torch.float32, device=dev)
    c = dict.fromkeys(("s2", "inv_2s2", "norm", "zx", "zy", "ex", "ey", "rx",
                       "ry"), 0.0) if rays else flt.gaussian_constants(w.filt)
    args = (
        None if rays else w.cam.data_ptr(), w.tri.data_ptr(),
        w.attr.data_ptr(), w.light.data_ptr(), w.mat.data_ptr(),
        seeds.data_ptr(), cols.data_ptr(), mi32.data_ptr(),
        w.lam.data_ptr(), w.le.data_ptr(),
        w.o.data_ptr() if rays else None, w.d.data_ptr() if rays else None,
        L.data_ptr(), None if rays else fw.data_ptr(), N,
        w.tri.numel() // 16, w.n_real, w.n_mats, w.n_lights, seeds.shape[0],
        w.max_depth, w.rr_start, w.B, w.log2_spp, int(w.ls_uniform),
        *(_F(c[k]) for k in ("s2", "inv_2s2", "norm", "zx", "zy", "ex", "ey",
                             "rx", "ry")),
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    return args, L, fw, (mi32, seeds, cols)


def bare_launch(lib, args, what):
    """A launch with arguments prepared once: the device's share."""
    from pbrt_tpu_torch.ops import _build
    return lambda: _build.check(lib.megawave_launch(*args), what)


def parent_megawave(lib, w):
    """The parent's megakernel on wave w through its host work."""
    args, L, fw, _keep = parent_args(w)
    bare_launch(lib, args, "parent megawave")()
    return L, fw


def section_mega(args, dev, parent):
    import torch
    from pbrt_tpu_torch import filters as flt
    from pbrt_tpu_torch import samplers as smp
    from pbrt_tpu_torch import scenes
    from pbrt_tpu_torch.integrators import path as path_mod
    from pbrt_tpu_torch.ops import _build
    from pbrt_tpu_torch.ops import megawave
    from pbrt_tpu_torch.utils import spectrum as spc
    scene, cam = scenes.make_cornell_box(400, 400, device=dev)
    sampler = smp.make_sampler("zsobol", spp=64, full_resolution=(400, 400))
    filt = flt.make_filter("gaussian")
    pix = torch.arange(400 * 400, device=dev)
    si = torch.full_like(pix, 37)
    px, py, swl = path_mod.camera_lanes(cam, sampler, pix, si)
    o, d, _wt = path_mod.camera_rays(cam, sampler, filt, px, py, si)
    waves = {"in-kernel camera": megawave.prepare_full(
        scene, sampler, cam, filt, px, py, si, swl.lam, max_depth=5),
        "rays in": megawave.prepare_rays(scene, sampler, px, py, si, o, d,
                                         swl.lam, max_depth=5)}
    # the waves of tests/test_torch_cuda.py::test_megakernel_matches_plain:
    # 64x64, 16 spp, both light samplers; checked, untimed
    w64, spp64 = 64, 16
    cam64 = scenes.make_cornell_box(w64, w64, device=dev)[1]
    sampler64 = smp.make_sampler("zsobol", spp=spp64,
                                 full_resolution=(w64, w64))
    pix = torch.arange(w64 * w64, device=dev).repeat(spp64)
    si = torch.arange(w64 * w64 * spp64, device=dev) // (w64 * w64)
    px, py = pix % w64, pix // w64
    lam = spc.sample_visible_wavelengths(
        smp.sample_1d(sampler64, px, py, si, 5)).lam
    checked = {f"64x64x16 {label}": megawave.prepare_full(
        sc, sampler64, cam64, filt, px, py, si, lam, max_depth=5)
        for label, sc in (
            ("power", scenes.make_cornell_box(w64, w64, device=dev)[0]),
            ("uniform", scenes.make_uniform_light_box(dev)))}
    new_lib = _build.load_library("megawave")
    out = {}
    for label, w in {**waves, **checked}.items():
        L0, fw0 = parent_megawave(parent["megawave"], w)
        L1, fw1 = megawave._launch(w)
        same = torch.equal(L0, L1) and (fw0 is None or torch.equal(fw0, fw1))
        megawave.wave_full_plain(w)
        share = megawave.counter.work["warp_busy_share"]
        grid = megawave.grid(w)
        print(f"megakernel, {label}: L and filter weight equal to the "
              f"parent's: {same}; grid {grid}; warp busy share of the plain "
              f"version's schedule {share:.4f}", flush=True)
        if not same:
            raise RuntimeError(f"megakernel, {label}: differs from the "
                               "parent kernel")
        out[label] = dict(equal_to_parent=same, grid=grid,
                          plain_warp_busy_share=share)
        if label not in waves:
            continue
        # through the wrappers, then the launches alone
        old_args, new_args = parent_args(w), megawave.launch_args(w)
        out[label].update(show(
            f"megakernel, {label}, 160,000 lanes, depth 5",
            alternate({"old": lambda: parent_megawave(parent["megawave"], w),
                       "new": lambda: megawave.wave_full(w),
                       "old bare": bare_launch(parent["megawave"],
                                               old_args[0], "parent"),
                       "new bare": bare_launch(new_lib, new_args[0], "new")},
                      args.reps, args.inner)))
    return out


def section_curves(args, dev, parent, builds):
    import torch
    import chip_smoke as cs
    from hair_scene import hair_scene_text
    from pbrt_tpu_torch.ops import _build
    from pbrt_tpu_torch.ops import curves
    from pbrt_tpu_torch.scene import parser
    path = _build.BUILD_DIR / "hair.pbrt"
    path.write_text(hair_scene_text(*cs.HAIR))
    desc = parser.parse_file(path, device=dev)
    s = desc.scene
    closest, shadow, lanes = cs.wave_queries(curves, "curves_intersect", 5,
                                             desc, 5, dev)
    box = s.curve_nodes[0, :6].cpu().numpy()
    n = 1 << 20
    o, d = cs.seeded_box_rays(box[:3], box[3:], n, dev, seed=17)  # phase 17's
    sets = {"box 2^20 closest": (o, d, torch.full((n,), 1e30, device=dev),
                                 False),
            "box 2^20 any": (o, d, torch.full((n,), 30.0, device=dev), True),
            "wave camera": closest[0][0][2:6],
            "wave bounce 1": closest[1][0][2:6],
            "wave bounce 3": closest[3][0][2:6],
            "wave shadow 1": shadow[0][0][2:6],
            "wave shadow 3": shadow[2][0][2:6]}
    old_lib = parent["curves"]

    def old(o, d, tv, any_hit):
        t = torch.empty_like(tv)
        seg = torch.empty(tv.shape, dtype=torch.int32, device=dev)
        err = old_lib.curves_intersect_launch(
            s.curve_nodes.data_ptr(), s.curve_segs.data_ptr(), o.data_ptr(),
            d.data_ptr(), tv.data_ptr(), t.data_ptr(), seg.data_ptr(),
            o.shape[0], int(any_hit),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        _build.check(err, "parent curves")
        return t, seg

    def new(o, d, tv, any_hit, **kw):
        return curves._launch(s.curve_nodes, s.curve_wide, s.curve_segs, o, d,
                              tv, any_hit, **kw)
    # "new" is the wrapper's default; a build's knobs are THREADS,
    # MIN_BLOCKS and the two thresholds
    steps = {"new, no refill": dict(refill_idle=32)}
    for (t, b), refill, walkers in args.curve_builds:
        steps[f"{t},{b},{refill},{walkers}"] = dict(
            lib=builds[t, b], refill_idle=refill, min_walkers=walkers)
    out = {}
    for label, (o, d, tv, any_hit) in sets.items():
        tv = torch.as_tensor(tv, device=dev).expand(o.shape[0]).contiguous()
        o, d = o.contiguous(), d.contiguous()
        t0, seg0 = old(o, d, tv, any_hit)
        for name, kw in steps.items():
            t1, seg1 = new(o, d, tv, any_hit, **kw)
            same = torch.equal(seg0 >= 0, seg1 >= 0) and (any_hit or (
                torch.equal(seg0, seg1) and torch.equal(t0, t1)))
            if not same:
                raise RuntimeError(f"curves {label}, {name}: differs from "
                                   "the parent kernel")
        variants = {"old": lambda: old(o, d, tv, any_hit)}
        variants.update({name: (lambda kw=kw: new(o, d, tv, any_hit, **kw))
                         for name, kw in steps.items()})
        variants["new"] = lambda: new(o, d, tv, any_hit)
        hit = (seg0 >= 0).float().mean().item()
        out[label] = dict(rays=o.shape[0], hit_share=hit, **show(
            f"curves, {label}, {o.shape[0]} rays, hit share {hit:.4f}, every "
            "variant equal to the parent's result",
            alternate(variants, args.reps, args.inner)))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--inner", type=int, default=5)
    ap.add_argument("--only", nargs="*", default=["tri", "mega", "curves"],
                    choices=["tri", "mega", "curves"])
    ap.add_argument("--curve-builds", nargs="*", default=[],
                    help="THREADS,MIN_BLOCKS[,REFILL_IDLE[,MIN_WALKERS]] "
                    "each")
    args = ap.parse_args()
    from pbrt_tpu_torch.ops import curves
    args.curve_builds = [
        (tuple(v[:2]), v[2] if len(v) > 2 else curves.REFILL_IDLE,
         v[3] if len(v) > 3 else curves.MIN_WALKERS)
        for v in ([int(x) for x in b.split(",")]
                  for b in args.curve_builds)]
    import torch
    if not torch.cuda.is_available():
        print("torch_redesign_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "--id=0"],
                          capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    from pbrt_tpu_torch.ops import _build
    for name, (_path, log) in _build.build(list(PARENT_SIGNATURES)).items():
        print(f"this tree {name}: {ptxas_lines(log)}", flush=True)
    libs = build_extra(args.parent, sorted({b[0] for b in
                                            args.curve_builds}))
    dev = torch.device("cuda", 0)
    out = dict(card=card, reps=args.reps, inner=args.inner)
    if "tri" in args.only:
        out["tri"] = section_tri(args, dev, libs["parent"])
    if "mega" in args.only:
        out["mega"] = section_mega(args, dev, libs["parent"])
    if "curves" in args.only:
        out["curves"] = section_curves(args, dev, libs["parent"],
                                       libs["curves"])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
