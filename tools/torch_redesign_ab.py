#!/usr/bin/env python3
"""Old against new: the triangle kernel, the megakernels that share its
scan, the curve kernel, the BVH8 kernel and the two-level kernel, each
timed in turns against the same kernel of an earlier checkout, in one
process on one card.

Run from the repository root on a machine with an NVIDIA GPU and nvcc:
    python3 tools/torch_redesign_ab.py --parent DIR [--reps 10] [--only ...]
DIR holds a checkout of the commit to compare with (for instance
`git archive <commit> | tar -x -C DIR`; any commit whose BVH8 and
two-level kernels have their own launch entry points, this one included).
DIR's pbrt_tpu_torch is imported as `ab_parent` (parent_package), and every
section runs the parent's kernels through the parent's own wrappers, and
its bare launches with the arguments of the parent's own launch_args; the
parent's libraries build into DIR's own _build/. The ptxas reports of both
trees' sources of the chosen sections (SECTION_SOURCES) come first.
(pbrt_tpu_torch only; no jax.)

Every time is the median of --reps rounds with the range beside it; a
round times each variant once, in the order old, new, new, old (CUDA events
around --inner launches), so drift hits both alike. A variant timed
"queued" (the bvh8 and two_level sections' "... dev", kernel 7)
has its launches enqueued behind a spin kernel, so that the card runs them
back to back: the device's time a launch, whatever the host takes to make
it. --reps 0 times nothing: it builds, prints the ptxas reports (of the
libraries this run builds), checks every result of this tree against the
parent's and runs each render once on either kernel. Sections (--only):
  tri      the triangle kernel at 32 (cornell), 1,280 (a subdivision-3
           icosphere) and 4,096 (a seeded soup) triangles x 160,000 rays,
           closest and any hit, the parent's against this tree's: through
           the wrappers and as the bare launches with the outputs allocated
           once (the device's share); the BVH8 kernel on the same meshes
           and rays;
  mega     the two megakernels (in-kernel camera, rays in) on the main
           path's 160,000-lane cornell wave at depth 5, each tree's waves
           prepared by its own package, the parent kernel against this
           tree's, through the wrappers and as the bare launches (arguments
           prepared once); L and the filter weight equal to the parent's
           there and on the 64x64x16 cornell waves of both light samplers,
           with this tree's grid and the warp busy share of the plain
           version's schedule (one path a thread, 32 consecutive lanes
           side by side);
  curves   the curve kernel on the hair scene's 524,288 segments: 2^20 box
           rays and one hair wave's own queries (camera rays, bounces, the
           shadow rays), the parent kernel (on its own wide_nodes table)
           against this tree's, through the wrappers and as the bare
           launches;
  bvh8     the BVH8 kernel on meshfield: 2^20 box rays (chip_smoke phase
           7's), closest and any hit, 160,000 dead rays (t_max -1, a
           wave's finished paths: the launch's own cost) and every query of
           one meshfield wave (camera rays, each bounce, each shadow
           query), the parent kernel against this tree's, through the
           wrappers, as the bare launches (outputs allocated once) and as
           the bare launches queued, each held to the parent's result with
           torch.equal and to the plain version bit for bit, with the bound
           of traversal_bound from the plain version's count; the binned page
           kernel (kernel 6) on meshfield's chunked pages, old against new;
           the meshfield render in paths/s on the parent's kernel and on
           this tree's;
  two_level the two-level kernel as bvh8 does the BVH8 kernel (the parent
           on its own kernel_tables): 2^20 box rays and 160,000 dead rays
           on chip_smoke phase 13's 64-instance grid and on the instances
           golden's tables, and every query of one instances wave; the
           single-level kernel (kernel 7) on meshfield's binary BVH,
           queued; the instances render in paths/s.
The last line is one JSON object with these numbers.
"""
import argparse
import importlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

# the sources of each section, whose ptxas reports open the run
SECTION_SOURCES = {"tri": ("tri_intersect",), "mega": ("megawave",),
                   "curves": ("curves",), "bvh8": ("bvh8", "bvh8_binned"),
                   "two_level": ("bvh2",)}
# the package this tree's kernels come from; the parent's is imported as
# PARENT (parent_package)
OWN, PARENT = "pbrt_tpu_torch", "ab_parent"


def ptxas_lines(log):
    """The registers, stack frame and spill lines of an nvcc -Xptxas -v
    log."""
    return "; ".join(ln.strip() for ln in log.splitlines()
                     if "registers" in ln or "spill" in ln
                     or "stack frame" in ln)


def parent_package(parent: Path):
    """The parent checkout's pbrt_tpu_torch, imported as `ab_parent`: its
    wrappers build and launch its own libraries (into its own _build/)."""
    import importlib.util
    if PARENT in sys.modules:
        return sys.modules[PARENT]
    root = parent / "pbrt_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        PARENT, root / "__init__.py",
        submodule_search_locations=[str(root)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[PARENT] = pkg
    spec.loader.exec_module(pkg)
    return pkg


def parent_module(parent: Path, name: str):
    parent_package(parent)
    return importlib.import_module(f"{PARENT}.{name}")


def bare(entry, args, what):
    """A launch of the library entry point with arguments prepared once:
    the device's share."""
    from pbrt_tpu_torch.ops import _build
    return lambda: _build.check(entry(*args), what)


# cycles of the spin kernel a queued timing puts ahead of each of its
# launches (~0.11 ms at the H100's 1.755 GHz): the host enqueues every
# timed launch while it spins
QUEUE_SPIN = 200_000


def alternate(variants: dict, reps: int, inner: int, queued=()) -> dict:
    """{name: dict(ms=median, lo, hi)} of the callables in `variants`, each
    timed once a round in the order first .. last, last .. first. The
    variants named in `queued` are timed behind a spin kernel, so that the
    card runs their launches back to back: the device's time a launch,
    whatever the host's."""
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
            if k in queued:
                torch.cuda._sleep(QUEUE_SPIN * inner)
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


def section_tri(args, dev):
    import torch
    import chip_smoke as cs
    from pbrt_tpu_torch import scenes
    from pbrt_tpu_torch.ops import bvh8
    from pbrt_tpu_torch.ops import tri_intersect as ti
    pti = parent_module(args.parent, "ops.tri_intersect")
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
            ref = pti.tri_intersect(pool, o, d, tv, n_real, any_hit)
            res = ti.tri_intersect(pool, o, d, tv, n_real, any_hit)
            if not _equal(ref, res, any_hit):
                raise RuntimeError(f"tri {n_tris} triangles, any_hit="
                                   f"{any_hit}: differs from the parent "
                                   "kernel")
            variants = {
                "old": lambda: pti.tri_intersect(pool, o, d, tv, n_real,
                                                 any_hit),
                "old bare": lambda: pti._launch(pool, o, d, tv, n_real,
                                                any_hit, out=ref),
                "new": lambda: ti.tri_intersect(pool, o, d, tv, n_real,
                                                any_hit),
                "new bare": lambda: ti._launch(pool, o, d, tv, n_real,
                                               any_hit, out=res)}
            if b8 is not None:
                variants["bvh8"] = lambda: bvh8.bvh8_intersect(b8, o, d, tv,
                                                               any_hit)
            b_ms, b_by = cs.bound(n * 44 + 4 * pool.numel(),
                                  n * n_real * cs.TRI_OPS)
            key = f"{n_tris}_{'any' if any_hit else 'closest'}"
            out[key] = dict(bound_ms=b_ms, bound_by=b_by, **show(
                f"tri {n_tris} triangles x {n} rays, any_hit={any_hit}, "
                f"bound {b_ms:.5f} ms by {b_by}, equal to the parent's "
                "result",
                alternate(variants, args.reps, args.inner)))
    return out


def mega_waves(pkg, dev):
    """The megakernel's waves, each prepared by package pkg (OWN or
    PARENT) from its own scene, sampler and camera: (timed, checked),
    {label: FullWave} each. timed: the main path's 160,000-lane cornell
    wave at depth 5, in-kernel camera and rays in; checked: the waves of
    tests/test_torch_cuda.py::test_megakernel_matches_plain, 64x64, 16 spp,
    both light samplers."""
    import torch

    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")
    flt, smp, scenes = mod("filters"), mod("samplers"), mod("scenes")
    path_mod, megawave = mod("integrators.path"), mod("ops.megawave")
    spc = mod("utils.spectrum")
    scene, cam = scenes.make_cornell_box(400, 400, device=dev)
    sampler = smp.make_sampler("zsobol", spp=64, full_resolution=(400, 400))
    filt = flt.make_filter("gaussian")
    pix = torch.arange(400 * 400, device=dev)
    si = torch.full_like(pix, 37)
    px, py, swl = path_mod.camera_lanes(cam, sampler, pix, si)
    o, d, _wt = path_mod.camera_rays(cam, sampler, filt, px, py, si)
    timed = {"in-kernel camera": megawave.prepare_full(
        scene, sampler, cam, filt, px, py, si, swl.lam, max_depth=5),
        "rays in": megawave.prepare_rays(scene, sampler, px, py, si, o, d,
                                         swl.lam, max_depth=5)}
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
    return timed, checked


def section_mega(args, dev):
    import torch
    from pbrt_tpu_torch.ops import _build
    from pbrt_tpu_torch.ops import megawave
    pmw = parent_module(args.parent, "ops.megawave")
    old_lib = parent_module(args.parent, "ops._build").load_library(
        "megawave")
    new_lib = _build.load_library("megawave")
    old_timed, old_checked = mega_waves(PARENT, dev)
    timed, checked = mega_waves(OWN, dev)
    old_waves = {**old_timed, **old_checked}
    out = {}
    for label, w in {**timed, **checked}.items():
        L0, fw0 = pmw.wave_full(old_waves[label])
        L1, fw1 = megawave.wave_full(w)
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
        if label not in timed:
            continue
        # through the wrappers, then the launches alone (each launch_args'
        # tensors held while its arguments are used)
        old_args = pmw.launch_args(old_waves[label])
        new_args = megawave.launch_args(w)
        out[label].update(show(
            f"megakernel, {label}, 160,000 lanes, depth 5",
            alternate({"old": lambda: pmw.wave_full(old_waves[label]),
                       "new": lambda: megawave.wave_full(w),
                       "old bare": bare(old_lib.megawave_launch, old_args[0],
                                        "parent megawave"),
                       "new bare": bare(new_lib.megawave_launch, new_args[0],
                                        "megawave")},
                      args.reps, args.inner)))
    return out


def section_curves(args, dev):
    import torch
    import chip_smoke as cs
    from hair_scene import hair_scene_text
    from pbrt_tpu_torch.ops import _build
    from pbrt_tpu_torch.ops import curves
    from pbrt_tpu_torch.scene import parser
    pcv = parent_module(args.parent, "ops.curves")
    old_lib = parent_module(args.parent, "ops._build").load_library("curves")
    new_lib = _build.load_library("curves")
    path = _build.BUILD_DIR / "hair.pbrt"
    path.write_text(hair_scene_text(*cs.HAIR))
    desc = parser.parse_file(path, device=dev)
    s = desc.scene
    closest, shadow, _lanes = cs.wave_queries(curves, "curves_intersect", 5,
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
    nodes, segs = s.curve_nodes, s.curve_segs
    # each tree's wrapper on its own kernel table
    sides = {"old": (pcv, pcv.wide_nodes(nodes)),
             "new": (curves, s.curve_wide)}

    def run(who, o, d, tv, any_hit):
        mod, wide = sides[who]
        return mod.curves_intersect(nodes, segs, o, d, tv, any_hit,
                                    depth=s.curve_depth, wide=wide)
    out = {}
    for label, (o, d, tv, any_hit) in sets.items():
        tv = torch.as_tensor(tv, device=dev).expand(o.shape[0]).contiguous()
        o, d = o.contiguous(), d.contiguous()
        ref, res = run("old", o, d, tv, any_hit), run("new", o, d, tv, any_hit)
        if not _equal(ref, res, any_hit):
            raise RuntimeError(f"curves {label}: differs from the parent "
                               "kernel")
        # each tree's launch_args, whose ray counter is held while its
        # arguments are used
        prepared = {who: mod.launch_args(nodes, wide, segs, o, d, tv, any_hit)
                    for who, (mod, wide) in sides.items()}
        hit = (ref[1] >= 0).float().mean().item()
        out[label] = dict(rays=o.shape[0], hit_share=hit, **show(
            f"curves, {label}, {o.shape[0]} rays, hit share {hit:.4f}, equal "
            "to the parent's result",
            alternate({"old": lambda: run("old", o, d, tv, any_hit),
                       "new": lambda: run("new", o, d, tv, any_hit),
                       "old bare": bare(old_lib.curves_intersect_launch,
                                        prepared["old"][0], "parent curves"),
                       "new bare": bare(new_lib.curves_intersect_launch,
                                        prepared["new"][0], "curves")},
                      args.reps, args.inner)))
    return out


def _equal(a, b, any_hit):
    """The hit flag always; t, prim, b1, b2 (and inst) at closest hit."""
    import torch
    if not torch.equal(a[1] >= 0, b[1] >= 0):
        return False
    return any_hit or all(torch.equal(x, y) for x, y in zip(a, b))


def _bvh_sets(cs, module, fn_name, any_hit_arg, desc, depth, dev, boxes):
    """{label: (o, d, t_max (N,), any_hit)}: each of boxes' 2^20 ray sets,
    closest hit (t_max 1e30) and any hit (t_max 30), and every query of
    one wave of desc's scene (none when desc is None) as render hands them
    to module.fn_name (o, d, t_max the three arguments before any_hit)."""
    import torch
    closest, shadow = [], []
    if desc is not None:
        closest, shadow, _lanes = cs.wave_queries(
            module, fn_name, any_hit_arg, desc, depth, dev)
    n = 1 << 20
    sets = {}
    for label, (o, d) in boxes.items():
        for any_hit, t in ((False, 1e30), (True, 30.0)):
            sets[f"{label} 2^20 {'any' if any_hit else 'closest'}"] = (
                o, d, torch.full((n,), t, device=dev), any_hit)
    # every ray dead (t_max -1), as a wave's finished paths: the launch's
    # own cost
    o, d = next(iter(boxes.values()))
    m = 160_000
    sets["dead 160000"] = (o[:m].contiguous(), d[:m].contiguous(),
                           torch.full((m,), -1.0, device=dev), False)
    names = ["wave camera"] + [f"wave bounce {i}"
                               for i in range(1, len(closest))]
    names += [f"wave shadow {i}" for i in range(1, len(shadow) + 1)]
    for name, (a, _k) in zip(names, closest + shadow):
        o, d, t_max = a[any_hit_arg - 3:any_hit_arg]
        t_max = torch.as_tensor(t_max, dtype=torch.float32, device=dev)
        sets[name] = (o.contiguous(), d.contiguous(),
                      t_max.expand(o.shape[0]).contiguous(), a[any_hit_arg])
    return sets


def _time_sets(args, label, sets, k):
    """Each ray set: every variant's result against the parent's
    (torch.equal) and the plain version's (bit for bit), then the variants
    timed in turns: the wrappers, the bare launches, and the bare launches
    queued ("... dev"). k: dict(old, new (the wrappers: fn(o, d, t_max,
    any_hit) -> outputs), old_args, new_args (fn(o, d, t_max, any_hit, out)
    -> the launch's prepared arguments, each tree's own launch_args),
    old_lib, new_lib (the entry points), plain (fn(o, d, t_max, any_hit) ->
    (outputs, work)), bound (fn(work, n) -> (ms, by)))."""
    out = {}
    for name, (o, d, tv, any_hit) in sets.items():
        ref = k["old"](o, d, tv, any_hit)
        new = k["new"](o, d, tv, any_hit)
        got, work = k["plain"](o, d, tv, any_hit)
        if not (_equal(ref, new, any_hit) and _equal(got, new, any_hit)):
            raise RuntimeError(f"{label} {name}: differs from the parent "
                               "kernel or the plain version")
        old_args = k["old_args"](o, d, tv, any_hit, ref)
        new_args = k["new_args"](o, d, tv, any_hit, new)
        launches = {"old bare": bare(k["old_lib"], old_args, "old"),
                    "new bare": bare(k["new_lib"], new_args, "new")}
        # the same launches queued behind a spin: the device's time alone
        launches["old dev"] = launches["old bare"]
        launches["new dev"] = launches["new bare"]
        b_ms, b_by = k["bound"](work, o.shape[0])
        hit = (ref[1] >= 0).float().mean().item()
        timed = {"old": lambda: k["old"](o, d, tv, any_hit),
                 "new": lambda: k["new"](o, d, tv, any_hit), **launches}
        res = show(f"{label}, {name}, {o.shape[0]} rays, hit share "
                   f"{hit:.4f}, bound {b_ms:.5f} ms by {b_by}, every variant "
                   "equal to the parent's result and to the plain version",
                   alternate(timed, args.reps, args.inner,
                             queued={"old dev", "new dev"}))
        out[name] = dict(rays=o.shape[0], hit_share=hit, work=work,
                         bound_ms=b_ms, bound_by=b_by, **res)
    return out


def _render_pair(args, dev, label, desc, depth, module, fn_name, parent_fn):
    """desc's render in paths/s on the parent's kernel (module.fn_name
    replaced by parent_fn) and on this tree's: once each, then parent,
    this, this, parent a round, --render-reps rounds (none at --reps 0)."""
    from pbrt_tpu_torch.integrators import path as path_mod
    from pbrt_tpu_torch.integrators import render
    own = getattr(module, fn_name)

    def go(fn):
        setattr(module, fn_name, fn)
        try:
            _img, st = render.render(desc.scene, desc.camera,
                                     sampler=desc.sampler, device=dev,
                                     opts=path_mod.PathOptions(
                                         max_depth=depth))
        finally:
            setattr(module, fn_name, own)
        return st["paths_per_sec"]
    go(parent_fn)
    go(own)
    if not (args.reps and args.render_reps):
        return {}
    rates = {"parent": [], "this tree": []}
    for _ in range(args.render_reps):
        for who in ("parent", "this tree", "this tree", "parent"):
            rates[who].append(go(parent_fn if who == "parent" else own))
    res = {k: dict(median=statistics.median(v), lo=min(v), hi=max(v))
           for k, v in rates.items()}
    print(f"{label} render, paths/s (no gain is claimed): " + "; ".join(
        f"{k} {v['median']:.6g} ({v['lo']:.6g}-{v['hi']:.6g})"
        for k, v in res.items()), flush=True)
    return res


def section_bvh8(args, dev):
    import torch
    import chip_smoke as cs
    from pbrt_tpu_torch.ops import _build
    from pbrt_tpu_torch.ops import bvh as bvh_mod
    from pbrt_tpu_torch.ops import bvh8
    from pbrt_tpu_torch.ops import bvh8_pages as bp
    from pbrt_tpu_torch.scene import parser
    pb8 = parent_module(args.parent, "ops.bvh8")
    pbp = parent_module(args.parent, "ops.bvh8_pages")
    old_lib = parent_module(args.parent, "ops._build").load_library("bvh8")
    desc = parser.parse_file(cs.MESH_SCENE, device=dev)
    b8 = desc.scene.bvh8
    sets = _bvh_sets(cs, bvh8, "bvh8_intersect", 4, desc, 4, dev,
                     {"box": cs.box_rays(desc.scene, 1 << 20, dev)})

    def wrapper(fn):
        def run(o, d, tv, any_hit):
            r = fn(b8, o, d, tv, any_hit)
            return r["t"], r["prim"], r["b1"], r["b2"]
        return run

    def plain(o, d, tv, any_hit):
        return bvh8.bvh8_intersect_plain(b8, o, d, tv, any_hit), \
            bvh8.counter.work
    tables = (b8.nodes_f, b8.nodes_q, b8.tris, b8.prim_indices)
    out = _time_sets(args, "bvh8", sets, dict(
        old=wrapper(pb8.bvh8_intersect), new=wrapper(bvh8.bvh8_intersect),
        old_args=lambda o, d, tv, any_hit, res: pb8.launch_args(
            b8, o, d, tv, any_hit, out=res)[0],
        new_args=lambda o, d, tv, any_hit, res: bvh8.launch_args(
            b8, o, d, tv, any_hit, out=res)[0],
        old_lib=old_lib.bvh8_intersect_launch,
        new_lib=_build.load_library("bvh8").bvh8_intersect_launch,
        plain=plain,
        bound=lambda work, n: cs.traversal_bound(
            work, n, 16, tables, tri_ops=cs.TRI_OPS,
            visit_ops=8 * cs.BVH8_CHILD_OPS)))
    print(f"bvh8: grid at 2^20 rays {bvh8.grid(1 << 20, dev)}", flush=True)
    # kernel 6, unchanged: the binned query on meshfield's chunked pages,
    # the parent's whole query against this tree's
    tri = desc.scene.tri_all[:, :9].cpu().numpy()
    p = (tri[:, 0:3], tri[:, 3:6], tri[:, 6:9])
    lo = np.minimum(np.minimum(p[0], p[1]), p[2])
    hi = np.maximum(np.maximum(p[0], p[1]), p[2])
    chunked = bvh8.build_bvh8_chunked(lo, hi, bvh_mod.pack_tri_geo(*p),
                                      device=dev)
    o, d = sets["box 2^20 closest"][:2]
    k6 = {}
    keys = ("t", "prim", "b1", "b2")
    for any_hit, t in ((False, 1e30), (True, 30.0)):
        tv = torch.full((o.shape[0],), t, device=dev)
        ref = pbp.binned_intersect(chunked, o, d, tv, any_hit)
        got = bp.binned_intersect(chunked, o, d, tv, any_hit)
        if not _equal([ref[k] for k in keys], [got[k] for k in keys],
                      any_hit):
            raise RuntimeError("bvh8_binned differs from the parent kernel")
        k6[f"box 2^20 {'any' if any_hit else 'closest'}"] = show(
            f"bvh8_binned (kernel 6, the whole binned query), meshfield's "
            f"{chunked.n_chunks} pages, 2^20 box rays, any_hit={any_hit}, "
            "equal to the parent's result",
            alternate({"old": lambda tv=tv, any_hit=any_hit:
                       pbp.binned_intersect(chunked, o, d, tv, any_hit),
                       "new": lambda tv=tv, any_hit=any_hit:
                       bp.binned_intersect(chunked, o, d, tv, any_hit)},
                      args.reps, 1))
    out["kernel 6"] = k6
    out["render"] = _render_pair(args, dev, "meshfield 200x200x32, depth 4",
                                 desc, 4, bvh8, "bvh8_intersect",
                                 pb8.bvh8_intersect)
    return out


def section_two_level(args, dev):
    import torch
    import chip_smoke as cs
    from pbrt_tpu_torch.ops import _build
    from pbrt_tpu_torch.ops import bvh as bvh_mod
    from pbrt_tpu_torch.ops import bvh2
    from pbrt_tpu_torch.scene import parser
    pb2 = parent_module(args.parent, "ops.bvh2")
    old_lib = parent_module(args.parent, "ops._build").load_library("bvh2")
    mesh = parser.parse_file(cs.MESH_SCENE, device=dev).scene
    desc = parser.parse_file(cs.INST_SCENE, device=dev)
    scenes = {"grid64": cs.instanced_meshfield(mesh, dev),
              "golden": desc.scene}
    # the parent's kernel tables, from its own kernel_tables
    old_kt = {key: pb2.kernel_tables(s.inst_rows, s.tri_geo_tlas)
              for key, s in scenes.items()}
    new_lib = _build.load_library("bvh2")
    out = {}
    names = ("t", "prim", "b1", "b2", "inst")
    for key, s in scenes.items():
        boxes = {key: cs.tlas_box_rays(s, 1 << 20, dev, seed=13)}
        sets = _bvh_sets(cs, bvh2, "two_level_intersect", 7,
                         desc if key == "golden" else None, 3, dev, boxes)
        tables = (s.tlas_nodes, s.inst_rows, s.tri_geo_tlas, s.tlas_root)

        def wrapper(fn, s=s, tables=tables, **kw):
            def run(o, d, tv, any_hit):
                r = fn(*tables, o, d, tv, any_hit, depth=s.tlas_depth, **kw)
                return tuple(r[k] for k in names)
            return run

        def plain(o, d, tv, any_hit, tables=tables):
            return bvh2.two_level_plain(*tables, o, d, tv, any_hit), \
                bvh2.counter_two_level.work
        ktab = cs.two_level_bound_tables(s)
        out[key] = _time_sets(args, f"two_level {key}", sets, dict(
            old=wrapper(pb2.two_level_intersect, kernel=old_kt[key]),
            new=wrapper(bvh2.two_level_intersect, kernel=s.tlas_kernel),
            old_args=lambda o, d, tv, any_hit, res, s=s, kt=old_kt[key]:
            pb2.launch_args(s.tlas_nodes, kt, s.tlas_root, o, d, tv, any_hit,
                            out=res)[0],
            new_args=lambda o, d, tv, any_hit, res, s=s: bvh2.launch_args(
                s.tlas_nodes, s.tlas_kernel, s.tlas_root, o, d, tv, any_hit,
                out=res)[0],
            old_lib=old_lib.two_level_launch,
            new_lib=new_lib.two_level_launch,
            plain=plain,
            bound=lambda work, n, ktab=ktab: cs.traversal_bound(
                work, n, 20, ktab, tri_ops=cs.TRI_OPS_EDGES)))
    # kernel 7, unchanged: meshfield's binary BVH, chip_smoke phase 12's
    tri = mesh.tri_all[:, :9].cpu().numpy()
    p = (tri[:, 0:3], tri[:, 3:6], tri[:, 6:9])
    b = bvh_mod.build_bvh(np.minimum(np.minimum(*p[:2]), p[2]),
                          np.maximum(np.maximum(*p[:2]), p[2]))
    nodes = torch.as_tensor(b.nodes, device=dev)
    rows = torch.as_tensor(bvh_mod.pack_tri_geo(*p, order=b.prim_indices),
                           device=dev)
    depth = bvh_mod.bvh_max_depth(b.nodes)
    o, d = cs.box_rays(mesh, 1 << 20, dev)
    k7 = {}
    for any_hit, t in ((False, 1e30), (True, 30.0)):
        tv = torch.full((o.shape[0],), t, device=dev)
        runs = {who: (lambda fn=fn, tv=tv, any_hit=any_hit: tuple(
            fn(nodes, rows, o, d, tv, any_hit, depth=depth)[k]
            for k in names[:4]))
            for who, fn in (("old", pb2.bvh2_intersect),
                            ("new", bvh2.bvh2_intersect))}
        if not _equal(runs["old"](), runs["new"](), any_hit):
            raise RuntimeError("bvh2 (single level) differs from the parent")
        k7[f"box 2^20 {'any' if any_hit else 'closest'}"] = show(
            f"bvh2 (kernel 7, single level), meshfield's binary BVH, 2^20 "
            f"box rays, any_hit={any_hit}, the wrappers' device time "
            "(queued), equal to the parent's result",
            alternate(runs, args.reps, args.inner, queued=set(runs)))
    out["kernel 7"] = k7
    out["render"] = _render_pair(
        args, dev, "instances 200x200x32, depth 3", desc, 3, bvh2,
        "two_level_intersect",
        lambda *a, depth, kernel: pb2.two_level_intersect(
            *a, depth=depth, kernel=old_kt["golden"]))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--inner", type=int, default=5)
    ap.add_argument("--render-reps", type=int, default=3)
    ap.add_argument("--only", nargs="*", default=list(SECTION_SOURCES),
                    choices=list(SECTION_SOURCES))
    args = ap.parse_args()
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
    sources = sorted({n for sec in args.only for n in SECTION_SOURCES[sec]})
    for who, build in (("this tree", _build.build), ("parent", parent_module(
            args.parent, "ops._build").build)):
        for name, (_path, log) in build(sources).items():
            report = ptxas_lines(log) or "built before this run: no report"
            print(f"{who} {name}: {report}", flush=True)
    dev = torch.device("cuda", 0)
    sections = dict(tri=section_tri, mega=section_mega, curves=section_curves,
                    bvh8=section_bvh8, two_level=section_two_level)
    out = dict(card=card, reps=args.reps, inner=args.inner)
    for name in SECTION_SOURCES:
        if name in args.only:
            out[name] = sections[name](args, dev)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
