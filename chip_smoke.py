#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (pbrt_tpu_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1):
  1. start: a CUDA device must be present (else exit 2); print the card's
     name and power limit as nvidia-smi reports them;
  2. build every CUDA kernel library of pbrt_tpu_torch/csrc with nvcc;
  3. tri_intersect kernel against its plain PyTorch version on the card,
     1M seeded rays against the cornell pool, closest and any hit;
  4. megakernel against its plain version on the card: cornell 64x64,
     16 spp, max depth 5;
  5. the main path through the user entry point
     (pbrt_tpu_torch.integrators.render.render): cornell 400x400, 64 spp,
     max depth 5, launch counts read around it, the image gated against
     the reference renderer's golden (goldens/cornell_400_64spp.exr) with
     the MRSE and mean-ratio gates of tools/golden.py, and written to
     pbrt_tpu_torch/_build/;
  6. times with CUDA events at the main path's wave shape (160,000 lanes):
     each kernel beside its plain version, and the render in paths/s;
  7. the BVH8 kernel against its plain version on the card: meshfield's
     BVH8, 2^20 seeded rays from the world box +-1, closest hit (t_max
     1e30) and any hit (t_max 30);
  8. the meshfield path through the user entry points
     (scene.parser.parse_file -> integrators.render.render): 200x200,
     32 spp, max depth 4, every closest and shadow query through the BVH8
     kernel, launch counts read around it, the image gated against
     goldens/meshfield_200_32spp.exr and written to pbrt_tpu_torch/_build/;
  9. cornell through the general wave (PathOptions(megakernel=False)):
     400x400, 64 spp, max depth 5, every query through the triangle
     kernel, launch counts read around it, gated like phase 5;
 10. times with CUDA events: the BVH8 kernel and its plain version at 2^20
     rays, closest and any hit, and the two renders in paths/s;
 11. the bvh2 library's ptxas report: registers, stack frame and spills of
     its two entries (single level, two levels);
 12. the single-level bvh2 kernel against its plain version: meshfield's
     binary BVH, the 2^20 rays of phase 7, closest and any hit (t_max 30);
 13. the two-level bvh2 kernel against its plain version: meshfield's
     triangles as one prototype instanced 64 times on an 8x8 grid, each
     turned about y by a seeded angle, and the instances golden's own
     tables, 2^20 rays from each world box +-1, closest and any hit;
 14. the instances path through the user entry points (parse_file ->
     render): 200x200, 32 spp, max depth 3, every closest and shadow query
     through the two-level kernel, launch counts read around it, the image
     gated against goldens/instances_200_32spp.exr and written to
     pbrt_tpu_torch/_build/;
 15. times with CUDA events: both bvh2 entries and their plain versions
     beside the BVH8 kernel on the same rays, and the instances render in
     paths/s;
 16. the curves library's ptxas report: registers, stack frame, spills;
 17. the curve kernel against its plain version on the card: the "hair"
     scene (tools/hair_scene.py: 8,192 strands, 65,536 curve spans,
     524,288 sub-segments), generated into pbrt_tpu_torch/_build/ and
     parsed with scene.parser.parse_file, 2^20 seeded rays from the fur
     patch's box +-1, closest hit (t_max 1e30: t and segment bit for bit,
     and u, v, n, curve id through intersect_curves) and any hit (t_max
     30: the hit flag);
 18. the hair path through the user entry points (parse_file -> render):
     400x400, 16 spp, max depth 5, every closest and shadow query through
     the curve kernel and the triangle kernel, launch counts read around
     it, the image finite and non-zero, written to pbrt_tpu_torch/_build/;
 19. "hair-ref" (512 strands, 128x128, 16 spp) through the same entry
     points, gated against the JAX package's CPU render of the same scene
     (tests/data/torch_hair_ref_128_16spp.exr, made by
     tools/make_hair_reference.py) with the instances gates;
 20. times with CUDA events: the curve kernel and its plain version at
     2^20 rays, closest and any hit, and the hair render in paths/s with
     its set-up (generate, parse, split, build) apart;
 21. the ptxas report of the bvh8_forest and bvh8_binned libraries and of
     the rebuilt megawave library: registers, stack frame, spills;
 22. the rays-in megakernel (megakernel v1) against its plain version:
     160,000 cornell lanes at depth 5 (the main path's wave, sample index
     37), camera rays from the general wave's front end (path.camera_rays);
     L bit for bit; against the in-kernel-camera megakernel on the same
     lanes and that kernel's own camera rays: within rel 1e-4 on every
     lane and bit for bit; on the front end's rays, which round apart from
     the in-kernel camera's, within rel 1e-4 on >= 99.9% of lanes (phase
     4's gate);
 23. the rays-in megakernel's path at full width: cornell 400x400, 64 spp,
     depth 5, 64 waves of path.camera_lanes and path.camera_rays ->
     path.trace_paths(PathOptions(megakernel=True)) -> film.add_samples,
     launch counts read around it, the image gated like phase 5;
 24. the paged big-mesh traversal on tools/terrain_rays.py's terrain
     (999,698 triangles): forest, chunked and whole-tree BVH8 builds from
     one binary tree; 2^20 raster and 2^20 bounce rays, closest hit (t_max
     1e30) and any hit (t_max 30), through the forest kernel, the binned
     rounds and the whole-tree kernel, launch counts read around them;
     each paged kernel against its plain version on every ray set (t,
     triangle, b1, b2 bit for bit at closest hit, the hit flag at any hit;
     all rays or a middle slice of whole blocks, TERRAIN_PLAIN), and both
     against the whole-tree kernel on all rays;
 25. times with CUDA events: the forest kernel, the binned query (each
     round's kernel, the pre-pass and the schedule apart), the whole-tree
     kernel on the same rays, each plain version, the rays-in megakernel
     beside the in-kernel-camera one, and the page bytes staged beside the
     tables' bytes;
 26. the dma_probe library's ptxas report: registers, spills of its four
     entries;
 27. the page-copy probes against their plain versions, bit for bit, and
     against the values the TPU probes check: the 14 configurations of
     tools/exp_dma_var.py, exp_dma_var2.py and exp_dma_min.py x the three
     copy paths (ld, cp_async, bulk) at their own size (8 pages of 16
     rows); then whole pages summed at the paged kernels' page sizes (420
     pages of 226 rows pipelined, of 298 and 378 rows manual, the ladder's
     stage 4, one copy of page 2);
 28. the timed matrix of tools/torch_dma_probe.py (run_matrix), launch
     counts read around it: 420 pages, 1,024 blocks of 1,024 threads, 20
     seeded schedule entries a block at 378 rows (20,480 copies, 3.96 GB,
     the forest kernel's raster query with the traversal taken out), each
     copy path x page size x {the copy alone, the copy and a full read},
     manual and pipelined, the seeded order and every block's pages in
     ascending order (the forest kernel's), dma_var at its own grid of two
     blocks; CUDA events, medians; torch.index_select on the same schedules
     beside them; the finding: the copies alone against the forest kernel's
     time in this run, the best copy path over plain loads at each size;
 29. the patches path through the user entry points (parse_file ->
     render): scenes/patches.pbrt, 12 exact bilinear patches over a
     2-triangle ground, 200x200, 32 spp, max depth 3, the triangle queries
     through the triangle kernel and the patches through tensor code,
     launch counts read around it, the image gated against
     goldens/patches_200_32spp.exr and written to pbrt_tpu_torch/_build/;
 30. its time in paths/s, set-up apart.
Phase 2 builds every kernel (one nvcc per source, all started together)
and the host BVH builder (g++). The line before the last is a JSON object
with one entry per kernel, each with its bound: the larger of the bytes it
must move over 3.35 TB/s and the f32 operations this run's rays needed
(counted by the plain version) over 67 TFLOP/s, the H100 SXM's published
peaks; no single PyTorch call computes a ray query or a path, so their
library_ms is null; the probes' is torch.index_select on the same
schedule. The last line is {"ok": true, "device": {...}}.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "goldens" / "cornell_400_64spp.exr"
GATE_MRSE = 0.08        # tools/golden.py CONFIGS, cornell
GATE_MEAN_RATIO = 0.02
MESH_SCENE = ROOT / "scenes" / "meshfield.pbrt"
MESH_GOLDEN = ROOT / "goldens" / "meshfield_200_32spp.exr"
MESH_GATE_MRSE = 0.05   # tools/golden.py CONFIGS, meshfield
MESH_GATE_MEAN_RATIO = 0.02
INST_SCENE = ROOT / "scenes" / "instances.pbrt"
INST_GOLDEN = ROOT / "goldens" / "instances_200_32spp.exr"
INST_GATE_MRSE = 0.05   # tools/golden.py CONFIGS, instances
INST_GATE_MEAN_RATIO = 0.02
# hair_scene_text arguments (strands, seed, width, height, spp)
HAIR = (8192, 0, 400, 400, 16)
HAIR_REF_SCENE = (512, 1, 128, 128, 16)
HAIR_REF = ROOT / "tests" / "data" / "torch_hair_ref_128_16spp.exr"
HAIR_GATE_MRSE = 0.05   # the instances gates
HAIR_GATE_MEAN_RATIO = 0.02
PATCH_SCENE = ROOT / "scenes" / "patches.pbrt"
PATCH_GOLDEN = ROOT / "goldens" / "patches_200_32spp.exr"
PATCH_GATE_MRSE = 0.05  # tools/golden.py CONFIGS, patches
PATCH_GATE_MEAN_RATIO = 0.02
# the bound's peaks (H100 SXM data sheet) and the f32 operations of one
# unit of work, counted from the kernels' sources
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
SLAB_OPS = 26           # 6 sub, 6 mul, 6 min/max, 6 for tmin/tmax, 2 test
TRI_OPS = 60            # Moeller-Trumbore on rows with precomputed edges
TRI_RAW_OPS = 64        # on raw vertices: 6 edge subtractions, no tolerance
BVH8_CHILD_OPS = 12 + SLAB_OPS   # dequantise a child box, then its slab
ENTER_OPS = 39          # a ray through w2o (33) and its 3 inverse dirs
FOREST_CHILD_OPS = SLAB_OPS      # the forest's children are not quantised
TERRAIN_N = 708                 # tools/exp_1m.py's terrain: 999,698 tris
TERRAIN_RAYS = 1 << 20
# The paged plain versions' rays per set. On all 2^20 rays of every set
# they took 170 s on the H100, and their chunk loop costs nearly as much
# on 2^16 bounce rays as on 2^20: they run on all raster rays at closest
# hit (the kernels line's times and bounds) and on the middle 2^16 rays of
# the other three sets (the first raster rows see only sky), whole
# 1,024-ray blocks, whose results do not depend on the other blocks' rays.
TERRAIN_PLAIN = {("raster", False): 1 << 20, ("raster", True): 1 << 16,
                 ("bounce", False): 1 << 16, ("bounce", True): 1 << 16}
# csrc/curves.cu segment_test: 6 sub (ends - o), 30 for the two ends in the
# ray frame, 2 sub, 4 for |e|^2, 7 for w, 4 for c, 3 for dist^2, 3 for the
# width, 2 for hw^2/4, 1 test, 3 for z, 3 for the edge, 2 for z_hit, 2 for
# t, 3 tests
SEG_OPS = 75
# what the TPU copy probes check (tools/exp_dma_var.py, exp_dma_var2.py)
# or print (exp_dma_min.py: row means at stages 1-2, then at stages 3-4)
PROBE_VALUES = {"var": 4096.0, "var2": [8192.0, 12288.0, 16384.0, 20480.0],
                "min": {False: [0.0, 2048.0, 4096.0, 6144.0],
                        True: [2048.0, 2048.0, 10240.0, 6144.0]}}


def check(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def mrse(img, ref):
    """Relative MSE, tools/golden.py mrse (trim 0)."""
    d = img - ref
    return float((d * d / (ref * ref + 0.01)).mean(axis=-1).reshape(-1)
                 .mean())


def cuda_ms(fn, reps, warmup=1):
    """Mean milliseconds per call of fn over reps calls, CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def compare_wave(w, label):
    """Run the megakernel and its plain version on wave w and hold them to
    each other: L within rel 1e-4 (floor 1e-3) on >= 99.9% of lanes and
    bit-identical on >= 99.9% of lanes, mean L within 1e-3 relative, the
    filter weight allclose. Returns max |dL|."""
    import torch
    from pbrt_tpu_torch.ops import megawave
    L, fw = megawave.wave_full(w)
    L_p, fw_p = megawave.wave_full_plain(w)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(L).all()), f"{label}: megakernel not finite")
    rel = ((L - L_p).abs() / L_p.abs().clamp(min=1e-3)).amax(dim=1)
    within = (rel < 1e-4).float().mean().item()
    exact = (L == L_p).all(dim=1).float().mean().item()
    mean_rel = abs(L.mean().item() / L_p.mean().item() - 1.0)
    err = (L - L_p).abs().max().item()
    print(f"[{label}] {L.shape[0]} lanes (index bits B={w.B}): "
          f"{within * 100:.4f}% within rel 1e-4 (floor 1e-3), "
          f"{100 * (1 - within):.4f}% differ (a hit or roulette decision "
          f"flipped on a rounding-level difference); {exact * 100:.4f}% "
          f"bit-identical; mean L rel diff {mean_rel:.3g}; max |dL| "
          f"{err:.3g}; filter weight max |d| "
          f"{(fw - fw_p).abs().max().item():.3g}", flush=True)
    check(within >= 0.999, f"{label}: lanes within tolerance {within}")
    check(exact >= 0.999, f"{label}: bit-identical lanes {exact}")
    check(mean_rel < 1e-3, f"{label}: mean L differs by {mean_rel}")
    check(torch.allclose(fw, fw_p, rtol=1e-5, atol=1e-6),
          f"{label}: filter weight differs")
    return err


def seeded_rays(n, device, seed=7):
    import numpy as np
    import torch
    rs = np.random.RandomState(seed)
    o = rs.uniform([-50, -50, -900], [600, 600, 600], (n, 3))
    d = rs.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_any = rs.uniform(0, 1500, n)
    return [torch.as_tensor(a, dtype=torch.float32, device=device)
            for a in (o, d, t_any)]


def gate(img, golden, shape, max_mrse, max_ratio, label):
    """Hold a render to a reference-renderer golden; returns (mrse, mean
    ratio error)."""
    import numpy as np
    from pbrt_tpu_torch.utils import image
    check(img.shape == shape and bool(np.isfinite(img).all()),
          f"{label}: render output shape or values")
    ref = image.read_exr(golden)
    m = mrse(img, ref)
    ratio = abs(float(img.mean()) / max(float(ref.mean()), 1e-9) - 1.0)
    print(f"[{label}] mrse {m:.5f} (gate {max_mrse}), mean ratio err "
          f"{ratio:.5f} (gate {max_ratio})", flush=True)
    check(m <= max_mrse and ratio <= max_ratio, f"{label}: golden gate")
    return m, ratio


def bound(n_bytes, n_ops):
    """(bound_ms, bound_by): the least time of the work on the card."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_F32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def traversal_bound(work, n_rays, out_bytes, tables, tri_ops=TRI_RAW_OPS,
                    visit_ops=SLAB_OPS):
    """Bound of a BVH query: rays read once (o, d, t_max: 28 B), hits
    written once, tables read once; node visits, triangle tests and
    instance entries as the plain version counted them on the same rays."""
    n_bytes = n_rays * (28 + out_bytes) + sum(4 * x.numel() for x in tables)
    n_ops = (work["node_visits"] * visit_ops + work["tri_tests"] * tri_ops
             + work.get("instance_entries", 0) * ENTER_OPS)
    return bound(n_bytes, n_ops)


def hold_to_plain(got, want, label, n_rays, any_hit):
    """A BVH kernel's result against its plain version's: hit equal on >=
    99.99% of rays; closest hit: prim equal on >= 99.99%, t (and inst)
    bit-equal where prim is equal. Returns max |dt| where prim is equal."""
    import torch
    torch.cuda.synchronize()
    hit_p = want["prim"] >= 0
    hit_agree = (got["hit"] == hit_p).float().mean().item()
    same = got["prim"] == want["prim"]
    agree = same.float().mean().item()
    hit = same & hit_p
    t_exact = torch.equal(got["t"][hit], want["t"][hit])
    inst_exact = "inst" not in want or torch.equal(got["inst"][same],
                                                   want["inst"][same])
    err = (got["t"][hit] - want["t"][hit]).abs().max().item() \
        if bool(hit.any()) else 0.0
    print(f"[{label}] any_hit={any_hit}: hit equal on {hit_agree * 100:.4f}%"
          f", prim equal on {agree * 100:.4f}% of {n_rays} rays, hit share "
          f"{hit_p.float().mean().item():.4f}, t bit-equal where prim equal:"
          f" {t_exact}, inst equal there: {inst_exact}, max |dt| {err:.3g}",
          flush=True)
    check(hit_agree >= 0.9999, f"{label}: hit agreement {hit_agree}")
    if not any_hit:
        check(agree >= 0.9999, f"{label}: prim agreement {agree}")
        check(t_exact and inst_exact,
              f"{label}: t or inst differs where prim is equal")
    return err


def instanced_meshfield(mesh, device, seed=5):
    """meshfield's triangles as one prototype, instanced on an 8x8 grid
    spaced by the mesh's extent, each turned about y by a seeded angle,
    over a ground quad. Returns the scene."""
    import numpy as np
    from pbrt_tpu_torch.scene_core import SceneBuilder
    from pbrt_tpu_torch.utils import transform as tfm
    tri = mesh.tri_all[:, :9].cpu().numpy().reshape(-1, 3)
    lo, hi = tri.min(axis=0), tri.max(axis=0)
    ext = hi - lo
    b = SceneBuilder()
    m = b.materials.add_diffuse((0.6, 0.6, 0.6))
    proto = b.new_prototype()
    b.add_proto_mesh(proto, tri, np.arange(len(tri)).reshape(-1, 3), m)
    angles = np.random.default_rng(seed).uniform(0, 360, 64)
    for k, a in enumerate(angles):
        gx, gz = k % 8, k // 8
        b.add_instance(proto, tfm.translate((gx * ext[0], 0, gz * ext[2]))
                       @ tfm.rotate(a, (0, 1, 0)))
    y = float(lo[1]) - 0.01
    b.add_mesh([[lo[0], y, lo[2]], [lo[0] + 8 * ext[0], y, lo[2]],
                [lo[0] + 8 * ext[0], y, lo[2] + 8 * ext[2]],
                [lo[0], y, lo[2] + 8 * ext[2]]], [[0, 1, 2], [0, 2, 3]], m)
    return b.build(device=device)


def tlas_box_rays(scene, n, device, seed):
    """n rays from the TLAS root box (every instance's world bounds) +-1,
    normally distributed directions."""
    import numpy as np
    import torch
    box = scene.tlas_nodes[scene.tlas_root, :6].cpu().numpy()
    rng = np.random.default_rng(seed)
    o = rng.uniform(box[:3] - 1, box[3:] + 1, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.as_tensor(o, device=device),
            torch.as_tensor(d, device=device))


def reset_counts(counters):
    for c in counters:
        c.launches = 0
        c.plain = 0


def box_rays(scene, n, device, seed=0):
    """bench.py's Mrays/s rays: origins uniform in the world box +-1,
    normally distributed directions."""
    import numpy as np
    import torch
    tri = scene.tri_all[:, :9].reshape(-1, 3).cpu().numpy()
    rng = np.random.default_rng(seed)
    o = rng.uniform(tri.min(axis=0) - 1, tri.max(axis=0) + 1,
                    (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.as_tensor(o, device=device),
            torch.as_tensor(d, device=device))


def curves_phases(dev, card, build_log, counters, n_rays):
    """Phases 16-20, the hair path: the curve kernel's ptxas report, the
    kernel against its plain version, the hair and hair-ref renders
    through parse_file -> render, times. Returns what the kernels line and
    the summary line need."""
    import numpy as np
    import torch
    from pbrt_tpu_torch.integrators import path as path_mod
    from pbrt_tpu_torch.integrators import render
    from pbrt_tpu_torch.ops import _build
    from pbrt_tpu_torch.ops import bvh8
    from pbrt_tpu_torch.ops import curves
    from pbrt_tpu_torch.ops import megawave
    from pbrt_tpu_torch.ops import tri_intersect as ti
    from pbrt_tpu_torch.scene import parser
    from pbrt_tpu_torch.utils import image
    # ---- 16. the curves library's ptxas report ----
    entries = [ln.strip() for ln in build_log.splitlines()
               if "Function properties" in ln or "stack frame" in ln
               or "registers" in ln]
    print(f"[16 curves build] ptxas: {entries}", flush=True)
    check(not entries or sum("registers" in ln for ln in entries) == 1,
          "curves: ptxas reported other than one entry")

    # ---- 17. curve kernel vs plain on the "hair" tables, 2^20 rays ----
    sys.path.insert(0, str(ROOT / "tools"))
    from hair_scene import hair_scene_text
    t0 = time.perf_counter()
    hair_path = _build.BUILD_DIR / "hair.pbrt"
    hair_path.write_text(hair_scene_text(*HAIR))
    t_gen = time.perf_counter() - t0
    hdesc = parser.parse_file(hair_path, device=dev)
    hair = hdesc.scene
    hair_setup = time.perf_counter() - t0
    ctab = (hair.curve_nodes, hair.curve_segs)
    print(f"[17 curves] hair: {hair.curve_mats.shape[0]} spans, "
          f"{hair.curve_segs.shape[0]} sub-segments "
          f"({4 * hair.curve_segs.numel() / 2**20:.1f} MiB of rows), "
          f"{hair.curve_nodes.shape[0]} nodes, depth {hair.curve_depth}, "
          f"{hair.n_tris} triangles; set-up {hair_setup:.2f} s (text "
          f"{t_gen:.2f} s, parse and build {hair_setup - t_gen:.2f} s)",
          flush=True)
    box = hair.curve_nodes[0, :6].cpu().numpy()
    rng = np.random.default_rng(17)
    o17 = torch.as_tensor(rng.uniform(box[:3] - 1, box[3:] + 1, (n_rays, 3))
                          .astype(np.float32), device=dev)
    d17 = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d17 = torch.as_tensor(d17 / np.linalg.norm(d17, axis=1, keepdims=True),
                          device=dev)
    crv_work, crv_err = {}, 0.0
    for any_hit, t_max in ((False, 1e30), (True, 30.0)):
        tv = torch.full((n_rays,), t_max, device=dev)
        t_k, seg_k = curves.curves_intersect(*ctab, o17, d17, tv, any_hit,
                                             depth=hair.curve_depth)
        t_p, seg_p = curves.curves_intersect_plain(*ctab, o17, d17, tv,
                                                   any_hit)
        torch.cuda.synchronize()
        crv_work[any_hit] = curves.counter.work
        hit_p = seg_p >= 0
        hit_eq = torch.equal(seg_k >= 0, hit_p)
        exact = torch.equal(seg_k, seg_p) and torch.equal(t_k, t_p)
        print(f"[17 curves] any_hit={any_hit}: hit share "
              f"{hit_p.float().mean().item():.4f} of {n_rays} rays, hit "
              f"equal {hit_eq}, t and segment bit-equal {exact}; plain "
              f"work {crv_work[any_hit]}", flush=True)
        check(hit_eq, "curves: the hit flag differs from the plain version")
        if not any_hit:
            check(exact, "curves: t or segment differs from the plain "
                  "version")
            crv_err = (t_k[hit_p] - t_p[hit_p]).abs().max().item() \
                if bool(hit_p.any()) else 0.0
            got = curves.intersect_curves(*ctab, o17, d17, tv,
                                          depth=hair.curve_depth)
            rows = hair.curve_segs[seg_p.clamp(min=0).long()]
            want = curves.segment_test(o17, d17, torch.where(
                hit_p, t_p * 1.0001 + 1e-5, 0.0), rows)
            attrs = all(torch.equal(got[k], want[k]) for k in ("u", "v", "n"))
            cid = torch.equal(got["curve_id"], torch.where(
                hit_p, rows[:, 14].round().long(), -1))
            print(f"[17 curves] u, v, n bit-equal {attrs}, curve id equal "
                  f"{cid}", flush=True)
            check(attrs and cid, "curves: u, v, n or curve id differ")

    # tri_intersect on the hair scene's own pool (ground and light), the
    # same rays, phase 3's gates
    hair_tri_err = 0.0
    for any_hit, t_max in ((False, 1e30), (True, 30.0)):
        tv = torch.full((n_rays,), t_max, device=dev)
        got = ti.tri_intersect(hair.tri_pallas, o17, d17, tv, hair.n_tris,
                               any_hit)
        want = ti.tri_intersect_plain(hair.tri_pallas, o17, d17, tv,
                                      hair.n_tris, any_hit)
        torch.cuda.synchronize()
        same = got[1] == want[1]
        agree = same.float().mean().item()
        hit = same & (want[1] >= 0)
        ok = torch.allclose(got[0][hit], want[0][hit], rtol=1e-5, atol=0)
        err = (got[0][hit] - want[0][hit]).abs().max().item() \
            if bool(hit.any()) else 0.0
        hair_tri_err = max(hair_tri_err, err)
        print(f"[17 tri_intersect] hair's {hair.n_tris} triangles, any_hit="
              f"{any_hit}: prim equal on {agree * 100:.4f}% of {n_rays} "
              f"rays, hit share {(want[1] >= 0).float().mean().item():.4f}, "
              f"t within rel 1e-5 {ok}, max |dt| {err:.3g} where prim equal",
              flush=True)
        check(agree >= 0.9999,
              f"hair tri_intersect prim agreement {agree}")
        check(ok, "hair tri_intersect t differs beyond rtol 1e-5")

    # ---- 18. the hair path through the entry points ----
    reset_counts(counters)
    himg, hstats = render.render(hair, hdesc.camera, sampler=hdesc.sampler,
                                 device=dev,
                                 opts=path_mod.PathOptions(max_depth=5))
    hlaunch = {"curves": curves.counter.launches,
               "tri_intersect": ti.counter.launches,
               "megawave": megawave.counter.launches,
               "bvh8": bvh8.counter.launches}
    hplain = sum(c.plain for c in counters)
    print(f"[18 hair] launches {hlaunch}, plain-version runs {hplain}; "
          f"{hstats['seconds']:.3f} s, {hstats['paths_per_sec']:.6g} "
          f"paths/s, {hstats['lanes_per_wave']} lanes per wave; image mean "
          f"{float(himg.mean()):.6g}", flush=True)
    check(hlaunch["curves"] >= 1 and hlaunch["tri_intersect"] >= 1,
          "hair launched no curve or no triangle kernel")
    check(hlaunch["megawave"] == 0, "hair ran the megakernel")
    check(hplain == 0, "hair ran a plain version on the card")
    check(himg.shape == (HAIR[3], HAIR[2], 3) and bool(np.isfinite(himg).all())
          and float(himg.mean()) > 0, "hair: render output shape or values")
    image.write_exr(_build.BUILD_DIR / "hair_400_16spp.exr", himg)

    # ---- 19. hair-ref against the JAX package's image ----
    ref_path = _build.BUILD_DIR / "hair_ref.pbrt"
    ref_path.write_text(hair_scene_text(*HAIR_REF_SCENE))
    rdesc = parser.parse_file(ref_path, device=dev)
    rimg, rstats = render.render(rdesc.scene, rdesc.camera,
                                 sampler=rdesc.sampler, device=dev,
                                 opts=path_mod.PathOptions(max_depth=5))
    r_mrse, r_ratio = gate(rimg, HAIR_REF, (HAIR_REF_SCENE[3],
                                            HAIR_REF_SCENE[2], 3),
                           HAIR_GATE_MRSE,
                           HAIR_GATE_MEAN_RATIO, "19 hair-ref vs JAX")
    print(f"[19 hair-ref vs JAX] margin: mrse {r_mrse:.6g} is "
          f"{r_mrse / HAIR_GATE_MRSE:.4f} of its gate, mean ratio err "
          f"{r_ratio:.6g} {r_ratio / HAIR_GATE_MEAN_RATIO:.4f} of its gate",
          flush=True)
    image.write_exr(_build.BUILD_DIR / "hair_ref_128_16spp.exr", rimg)

    # ---- 20. times: the curve kernel and its plain version ----
    crv_ms = {}
    for any_hit, t_max in ((False, 1e30), (True, 30.0)):
        tv = torch.full((n_rays,), t_max, device=dev)
        crv_ms[any_hit] = (
            cuda_ms(lambda: curves.curves_intersect(
                *ctab, o17, d17, tv, any_hit, depth=hair.curve_depth),
                reps=20, warmup=3),
            cuda_ms(lambda: curves.curves_intersect_plain(
                *ctab, o17, d17, tv, any_hit), reps=1))
        k_ms, p_ms = crv_ms[any_hit]
        print(f"[20 times] card {card}: curves any_hit={any_hit} kernel "
              f"{k_ms:.4f} ms ({n_rays / k_ms / 1e3:.2f} Mrays/s) vs plain "
              f"{p_ms:.4f} ms ({n_rays / p_ms / 1e3:.3f} Mrays/s)",
              flush=True)
    print(f"[20 times] card {card}: hair {HAIR[2]}x{HAIR[3]}x{HAIR[4]} "
          f"depth 5 {hstats['paths_per_sec']:.6g} paths/s "
          f"({hstats['seconds']:.3f} s), set-up {hair_setup:.2f} s apart; "
          f"hair-ref {rstats['paths_per_sec']:.6g} paths/s", flush=True)

    crv_bound = bound(n_rays * (28 + 8)
                      + 4 * (hair.curve_nodes.numel()
                             + hair.curve_segs.numel()),
                      crv_work[False]["node_visits"] * SLAB_OPS
                      + crv_work[False]["seg_tests"] * SEG_OPS)
    return dict(launches=hlaunch["curves"], err=crv_err, ms=crv_ms,
                bound=crv_bound, tri_launches=hlaunch["tri_intersect"],
                tri_err=hair_tri_err,
                hair=dict(paths_per_sec=hstats["paths_per_sec"],
                          seconds=hstats["seconds"],
                          setup_seconds=hair_setup),
                hair_ref=dict(paths_per_sec=rstats["paths_per_sec"],
                              seconds=rstats["seconds"], mrse=r_mrse,
                              mean_ratio_err=r_ratio))

def ptxas_entries(log):
    return [ln.strip() for ln in log.splitlines()
            if "Function properties" in ln or "stack frame" in ln
            or "registers" in ln]


def rays_in_phases(dev, card, libs, counters, scene, cam, w6, stats):
    """Phases 21-23 and the megakernel times of 25: the ptxas reports, the
    rays-in megakernel against its plain version and against the
    in-kernel-camera megakernel, and its path at full width. Returns what
    the kernels line needs."""
    import torch
    from pbrt_tpu_torch import film as film_mod
    from pbrt_tpu_torch import filters as flt
    from pbrt_tpu_torch import samplers as smp
    from pbrt_tpu_torch.integrators import path as path_mod
    from pbrt_tpu_torch.ops import _build
    from pbrt_tpu_torch.ops import megawave
    from pbrt_tpu_torch.utils import image
    # ---- 21. ptxas reports ----
    for name in ("bvh8_forest", "bvh8_binned", "megawave"):
        entries = ptxas_entries(libs[name][1])
        print(f"[21 build] {name} ptxas: {entries}", flush=True)
        check(not entries or sum("registers" in ln for ln in entries) == 1,
              f"{name}: ptxas reported other than one entry")

    # ---- 22. rays-in megakernel vs plain and vs the full megakernel ----
    filt = flt.make_filter("gaussian")
    sampler = smp.make_sampler("zsobol", spp=64, full_resolution=(400, 400))
    pix = torch.arange(400 * 400, device=dev)
    si = torch.full_like(pix, 37)
    px, py, swl = path_mod.camera_lanes(cam, sampler, pix, si)
    o, d, _wt = path_mod.camera_rays(cam, sampler, filt, px, py, si)
    check(torch.equal(swl.lam, w6.lam), "phase 22 lanes differ from phase 6")
    w22 = megawave.prepare_rays(scene, sampler, px, py, si, o, d, swl.lam,
                                max_depth=5)
    L3, fw3 = megawave.wave_full(w22)
    t0 = time.perf_counter()
    L3p, _ = megawave.wave_full_plain(w22)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    live = megawave.counter.work["live_lane_depths"]
    L2, _fw2 = megawave.wave_full(w6)
    # the in-kernel camera's own rays (the plain version's camera, which
    # phase 6 holds to the kernel's bit for bit) through the rays-in entry
    o2, d2, _fw = megawave._camera_rays(w6, megawave._ZSobol(w6.mi, w6.seeds,
                                                            w6.B))
    L3c, _ = megawave.wave_full(megawave.prepare_rays(
        scene, sampler, px, py, si, torch.stack(o2, -1), torch.stack(d2, -1),
        swl.lam, max_depth=5))
    torch.cuda.synchronize()
    exact = (L3 == L3p).all(dim=1).float().mean().item()
    err = (L3 - L3p).abs().max().item()

    def rel_to_v2(L):
        return ((L - L2).abs() / L2.abs().clamp(min=1e-3)).amax(dim=1)
    rel_same = rel_to_v2(L3c)
    rel = rel_to_v2(L3)
    within = (rel <= 1e-4).float().mean().item()
    v2_exact = (L3 == L2).all(dim=1).float().mean().item()
    print(f"[22 megakernel v1] {L3.shape[0]} lanes, depth 5: bit-equal to "
          f"its plain version on {exact * 100:.4f}% of lanes (max |dL| "
          f"{err:.3g}, plain {plain_s:.3f} s); against the in-kernel-camera "
          f"megakernel on the same lanes and its own camera rays: max rel "
          f"{rel_same.max().item():.3g} (floor 1e-3), bit-equal "
          f"{torch.equal(L3c, L2)}; on the front end's rays, which round "
          f"apart from the in-kernel camera's: {within * 100:.4f}% of lanes "
          f"within rel 1e-4, max rel {rel.max().item():.3g}, bit-equal on "
          f"{v2_exact * 100:.4f}%", flush=True)
    check(fw3 is None and bool(torch.isfinite(L3).all()),
          "megakernel v1 output")
    check(torch.equal(L3, L3p), "megakernel v1 differs from its plain "
          "version")
    check(bool((rel_same <= 1e-4).all()) and torch.equal(L3c, L2),
          "megakernel v1 on the in-kernel camera's rays: not within rel "
          "1e-4 of the in-kernel-camera megakernel on every lane, or not "
          "bit-equal")
    # the front end's rays differ from the in-kernel camera's by ulps,
    # and a few paths then diverge (ROADMAP section 3)
    check(within >= 0.999, "megakernel v1 on the front end's rays: lanes "
          f"within rel 1e-4 of the in-kernel-camera megakernel {within}")

    # ---- 23. the rays-in path at full width ----
    sensor = film_mod.make_pixel_sensor()
    film = film_mod.make_film(400, 400, dev)
    opts = path_mod.PathOptions(max_depth=5, megakernel=True)
    reset_counts(counters.values())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in range(64):
        s_idx = torch.full_like(pix, s)
        px, py, swl = path_mod.camera_lanes(cam, sampler, pix, s_idx)
        o, d, wt = path_mod.camera_rays(cam, sampler, filt, px, py, s_idx)
        L = path_mod.trace_paths(scene, sampler, px, py, s_idx, o, d, swl,
                                 opts)
        film_mod.add_samples(film, pix, film_mod.sensor_to_sensor_rgb(
            sensor, L, swl), wt, identity=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    img = film_mod.get_image(film, sensor)
    launches = {c: k.launches for c, k in counters.items()}
    plain = sum(k.plain for k in counters.values())
    pps = 400 * 400 * 64 / dt
    print(f"[23 rays-in path] launches {launches}, plain-version runs "
          f"{plain}; {dt:.3f} s, {pps:.6g} paths/s (phase 5, in-kernel "
          f"camera: {stats['paths_per_sec']:.6g})", flush=True)
    check(launches["megawave"] == 64 and sum(launches.values()) == 64,
          "the rays-in path launched other than 64 megakernels")
    check(plain == 0, "the rays-in path ran a plain version on the card")
    m, ratio = gate(img, GOLDEN, (400, 400, 3), GATE_MRSE, GATE_MEAN_RATIO,
                    "23 rays-in path golden")
    image.write_exr(_build.BUILD_DIR / "cornell_rays_in_400_64spp.exr", img)

    # ---- 25 (megakernels). times at the main path's wave ----
    k3_ms = cuda_ms(lambda: megawave.wave_full(w22), reps=20, warmup=3)
    k2_ms = cuda_ms(lambda: megawave.wave_full(w6), reps=20, warmup=3)
    k3_plain_ms = cuda_ms(lambda: megawave.wave_full_plain(w22), reps=2)
    print(f"[25 times] card {card}: megakernel v1 (rays in) {k3_ms:.4f} ms "
          f"vs v2 (in-kernel camera) {k2_ms:.4f} ms vs plain "
          f"{k3_plain_ms:.4f} ms per 160,000-lane wave", flush=True)
    n = w22.lam.shape[0]
    # lam, le, mi, o, d in; L out; the pool and its attributes once
    k3_bound = bound(n * (16 + 16 + 4 + 24 + 16)
                     + 4 * (w22.tri.numel() + w22.attr.numel()),
                     live * w22.n_real * TRI_OPS)
    return dict(launches=launches["megawave"], err=err, ms=k3_ms,
                plain_ms=k3_plain_ms, full_camera_ms=k2_ms, bound=k3_bound,
                render=dict(paths_per_sec=pps, seconds=dt, mrse=m,
                            mean_ratio_err=ratio))


def terrain_phases(dev, card):
    """Phases 24 and 25, the paged big-mesh traversal on the terrain.
    Returns what the kernels line needs."""
    import torch
    from pbrt_tpu_torch.ops import bvh as bvh_mod
    from pbrt_tpu_torch.ops import bvh8
    from pbrt_tpu_torch.ops import bvh8_pages as bp
    sys.path.insert(0, str(ROOT / "tools"))
    import terrain_rays
    # ---- 24. the three builds from one binary tree ----
    t0 = time.perf_counter()
    lo, hi, tri = terrain_rays.terrain_triangles(TERRAIN_N)
    t1 = time.perf_counter()
    b = bvh_mod.build_bvh(lo, hi)
    t2 = time.perf_counter()
    forest = bvh8.build_bvh8_forest(lo, hi, tri, binary_bvh=b, device=dev)
    t3 = time.perf_counter()
    chunked = bvh8.build_bvh8_chunked(lo, hi, tri, binary_bvh=b, device=dev)
    t4 = time.perf_counter()
    whole = bvh8.build_bvh8(lo, hi, tri, binary_bvh=b, device=dev)
    torch.cuda.synchronize()
    t5 = time.perf_counter()

    def nbytes(*xs):
        return sum(4 * x.numel() for x in xs)
    f_tables = nbytes(forest.meta, forest.pages, forest.prim_indices)
    c_tables = nbytes(chunked.nodes_f, chunked.nodes_q, chunked.tris,
                      chunked.page_start, chunked.prim_indices)
    w_tables = nbytes(whole.nodes_f, whole.nodes_q, whole.tris,
                      whole.prim_indices)
    print(f"[24 terrain] {len(tri)} triangles (n = {TERRAIN_N}); mesh "
          f"{t1 - t0:.2f} s, binary SAH {t2 - t1:.2f} s; forest {t3 - t2:.2f}"
          f" s: K {forest.n_chunks}, page {forest.page_bytes} B, tables "
          f"{f_tables} B; chunked {t4 - t3:.2f} s: K {chunked.n_chunks}, "
          f"page {chunked.page_bytes} B, tables {c_tables} B; whole-tree "
          f"BVH8 {t5 - t4:.2f} s: {whole.n_nodes} nodes, depth {whole.depth},"
          f" tables {w_tables} B", flush=True)
    V, _F = terrain_rays.make_terrain(TERRAIN_N)
    rays = {kind: tuple(torch.as_tensor(a, device=dev) for a in
                        terrain_rays.gen_rays(V, kind, TERRAIN_RAYS))
            for kind in ("raster", "bounce")}
    modes = ((False, 1e30), (True, 30.0))

    # the kernels on every ray set, counts read around them
    counts = (bp.counter_forest, bp.counter_binned, bvh8.counter)
    reset_counts(counts)
    got, stages = {}, []
    for kind, (o, d) in rays.items():
        for any_hit, t_max in modes:
            tv = torch.full((TERRAIN_RAYS,), t_max, device=dev)
            got[kind, any_hit] = (
                bp.forest_intersect(forest, o, d, tv, any_hit),
                bp.binned_intersect(chunked, o, d, tv, any_hit,
                                    stages=stages if (kind, any_hit) ==
                                    ("raster", False) else None),
                bvh8.bvh8_intersect(whole, o, d, tv, any_hit))
    torch.cuda.synchronize()
    launches = dict(forest=bp.counter_forest.launches,
                    binned=bp.counter_binned.launches,
                    bvh8=bvh8.counter.launches)
    plain = sum(c.plain for c in counts)
    rounds = {k: v[1]["rounds"] for k, v in got.items()}
    print(f"[24 terrain] launches {launches}, plain-version runs {plain}; "
          f"binned rounds {rounds}; plain versions on (set: rays) "
          f"{TERRAIN_PLAIN}", flush=True)
    check(launches["forest"] == 4 and launches["bvh8"] == 4
          and launches["binned"] == sum(rounds.values()) and plain == 0,
          "terrain: launch counts")

    # each paged kernel against its plain version
    work, plain_ms, errs = {}, {}, {"forest": [0.0], "binned": [0.0]}
    for (kind, any_hit), n in TERRAIN_PLAIN.items():
        sub = slice((TERRAIN_RAYS - n) // 2, (TERRAIN_RAYS + n) // 2)
        o, d = rays[kind][0][sub], rays[kind][1][sub]
        tv = torch.full((n,), 30.0 if any_hit else 1e30, device=dev)
        gf, gb, _gw = ({k: v[sub] if torch.is_tensor(v) else v
                        for k, v in g.items()}
                       for g in got[kind, any_hit])
        for name, fn in (
                ("forest", lambda: bp.forest_intersect_plain(
                    forest, o, d, tv, any_hit)),
                ("binned", lambda: bp.binned_intersect_plain(
                    chunked, o, d, tv, any_hit)[:4]),
                ("bvh8", lambda: bvh8.bvh8_intersect_plain(
                    whole, o, d, tv, any_hit))):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            want = fn()
            ev[1].record()
            ev[1].synchronize()
            plain_ms[name, kind, any_hit] = ev[0].elapsed_time(ev[1])
            work[name, kind, any_hit] = dict(
                {"forest": bp.counter_forest, "binned": bp.counter_binned,
                 "bvh8": bvh8.counter}[name].work)
            if name == "bvh8":
                continue
            k = gf if name == "forest" else gb
            hit_eq = torch.equal(k["hit"], want[1] >= 0)
            exact = all(torch.equal(k[key], v) for key, v in
                        zip(("t", "prim", "b1", "b2"), want))
            hit_w = want[1] >= 0
            if bool(hit_w.any()):
                errs[name].append((k["t"][hit_w] - want[0][hit_w])
                                  .abs().max().item())
            print(f"[24 {name}] {kind} any_hit={any_hit}: kernel vs "
                  f"plain on {n} rays: hit equal {hit_eq}, t, triangle, "
                  f"b1, b2 bit-equal {exact}; hit share "
                  f"{hit_w.float().mean().item():.4f}; plain "
                  f"{plain_ms[name, kind, any_hit]:.1f} ms, work "
                  f"{work[name, kind, any_hit]}", flush=True)
            check(hit_eq, f"{name}: the hit flag differs from the plain "
                  "version")
            if not any_hit:
                check(exact, f"{name}: t, triangle or barycentrics "
                      "differ from the plain version")

    # both against the whole-tree kernel on all rays
    for (kind, any_hit), (gf, gb, gw) in got.items():
        for name, k in (("forest", gf), ("binned", gb)):
            hit_eq = (k["hit"] == gw["hit"]).float().mean().item()
            same = k["prim"] == gw["prim"]
            agree = same.float().mean().item()
            h = same & gw["hit"]
            t_eq = torch.equal(k["t"][h], gw["t"][h])
            print(f"[24 {name} vs bvh8] {kind} any_hit={any_hit}: hit equal"
                  f" on {hit_eq * 100:.4f}% of {TERRAIN_RAYS} rays (hit share"
                  f" {gw['hit'].float().mean().item():.4f}), triangle equal "
                  f"on {agree * 100:.4f}%, t equal where the triangle is "
                  f"equal {t_eq}", flush=True)
            check(hit_eq == 1.0, f"{name}: hit flag differs from bvh8")
            if not any_hit:
                check(agree >= 0.9999 and t_eq,
                      f"{name}: triangle or t differs from bvh8")

    # ---- 25 (paged). times ----
    ms = {}
    for kind, (o, d) in rays.items():
        for any_hit, t_max in modes:
            tv = torch.full((TERRAIN_RAYS,), t_max, device=dev)
            ms["forest", kind, any_hit] = cuda_ms(
                lambda: bp.forest_intersect(forest, o, d, tv, any_hit),
                reps=3)
            # (phase 24 ran it once already: no warm-up)
            ms["binned", kind, any_hit] = cuda_ms(
                lambda: bp.binned_intersect(chunked, o, d, tv, any_hit),
                reps=1, warmup=0)
            ms["bvh8", kind, any_hit] = cuda_ms(
                lambda: bvh8.bvh8_intersect(whole, o, d, tv, any_hit),
                reps=10, warmup=2)
            p_ms = ", ".join(
                f"{name} {plain_ms[name, kind, any_hit]:.1f}"
                for name in ("forest", "binned", "bvh8")) \
                if (kind, any_hit) in TERRAIN_PLAIN else "not run"
            print(f"[25 times] card {card}: terrain {kind} any_hit="
                  f"{any_hit}, {TERRAIN_RAYS} rays: forest kernel "
                  f"{ms['forest', kind, any_hit]:.4f} ms, binned query "
                  f"{ms['binned', kind, any_hit]:.4f} ms ("
                  f"{got[kind, any_hit][1]['rounds']} rounds), whole-tree "
                  f"bvh8 {ms['bvh8', kind, any_hit]:.4f} ms; plain on "
                  f"{TERRAIN_PLAIN.get((kind, any_hit), 0)} rays: {p_ms} "
                  "ms", flush=True)
    per = {}
    for name, a, z in stages:
        per.setdefault(name, []).append(a.elapsed_time(z))
    f_copies = work["forest", "raster", False]["page_copies"]
    b_copies = got["raster", False][1]["page_copies"]
    print(f"[25 times] card {card}: binned raster closest: "
          f"{len(per['round'])} rounds x 1 launch, round kernels "
          f"{[round(x, 4) for x in per['round']]} ms (sum "
          f"{sum(per['round']):.4f}), pre-pass {sum(per['entries']):.4f} ms "
          f"in {len(per['entries'])} runs, schedule "
          f"{sum(per['schedule']):.4f} ms", flush=True)
    print(f"[25 times] card {card}: page bytes staged, raster closest: "
          f"forest {f_copies} copies x {forest.page_bytes} B = "
          f"{f_copies * forest.page_bytes} B (tables {f_tables} B); binned "
          f"{b_copies} copies x {chunked.page_bytes} B = "
          f"{b_copies * chunked.page_bytes} B (tables {c_tables} B)",
          flush=True)
    # bounds of the raster closest-hit query: rays in (o, d, t_max) and
    # hits out (t, prim, b1, b2) once, tables once; the work the plain
    # versions counted on all of its rays
    wf, wb = work["forest", "raster", False], work["binned", "raster", False]
    f_bound = bound(TERRAIN_RAYS * 44 + nbytes(forest.meta, forest.pages),
                    wf["root_tests"] * SLAB_OPS + wf["node_visits"] * 8
                    * FOREST_CHILD_OPS + wf["tri_tests"] * TRI_OPS)
    b_bound = bound(TERRAIN_RAYS * 44
                    + nbytes(chunked.nodes_f, chunked.nodes_q, chunked.tris,
                             chunked.page_start),
                    wb["root_tests"] * SLAB_OPS + wb["node_visits"] * 8
                    * BVH8_CHILD_OPS + wb["tri_tests"] * TRI_OPS)
    return dict(
        forest=dict(launches=launches["forest"], err=max(errs["forest"]),
                    ms=ms["forest", "raster", False],
                    plain_ms=plain_ms["forest", "raster", False],
                    bound=f_bound, ms_all={f"{k}_{'any' if a else 'closest'}":
                                           ms["forest", k, a]
                                           for k, _ in rays.items()
                                           for a, _t in modes},
                    page_copies=f_copies),
        binned=dict(launches=launches["binned"], err=max(errs["binned"]),
                    ms=sum(per["round"]),
                    query_ms=ms["binned", "raster", False],
                    plain_ms=plain_ms["binned", "raster", False],
                    bound=b_bound, rounds=len(per["round"]),
                    entries_ms=sum(per["entries"]),
                    schedule_ms=sum(per["schedule"]),
                    ms_all={f"{k}_{'any' if a else 'closest'}":
                            ms["binned", k, a] for k, _ in rays.items()
                            for a, _t in modes},
                    page_copies=b_copies),
        bvh8_ms={f"{k}_{'any' if a else 'closest'}": ms["bvh8", k, a]
                 for k, _ in rays.items() for a, _t in modes})


def probe_phases(dev, card, build_log, forest_ms):
    """Phases 26-28, the page-copy probes: the ptxas report, every probe
    configuration x copy path against its plain version and the TPU
    checks' values, the timed matrix. Returns the four entries of the
    kernels line."""
    import numpy as np
    import torch
    from pbrt_tpu_torch.ops import dma_probe as dp
    sys.path.insert(0, str(ROOT / "tools"))
    import torch_dma_probe as tool
    # ---- 26. the dma_probe library's ptxas report ----
    entries = ptxas_entries(build_log)
    print(f"[26 dma_probe build] ptxas: {entries}", flush=True)
    check(sum("registers" in ln for ln in entries) == 4,
          "dma_probe: ptxas reported other than four entries (no report at "
          "all when the library was built before this run: remove "
          "pbrt_tpu_torch/_build)")

    # ---- 27. every configuration x copy path, at the TPU tools' size ----
    kernel_of = {"var": "dma_var", "min": "dma_ladder"}
    errs = dict.fromkeys(("dma_var", "dma_sched_pipelined",
                          "dma_sched_manual", "dma_ladder"), 0.0)

    def hold(name, got, want, label):
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        errs[name] = max(errs[name], err)
        check(torch.equal(got, want),
              f"{label}: differs from its plain version (max |d| {err})")

    configs = tool.configurations()
    check(len(configs) == 14, "the TPU tools have 14 configurations")
    for probe, which in configs:
        name = kernel_of.get(probe) or f"dma_sched_{tool.VAR2[which]}"
        want_tpu = np.float32(PROBE_VALUES[probe] if probe != "min"
                              else PROBE_VALUES[probe][which >= 3])
        want = tool.run_plain(probe, which, device=dev)
        for copy in dp.COPIES:
            out, got, exp = tool.run_probe(probe, which, copy, device=dev)
            label = f"27 {probe} {which} copy={copy}"
            hold(name, out, want, label)
            per_block = got.mean(axis=1) if probe == "min" else got[:, 0]
            check(bool((got == exp[:, None]).all())
                  and np.array_equal(per_block, np.atleast_1d(want_tpu)),
                  f"{label}: {per_block} is not the TPU check's value "
                  f"{want_tpu}")
        print(f"[27 probes] {probe} {which} ({name}): ld, cp_async, bulk "
              f"bit-equal to the plain version; value "
              f"{np.atleast_1d(want_tpu).tolist()} as the TPU check",
              flush=True)
    # the paged kernels' sizes, whole pages summed: K = 420 pages of small
    # integers, 64 blocks of 20 seeded entries
    K, B, P = tool.K_MATRIX, 64, tool.P_MATRIX
    for mode, R in (("pipelined", tool.R_TWO), ("manual", tool.R_CHUNKED),
                    ("manual", tool.R_FOREST)):
        pages = dp.make_pages(K, R, dev, fill="small")
        x = torch.ones((B * 8, 128), device=dev)
        sched = dp.probe_schedule("seeded", B, P, K, dev, seed=27)
        lad = dp.probe_schedule("min", B, P, K, dev)
        want = dp.dma_sched_plain(pages, x, sched, P, "sum")
        want_l = dp.dma_ladder_plain(pages, x, lad, P, 4, "sum")
        want_v = dp.dma_var_plain(pages, x[:8], "sum")
        for copy in dp.COPIES:
            label = f"27 {R} rows copy={copy}"
            hold(f"dma_sched_{mode}", dp.dma_sched(
                pages, x, sched, P, mode=mode, copy=copy, reduce="sum"),
                want, f"{label} {mode}")
            if mode == "manual":
                hold("dma_ladder", dp.dma_ladder(
                    pages, x, lad, P, 4, copy=copy, reduce="sum"), want_l,
                    f"{label} ladder")
                hold("dma_var", dp.dma_var(
                    pages, x[:8], "hbm_vmem_slice", copy=copy, reduce="sum"),
                    want_v, f"{label} var")
        print(f"[27 probes] {R} rows ({R * dp.ROW_BYTES} B pages), K {K}, "
              f"reduce=sum, {B} blocks x {P} entries: {mode}"
              f"{', ladder stage 4, var' if mode == 'manual' else ''} "
              f"bit-equal to the plain versions on every copy path; tile "
              f"sums up to {want.max().item():.0f} (< 2^24)", flush=True)
        check(want.max().item() < (1 << 24), "tile sums are not exact")
        del pages

    # ---- 28. the timed matrix ----
    counts = dict(dma_var=dp.counter_var,
                  dma_sched_pipelined=dp.counter_pipelined,
                  dma_sched_manual=dp.counter_manual,
                  dma_ladder=dp.counter_ladder)
    reset_counts(counts.values())
    t0 = time.perf_counter()
    rows = tool.run_matrix(dev, emit=lambda s: print(f"[28 matrix] {s}",
                                                     flush=True))
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counts.items()}
    plain = sum(c.plain for c in counts.values())
    print(f"[28 matrix] {len(rows)} rows in {time.perf_counter() - t0:.1f} "
          f"s; launches {launches}, plain-version runs through a wrapper "
          f"{plain}. bound_ms: bytes staged over 3.35 TB/s; the 420 pages of "
          "298 and 378 rows (64 and 81 MB) exceed the 50 MB L2, the 16-row "
          "pages (3.4 MB) and dma_var's one page stay in it; library_ms: "
          "torch.index_select, which also writes the pages back (twice the "
          "bytes)", flush=True)
    check(all(r["equals_plain"] for r in rows),
          "a matrix row differs from its plain version")
    check(min(launches.values()) >= 1 and plain == 0,
          "the matrix launched no kernel of some probe")

    def row(probe, mode, R, copy, reduce, P=None, kind=None):
        return next(r for r in rows if (r["probe"], r["mode"], r["rows"],
                                        r["copy"], r["reduce"]) ==
                    (probe, mode, R, copy, reduce)
                    and (P is None or r["P"] == P)
                    and (kind is None or r["schedule"] == kind))

    # the finding: do plain loads set the forest kernel's time, and what
    # does the best copy path gain over them at each size
    ld = row("sched", "manual", tool.R_FOREST, "ld", "first")
    print(f"[28 finding] card {card}: ld, copy alone, {ld['copies']} copies "
          f"x {ld['page_bytes']} B = {ld['staged_bytes']} B in "
          f"{ld['ms']:.4f} ms ({ld['gb_per_s']:.1f} GB/s); the forest "
          f"kernel's raster query, which stages the same bytes and walks "
          f"them, {forest_ms:.4f} ms in this run: the copies alone are "
          f"{ld['ms'] / forest_ms * 100:.1f}% of it", flush=True)
    # the same with every block walking its pages in ascending order, the
    # forest kernel's order (its blocks do not start a page together, so
    # this is nearer to its traffic, not equal to it)
    ordered = row("sched", "manual", tool.R_FOREST, "ld", "first",
                  kind="ordered")
    print(f"[28 finding] card {card}: ld, copy alone, pages in ascending "
          f"order in every block: {ordered['ms']:.4f} ms "
          f"({ordered['gb_per_s']:.1f} GB/s), "
          f"{ordered['ms'] / forest_ms * 100:.1f}% of the forest kernel's "
          f"{forest_ms:.4f} ms; in any order {ld['ms']:.4f} ms", flush=True)
    for probe, mode, R, P, kind in tool.matrix_cases():
        for reduce in dp.REDUCES:
            ms = {c: row(probe, mode, R, c, reduce, P, kind)["ms"]
                  for c in dp.COPIES}
            best = min(ms, key=ms.get)
            print(f"[28 finding] card {card}: {probe} {mode} at {R} rows, "
                  f"{P} entries a block, {kind} schedule, reduce={reduce}: "
                  f"ld {ms['ld']:.4f}, cp_async "
                  f"{ms['cp_async']:.4f}, bulk {ms['bulk']:.4f} ms; best "
                  f"{best}, {ms['ld'] / ms[best]:.3f}x over ld", flush=True)

    def entry(name, probe, mode, R, replaces, kind):
        """The kernels-line entry of one probe: its fastest copy path at R
        rows with the page read in full (reduce=sum). The bound is the
        function's, not the harness's: the pages the schedule names, the
        schedule and x read once and out written once, against one add a
        float of those pages and one a schedule entry (a page that several
        blocks stage is needed once)."""
        by = {f"{c}_{red}": row(probe, mode, R, c, red, kind=kind)["ms"]
              for c in dp.COPIES for red in dp.REDUCES}
        best = min((row(probe, mode, R, c, "sum", kind=kind)
                    for c in dp.COPIES), key=lambda r: r["ms"])
        n_pages = 1 if probe == "var" else min(best["K"], best["copies"])
        n_sched = 0 if probe == "var" else best["copies"]
        b_ms, b_by = bound(n_pages * best["page_bytes"] + 4 * n_sched
                           + 2 * best["B"] * 8 * 128 * 4,
                           n_pages * R * 128 + max(n_sched, 1))
        print(f"[bounds] card {card}: {name} ({best['copy']}, {R} rows) "
              f"bound {b_ms:.5f} ms by {b_by}, kernel {best['ms']:.4f} ms "
              f"({b_ms / best['ms'] * 100:.2f}% of the bound); bytes staged "
              f"over the memory rate {best['bound_ms']:.4f} ms", flush=True)
        return dict(name=name, route="cuda",
                    source="pbrt_tpu_torch/csrc/dma_probe.cu",
                    replaces=replaces, launches=launches[name],
                    max_abs_err=errs[name], ms=best["ms"],
                    plain_ms=best["plain_ms"], bound_ms=b_ms, bound_by=b_by,
                    library_ms=best["library_ms"], copy=best["copy"],
                    rows=R, copies=best["copies"],
                    staged_bytes=best["staged_bytes"],
                    staged_bound_ms=best["bound_ms"], ms_by_copy=by)
    # launches: phase 28's matrix; ms: the fastest copy path with the page
    # read in full, at the forest's page (226 rows for the two buffers of
    # the pipelined probe); every path's time in ms_by_copy
    return [
        entry("dma_var", "var", "hbm_vmem_slice", tool.R_FOREST,
              "tools/exp_dma_var.py:77", "fixed"),
        entry("dma_sched_pipelined", "sched", "pipelined", tool.R_TWO,
              "tools/exp_dma_var2.py:49", "seeded"),
        entry("dma_sched_manual", "sched", "manual", tool.R_FOREST,
              "tools/exp_dma_var2.py:77", "seeded"),
        entry("dma_ladder", "ladder", "stage4", tool.R_FOREST,
              "tools/exp_dma_min.py:82", "min")]


def patches_phases(dev, card, named):
    """Phases 29-30, the patches path: scenes/patches.pbrt through
    parse_file -> render, gated against its golden; its time."""
    import torch
    from pbrt_tpu_torch.integrators import path as path_mod
    from pbrt_tpu_torch.integrators import render
    from pbrt_tpu_torch.ops import _build
    from pbrt_tpu_torch.scene import parser
    from pbrt_tpu_torch.utils import image
    # ---- 29. the patches path through the entry points ----
    reset_counts(named.values())
    t0 = time.perf_counter()
    desc = parser.parse_file(PATCH_SCENE, device=dev)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    check(desc.scene.has_blps and desc.scene.blp_rows.shape == (12, 14)
          and desc.scene.n_tris == 2, "patches: scene tables")
    img, stats = render.render(desc.scene, desc.camera, sampler=desc.sampler,
                               device=dev,
                               opts=path_mod.PathOptions(max_depth=3))
    launches = {c: k.launches for c, k in named.items()}
    plain = sum(k.plain for k in named.values())
    print(f"[29 patches] {desc.scene.blp_rows.shape[0]} exact patches (tensor"
          f" code, every ray against every patch), {desc.scene.n_tris} "
          f"triangles; launches {launches}, plain-version runs {plain}; "
          f"{stats['lanes_per_wave']} lanes per wave", flush=True)
    check(launches["tri_intersect"] >= 1
          and sum(launches.values()) == launches["tri_intersect"],
          "patches left the triangle-kernel route")
    check(plain == 0, "patches ran a plain version on the card")
    m, ratio = gate(img, PATCH_GOLDEN, (200, 200, 3), PATCH_GATE_MRSE,
                    PATCH_GATE_MEAN_RATIO, "29 patches golden")
    image.write_exr(_build.BUILD_DIR / "patches_200_32spp.exr", img)
    # ---- 30. its time ----
    print(f"[30 times] card {card}: patches 200x200x32 depth 3 "
          f"{stats['paths_per_sec']:.6g} paths/s ({stats['seconds']:.3f} s),"
          f" set-up (parse and build) {setup:.3f} s apart", flush=True)
    return dict(paths_per_sec=stats["paths_per_sec"],
                seconds=stats["seconds"], mrse=m, mean_ratio_err=ratio,
                tri_launches=launches["tri_intersect"])


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import numpy as np
    from pbrt_tpu_torch import filters as flt
    from pbrt_tpu_torch import native
    from pbrt_tpu_torch import samplers as smp
    from pbrt_tpu_torch import scenes
    from pbrt_tpu_torch.integrators import path as path_mod
    from pbrt_tpu_torch.integrators import render
    from pbrt_tpu_torch.ops import _build
    from pbrt_tpu_torch.ops import bvh as bvh_mod
    from pbrt_tpu_torch.ops import bvh2
    from pbrt_tpu_torch.ops import bvh8
    from pbrt_tpu_torch.ops import bvh8_pages as bp
    from pbrt_tpu_torch.ops import curves
    from pbrt_tpu_torch.ops import dma_probe as dp
    from pbrt_tpu_torch.ops import megawave
    from pbrt_tpu_torch.ops import tri_intersect as ti
    from pbrt_tpu_torch.scene import parser
    from pbrt_tpu_torch.utils import image
    from pbrt_tpu_torch.utils import spectrum as spc
    named = {"megawave": megawave.counter, "tri_intersect": ti.counter,
             "bvh8": bvh8.counter, "bvh2": bvh2.counter_bvh2,
             "two_level": bvh2.counter_two_level, "curves": curves.counter,
             "bvh8_forest": bp.counter_forest,
             "bvh8_binned": bp.counter_binned,
             "dma_var": dp.counter_var,
             "dma_sched_pipelined": dp.counter_pipelined,
             "dma_sched_manual": dp.counter_manual,
             "dma_ladder": dp.counter_ladder}
    counters = tuple(named.values())

    dev = torch.device("cuda", 0)

    # ---- 1. start ----
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "--id=0"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip()
    print(f"[1 start] card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)

    # ---- 2. build ----
    t0 = time.perf_counter()
    libs = _build.build()
    dt = time.perf_counter() - t0
    for name, (lib_path, log) in libs.items():
        _build.load_library(name)
        regs = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"[2 build] {lib_path.name} (nvcc sm_90a -fmad=false); "
              f"ptxas: {regs}", flush=True)
    print(f"[2 build] {len(libs)} kernel libraries in {dt:.2f} s, one "
          "nvcc per source started together", flush=True)
    t0 = time.perf_counter()
    native_path, _log = native.build()
    native.load_library()
    print(f"[2 build] host BVH builder {native_path.name} (g++ "
          f"{' '.join(native.GXX_FLAGS)}, pbrt_tpu_torch/csrc/host/*.cpp) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # ---- 3. tri_intersect kernel vs plain, 1M rays ----
    scene, cam = scenes.make_cornell_box(400, 400, device=dev)
    n_real = scene.mega.n_tris
    o, d, t_any = seeded_rays(1 << 20, dev)
    far = torch.full_like(t_any, 1e30)
    tri_err = 0.0
    for any_hit, t_max in ((False, far), (True, t_any)):
        got = ti.tri_intersect(scene.tri_pallas, o, d, t_max, n_real,
                               any_hit)
        want = ti.tri_intersect_plain(scene.tri_pallas, o, d, t_max,
                                      n_real, any_hit)
        torch.cuda.synchronize()
        same = got[1] == want[1]
        agree = same.float().mean().item()
        check(agree >= 0.9999, f"tri_intersect prim agreement {agree}")
        hit = same & (want[1] >= 0)
        ok = torch.allclose(got[0][hit], want[0][hit], rtol=1e-5, atol=0)
        check(ok, "tri_intersect t differs beyond rtol 1e-5")
        err = (got[0][hit] - want[0][hit]).abs().max().item()
        tri_err = max(tri_err, err)
        print(f"[3 tri_intersect] any_hit={any_hit}: prim equal on "
              f"{agree * 100:.4f}% of {o.shape[0]} rays, hit share "
              f"{(want[1] >= 0).float().mean().item():.3f}, max |dt| "
              f"{err:.3g} where prim equal", flush=True)

    # ---- 4. megakernel vs plain, 64x64, 16 spp, depth 5 ----
    W4, SPP4 = 64, 16
    scene4, cam4 = scenes.make_cornell_box(W4, W4, device=dev)
    sampler4 = smp.make_sampler("zsobol", spp=SPP4, full_resolution=(W4, W4))
    pix = torch.arange(W4 * W4, device=dev).repeat(SPP4)
    si = torch.arange(W4 * W4 * SPP4, device=dev) // (W4 * W4)
    px, py = pix % W4, pix // W4
    lam = spc.sample_visible_wavelengths(
        smp.sample_1d(sampler4, px, py, si, 5)).lam
    w4 = megawave.prepare_full(scene4, sampler4, cam4,
                               flt.make_filter("gaussian"), px, py, si, lam,
                               max_depth=5)
    mw_err = compare_wave(w4, "4 megakernel 64x64x16")

    # ---- 5. the main path: render cornell 400x400, 64 spp, depth 5 ----
    reset_counts(counters)
    img, stats = render.render(scene, cam, spp=64, device=dev,
                               opts=path_mod.PathOptions(max_depth=5))
    launches = {"megawave": megawave.counter.launches,
                "tri_intersect": ti.counter.launches}
    plain_runs = sum(c.plain for c in counters)
    print(f"[5 render] launches {launches}, plain-version runs "
          f"{plain_runs}; {stats['seconds']:.3f} s, "
          f"{stats['paths_per_sec']:.6g} paths/s, "
          f"{stats['lanes_per_wave']} lanes per wave", flush=True)
    check(launches["megawave"] >= 1, "main path launched no megakernel")
    check(plain_runs == 0, "main path ran a plain version on the card")
    check(img.shape == (400, 400, 3) and bool(np.isfinite(img).all()),
          "render output shape or values")
    ref = image.read_exr(GOLDEN)
    m = mrse(img, ref)
    ratio = abs(float(img.mean()) / max(float(ref.mean()), 1e-9) - 1.0)
    out_path = _build.BUILD_DIR / "cornell_400_64spp.exr"
    image.write_exr(out_path, img)
    print(f"[5 golden] mrse {m:.5f} (gate {GATE_MRSE}), mean ratio err "
          f"{ratio:.5f} (gate {GATE_MEAN_RATIO}); image -> "
          f"{out_path.relative_to(ROOT)}", flush=True)
    check(m <= GATE_MRSE and ratio <= GATE_MEAN_RATIO, "golden gate")

    # ---- 6. the main path's wave: 400x400 x 1 sample (sample index 37
    # of 64, so the spp bits of the index are not all zero), held to the
    # plain version, then timed ----
    n_pix = 400 * 400
    sampler = smp.make_sampler("zsobol", spp=64, full_resolution=(400, 400))
    pix = torch.arange(n_pix, device=dev)
    si = torch.full_like(pix, 37)
    px, py = pix % 400, pix // 400
    lam = spc.sample_visible_wavelengths(
        smp.sample_1d(sampler, px, py, si, 5)).lam
    w6 = megawave.prepare_full(scene, sampler, cam,
                               flt.make_filter("gaussian"), px, py, si, lam,
                               max_depth=5)
    mw_err = max(mw_err, compare_wave(w6, "6 megakernel 400x400x1"))
    mw_live = megawave.counter.work["live_lane_depths"]
    mw_ms = cuda_ms(lambda: megawave.wave_full(w6), reps=20, warmup=3)
    mw_plain_ms = cuda_ms(lambda: megawave.wave_full_plain(w6), reps=3)
    o6, d6, _t = seeded_rays(n_pix, dev, seed=8)
    far6 = torch.full_like(_t, 1e30)
    ti_ms = cuda_ms(lambda: ti.tri_intersect(scene.tri_pallas, o6, d6, far6,
                                             n_real, False), reps=50,
                    warmup=3)
    ti_plain_ms = cuda_ms(lambda: ti.tri_intersect_plain(
        scene.tri_pallas, o6, d6, far6, n_real, False), reps=5)
    print(f"[6 times] card {card}: megakernel {mw_ms:.4f} ms/wave vs plain "
          f"{mw_plain_ms:.4f} ms ({n_pix} lanes, depth 5); tri_intersect "
          f"{ti_ms:.4f} ms vs plain {ti_plain_ms:.4f} ms ({n_pix} rays); "
          f"render {stats['paths_per_sec']:.6g} paths/s", flush=True)

    # ---- 7. BVH8 kernel vs plain, meshfield, 2^20 rays ----
    mesh = parser.parse_file(MESH_SCENE, device=dev).scene
    b8 = mesh.bvh8
    print(f"[7 bvh8] meshfield: {mesh.n_tris} triangles, {b8.n_nodes} "
          f"nodes, depth {b8.depth}", flush=True)
    n_rays = 1 << 20
    o7, d7 = box_rays(mesh, n_rays, dev)
    b8_err = 0.0
    for any_hit, t_max in ((False, 1e30), (True, 30.0)):
        got = bvh8.bvh8_intersect(b8, o7, d7, t_max, any_hit)
        t_p, prim_p, _b1, _b2 = bvh8.bvh8_intersect_plain(
            b8, o7, d7, torch.full((n_rays,), t_max, device=dev), any_hit)
        torch.cuda.synchronize()
        if not any_hit:
            b8_work = bvh8.counter.work
        hit_agree = (got["hit"] == (prim_p >= 0)).float().mean().item()
        same = got["prim"] == prim_p
        agree = same.float().mean().item()
        hit = same & (prim_p >= 0)
        t_exact = torch.equal(got["t"][hit], t_p[hit])
        err = (got["t"][hit] - t_p[hit]).abs().max().item() \
            if bool(hit.any()) else 0.0
        b8_err = max(b8_err, err)
        print(f"[7 bvh8] any_hit={any_hit}: hit equal on "
              f"{hit_agree * 100:.4f}%, prim equal on {agree * 100:.4f}% of "
              f"{n_rays} rays, hit share "
              f"{(prim_p >= 0).float().mean().item():.4f}, t bit-equal "
              f"where prim equal: {t_exact}, max |dt| {err:.3g}", flush=True)
        check(hit_agree >= 0.9999, f"bvh8 hit agreement {hit_agree}")
        if not any_hit:
            check(agree >= 0.9999, f"bvh8 prim agreement {agree}")
            check(t_exact, "bvh8 t differs where prim is equal")

    # ---- 8. meshfield through the entry points ----
    reset_counts(counters)
    desc = parser.parse_file(MESH_SCENE, device=dev)
    mimg, mstats = render.render(desc.scene, desc.camera,
                                 sampler=desc.sampler, device=dev,
                                 opts=path_mod.PathOptions(max_depth=4))
    mlaunch = {c: k.launches for c, k in (("bvh8", bvh8.counter),
                                          ("tri_intersect", ti.counter),
                                          ("megawave", megawave.counter))}
    mplain = sum(c.plain for c in counters)
    print(f"[8 meshfield] launches {mlaunch}, plain-version runs {mplain}; "
          f"{mstats['seconds']:.3f} s, {mstats['paths_per_sec']:.6g} "
          f"paths/s, {mstats['lanes_per_wave']} lanes per wave", flush=True)
    check(mlaunch["bvh8"] >= 1, "meshfield launched no BVH8 kernel")
    check(mlaunch["tri_intersect"] == 0 and mlaunch["megawave"] == 0,
          "meshfield left the BVH8 route")
    check(mplain == 0, "meshfield ran a plain version on the card")
    m_mrse, m_ratio = gate(mimg, MESH_GOLDEN, (200, 200, 3), MESH_GATE_MRSE,
                           MESH_GATE_MEAN_RATIO, "8 meshfield golden")
    image.write_exr(_build.BUILD_DIR / "meshfield_200_32spp.exr", mimg)

    # ---- 9. cornell through the general wave ----
    reset_counts(counters)
    gimg, gstats = render.render(
        scene, cam, spp=64, device=dev,
        opts=path_mod.PathOptions(max_depth=5, megakernel=False))
    glaunch = {"tri_intersect": ti.counter.launches,
               "megawave": megawave.counter.launches,
               "bvh8": bvh8.counter.launches}
    gplain = sum(c.plain for c in counters)
    print(f"[9 cornell general] launches {glaunch}, plain-version runs "
          f"{gplain}; {gstats['seconds']:.3f} s, "
          f"{gstats['paths_per_sec']:.6g} paths/s", flush=True)
    check(glaunch["tri_intersect"] >= 1,
          "general-wave cornell launched no triangle kernel")
    check(glaunch["megawave"] == 0 and glaunch["bvh8"] == 0,
          "general-wave cornell left the triangle-kernel route")
    check(gplain == 0, "general-wave cornell ran a plain version")
    g_mrse, g_ratio = gate(gimg, GOLDEN, (400, 400, 3), GATE_MRSE,
                           GATE_MEAN_RATIO, "9 cornell general golden")
    image.write_exr(_build.BUILD_DIR / "cornell_general_400_64spp.exr", gimg)

    # ---- 10. times: BVH8 kernel and plain at 2^20 rays ----
    b8_ms = {}
    for any_hit, t_max in ((False, 1e30), (True, 30.0)):
        tv = torch.full((n_rays,), t_max, device=dev)
        k_ms = cuda_ms(lambda: bvh8.bvh8_intersect(b8, o7, d7, tv, any_hit),
                       reps=20, warmup=3)
        p_ms = cuda_ms(lambda: bvh8.bvh8_intersect_plain(b8, o7, d7, tv,
                                                         any_hit), reps=2)
        b8_ms[any_hit] = (k_ms, p_ms)
        print(f"[10 times] card {card}: bvh8 any_hit={any_hit} kernel "
              f"{k_ms:.4f} ms ({n_rays / k_ms / 1e3:.2f} Mrays/s) vs plain "
              f"{p_ms:.4f} ms ({n_rays / p_ms / 1e3:.3f} Mrays/s), {n_rays} "
              "rays", flush=True)
    print(f"[10 times] card {card}: meshfield 200x200x32 "
          f"{mstats['paths_per_sec']:.6g} paths/s; cornell general wave "
          f"400x400x64 {gstats['paths_per_sec']:.6g} paths/s; cornell "
          f"megakernel {stats['paths_per_sec']:.6g} paths/s", flush=True)

    # ---- 11. the bvh2 library's ptxas report ----
    # (an empty log: the library was built before this run)
    entries = [ln.strip() for ln in libs["bvh2"][1].splitlines()
               if "Function properties" in ln or "stack frame" in ln
               or "registers" in ln]
    print(f"[11 bvh2 build] ptxas, single- and two-level entries: {entries}",
          flush=True)
    check(not entries or sum("registers" in ln for ln in entries) == 2,
          "bvh2: ptxas reported other than two entries")

    # ---- 12. single-level bvh2 kernel vs plain, meshfield, 2^20 rays ----
    mtri = mesh.tri_all[:, :9].cpu().numpy()
    mp = (mtri[:, 0:3], mtri[:, 3:6], mtri[:, 6:9])
    mbvh = bvh_mod.build_bvh(np.minimum(np.minimum(*mp[:2]), mp[2]),
                             np.maximum(np.maximum(*mp[:2]), mp[2]))
    k7 = dict(nodes=torch.as_tensor(mbvh.nodes, device=dev),
              tris=torch.as_tensor(bvh_mod.pack_tri_geo(
                  *mp, order=mbvh.prim_indices), device=dev),
              depth=bvh_mod.bvh_max_depth(mbvh.nodes))
    print(f"[12 bvh2] meshfield binary BVH: {len(mbvh.nodes)} nodes, depth "
          f"{k7['depth']}", flush=True)
    k7_err, k7_work = 0.0, {}
    for any_hit, t_max in ((False, 1e30), (True, 30.0)):
        tv = torch.full((n_rays,), t_max, device=dev)
        got = bvh2.bvh2_intersect(k7["nodes"], k7["tris"], o7, d7, tv,
                                  any_hit, depth=k7["depth"])
        want = dict(zip(("t", "prim"), bvh2.bvh2_intersect_plain(
            k7["nodes"], k7["tris"], o7, d7, tv, any_hit)))
        k7_work[any_hit] = bvh2.counter_bvh2.work
        k7_err = max(k7_err, hold_to_plain(got, want, "12 bvh2", n_rays,
                                           any_hit))
    print(f"[12 bvh2] plain-version work, closest / any: {k7_work[False]} / "
          f"{k7_work[True]}", flush=True)

    # ---- 13. two-level bvh2 kernel vs plain, at scale and on the golden's
    # tables, 2^20 rays each ----
    t0 = time.perf_counter()
    grid = instanced_meshfield(mesh, dev)
    golden_tables = parser.parse_file(INST_SCENE, device=dev).scene
    print(f"[13 two_level] 64 instances of meshfield's {mesh.n_tris} "
          f"triangles ({64 * mesh.n_tris} triangle instances): "
          f"{grid.tlas_nodes.shape[0]} nodes, {grid.inst_rows.shape[0]} "
          f"instance rows, stack depth {grid.tlas_depth}, built in "
          f"{time.perf_counter() - t0:.2f} s; instances golden: "
          f"{golden_tables.inst_rows.shape[0]} instance rows, stack depth "
          f"{golden_tables.tlas_depth}", flush=True)
    k8_err, k8_work, k8_rays = 0.0, {}, {}
    for label, sc8 in (("grid64", grid), ("golden", golden_tables)):
        o8, d8 = tlas_box_rays(sc8, n_rays, dev, seed=13)
        k8_rays[label] = (sc8, o8, d8)
        tables = (sc8.tlas_nodes, sc8.inst_rows, sc8.tri_geo_tlas,
                  sc8.tlas_root)
        for any_hit, t_max in ((False, 1e30), (True, 30.0)):
            tv = torch.full((n_rays,), t_max, device=dev)
            got = bvh2.two_level_intersect(*tables, o8, d8, tv, any_hit,
                                           depth=sc8.tlas_depth)
            want = dict(zip(("t", "prim", "b1", "b2", "inst"),
                            bvh2.two_level_plain(*tables, o8, d8, tv,
                                                 any_hit)))
            k8_work[label, any_hit] = bvh2.counter_two_level.work
            k8_err = max(k8_err, hold_to_plain(
                got, want, f"13 two_level {label}", n_rays, any_hit))
        print(f"[13 two_level] {label} plain-version work, closest / any: "
              f"{k8_work[label, False]} / {k8_work[label, True]}",
              flush=True)

    # ---- 14. the instances path through the entry points ----
    reset_counts(counters)
    idesc = parser.parse_file(INST_SCENE)
    iimg, istats = render.render(idesc.scene, idesc.camera,
                                 sampler=idesc.sampler, device=dev,
                                 opts=path_mod.PathOptions(max_depth=3))
    ilaunch = {"two_level": bvh2.counter_two_level.launches,
               "bvh2": bvh2.counter_bvh2.launches,
               "bvh8": bvh8.counter.launches,
               "tri_intersect": ti.counter.launches,
               "megawave": megawave.counter.launches}
    iplain = sum(c.plain for c in counters)
    print(f"[14 instances] launches {ilaunch}, plain-version runs {iplain}; "
          f"{istats['seconds']:.3f} s, {istats['paths_per_sec']:.6g} "
          f"paths/s, {istats['lanes_per_wave']} lanes per wave", flush=True)
    check(ilaunch["two_level"] >= 1, "instances launched no two-level kernel")
    check(ilaunch["bvh8"] == 0 and ilaunch["tri_intersect"] == 0
          and ilaunch["megawave"] == 0 and ilaunch["bvh2"] == 0,
          "instances left the two-level route")
    check(iplain == 0, "instances ran a plain version on the card")
    i_mrse, i_ratio = gate(iimg, INST_GOLDEN, (200, 200, 3), INST_GATE_MRSE,
                           INST_GATE_MEAN_RATIO, "14 instances golden")
    image.write_exr(_build.BUILD_DIR / "instances_200_32spp.exr", iimg)

    # ---- 15. times: both bvh2 entries and their plain versions, beside
    # the BVH8 kernel on the same rays ----
    k7_ms, k8_ms = {}, {}
    for any_hit, t_max in ((False, 1e30), (True, 30.0)):
        tv = torch.full((n_rays,), t_max, device=dev)
        k7_ms[any_hit] = (
            cuda_ms(lambda: bvh2.bvh2_intersect(
                k7["nodes"], k7["tris"], o7, d7, tv, any_hit,
                depth=k7["depth"]), reps=20, warmup=3),
            cuda_ms(lambda: bvh2.bvh2_intersect_plain(
                k7["nodes"], k7["tris"], o7, d7, tv, any_hit), reps=1))
        print(f"[15 times] card {card}: bvh2 any_hit={any_hit} kernel "
              f"{k7_ms[any_hit][0]:.4f} ms "
              f"({n_rays / k7_ms[any_hit][0] / 1e3:.2f} Mrays/s) vs plain "
              f"{k7_ms[any_hit][1]:.4f} ms; bvh8 kernel on the same rays "
              f"{b8_ms[any_hit][0]:.4f} ms", flush=True)
        for label, (sc8, o8, d8) in k8_rays.items():
            tables = (sc8.tlas_nodes, sc8.inst_rows, sc8.tri_geo_tlas,
                      sc8.tlas_root)
            k8_ms[label, any_hit] = (
                cuda_ms(lambda: bvh2.two_level_intersect(
                    *tables, o8, d8, tv, any_hit, depth=sc8.tlas_depth),
                    reps=20, warmup=3),
                cuda_ms(lambda: bvh2.two_level_plain(
                    *tables, o8, d8, tv, any_hit), reps=1))
            k_ms, p_ms = k8_ms[label, any_hit]
            print(f"[15 times] card {card}: two_level {label} any_hit="
                  f"{any_hit} kernel {k_ms:.4f} ms ({n_rays / k_ms / 1e3:.2f}"
                  f" Mrays/s) vs plain {p_ms:.4f} ms "
                  f"({n_rays / p_ms / 1e3:.3f} Mrays/s)", flush=True)
    print(f"[15 times] card {card}: instances 200x200x32 depth 3 "
          f"{istats['paths_per_sec']:.6g} paths/s", flush=True)

    cr = curves_phases(dev, card, libs["curves"][1], counters, n_rays)
    t_new = time.perf_counter()
    ri = rays_in_phases(dev, card, libs, named, scene, cam, w6, stats)
    tr = terrain_phases(dev, card)
    print(f"[25 times] phases 21-25 took {time.perf_counter() - t_new:.1f} "
          "s", flush=True)
    t_new = time.perf_counter()
    probes = probe_phases(dev, card, libs["dma_probe"][1],
                          tr["forest"]["ms"])
    pt = patches_phases(dev, card, named)
    print(f"[30 times] phases 26-30 took {time.perf_counter() - t_new:.1f} "
          "s", flush=True)

    bad = [name for name in sys.modules
           if name.split(".")[0] in ("jax", "jaxlib", "flax", "pbrt_tpu")]
    check(not bad, f"imported modules of the JAX stack: {bad}")
    # bounds, from this run's inputs: the megakernel's closest-hit tests of
    # live lanes only (its shading and shadow tests are not counted), the
    # triangle kernel's n_rays x n_real tests, the BVH queries' visits
    n6 = w6.lam.shape[0]
    mw_bound = bound(n6 * (16 + 16 + 8 + 16 + 4)
                     + 4 * (w6.tri.numel() + w6.attr.numel()),
                     mw_live * n_real * TRI_OPS)
    ti_bound = bound(n_pix * (28 + 16) + 4 * scene.tri_pallas.numel(),
                     n_pix * n_real * TRI_OPS)
    b8_bound = traversal_bound(b8_work, n_rays, 16,
                               (b8.nodes_f, b8.nodes_q, b8.tris,
                                b8.prim_indices), tri_ops=TRI_OPS,
                               visit_ops=8 * BVH8_CHILD_OPS)
    k7_bound = traversal_bound(k7_work[False], n_rays, 16,
                               (k7["nodes"], k7["tris"]))
    k8_bound = traversal_bound(k8_work["grid64", False], n_rays, 20,
                               (grid.tlas_nodes, grid.inst_rows,
                                grid.tri_geo_tlas))
    for what, (b_ms, b_by), k_ms in (("megawave", mw_bound, mw_ms),
                                     ("tri_intersect", ti_bound, ti_ms),
                                     ("bvh8", b8_bound, b8_ms[False][0]),
                                     ("bvh2", k7_bound, k7_ms[False][0]),
                                     ("two_level", k8_bound,
                                      k8_ms["grid64", False][0]),
                                     ("curves", cr["bound"],
                                      cr["ms"][False][0]),
                                     ("megawave_rays", ri["bound"],
                                      ri["ms"]),
                                     ("bvh8_forest", tr["forest"]["bound"],
                                      tr["forest"]["ms"]),
                                     ("bvh8_binned", tr["binned"]["bound"],
                                      tr["binned"]["ms"])):
        print(f"[bounds] card {card}: {what} bound {b_ms:.5f} ms by {b_by}, "
              f"kernel {k_ms:.4f} ms ({b_ms / k_ms * 100:.2f}% of the "
              "bound)", flush=True)
    kernels = [
        dict(name="megawave", route="cuda",
             source="pbrt_tpu_torch/csrc/megawave.cu",
             replaces="pbrt_tpu/ops/megawave.py:559",
             launches=launches["megawave"], max_abs_err=mw_err,
             ms=mw_ms, plain_ms=mw_plain_ms, bound_ms=mw_bound[0],
             bound_by=mw_bound[1], library_ms=None),
        # launches: the general-wave cornell render (phase 9), the hair
        # render's in hair_launches (phase 18); max_abs_err: cornell's pool
        # (phase 3), the hair pool's in hair_max_abs_err (phase 17); its
        # test also runs inside every megakernel launch (tri_intersect.cuh)
        dict(name="tri_intersect", route="cuda",
             source="pbrt_tpu_torch/csrc/tri_intersect.cu",
             replaces="pbrt_tpu/ops/pallas_intersect.py:125",
             launches=glaunch["tri_intersect"], max_abs_err=tri_err,
             ms=ti_ms, plain_ms=ti_plain_ms, bound_ms=ti_bound[0],
             bound_by=ti_bound[1], library_ms=None,
             hair_launches=cr["tri_launches"],
             hair_max_abs_err=cr["tri_err"]),
        # launches: the meshfield render (phase 8); ms: closest hit at
        # 2^20 rays (any hit in any_hit_ms)
        dict(name="bvh8", route="cuda",
             source="pbrt_tpu_torch/csrc/bvh8.cu",
             replaces="pbrt_tpu/ops/pallas_bvh8.py:793",
             launches=mlaunch["bvh8"], max_abs_err=b8_err,
             ms=b8_ms[False][0], plain_ms=b8_ms[False][1],
             bound_ms=b8_bound[0], bound_by=b8_bound[1], library_ms=None,
             any_hit_ms=b8_ms[True][0], any_hit_plain_ms=b8_ms[True][1]),
        # launches: none on a render path (only tests reach the reference's
        # kernel too); its checks and times: phases 12 and 15, closest hit
        # on meshfield's binary BVH at 2^20 rays
        dict(name="bvh2", route="cuda", source="pbrt_tpu_torch/csrc/bvh2.cu",
             replaces="pbrt_tpu/ops/pallas_bvh.py:167",
             launches=ilaunch["bvh2"], max_abs_err=k7_err,
             ms=k7_ms[False][0], plain_ms=k7_ms[False][1],
             bound_ms=k7_bound[0], bound_by=k7_bound[1], library_ms=None,
             any_hit_ms=k7_ms[True][0], any_hit_plain_ms=k7_ms[True][1]),
        # launches: the instances render (phase 14); ms: closest hit on the
        # 64-instance grid at 2^20 rays (the golden's tables in golden_ms)
        dict(name="two_level", route="cuda",
             source="pbrt_tpu_torch/csrc/bvh2.cu",
             replaces="pbrt_tpu/ops/pallas_bvh.py:521",
             launches=ilaunch["two_level"], max_abs_err=k8_err,
             ms=k8_ms["grid64", False][0],
             plain_ms=k8_ms["grid64", False][1], bound_ms=k8_bound[0],
             bound_by=k8_bound[1], library_ms=None,
             any_hit_ms=k8_ms["grid64", True][0],
             any_hit_plain_ms=k8_ms["grid64", True][1],
             golden_ms=k8_ms["golden", False][0],
             golden_plain_ms=k8_ms["golden", False][1]),
        # launches: the hair render (phase 18); ms: closest hit on the hair
        # tables at 2^20 rays (any hit in any_hit_ms); max_abs_err: t of
        # the kernel against the plain version
        dict(name="curves", route="cuda",
             source="pbrt_tpu_torch/csrc/curves.cu",
             replaces="pbrt_tpu/ops/curves.py:380",
             launches=cr["launches"], max_abs_err=cr["err"],
             ms=cr["ms"][False][0], plain_ms=cr["ms"][False][1],
             bound_ms=cr["bound"][0], bound_by=cr["bound"][1],
             library_ms=None, any_hit_ms=cr["ms"][True][0],
             any_hit_plain_ms=cr["ms"][True][1]),
        # the rays-in entry of megawave.cu; launches: the 64 waves of phase
        # 23; ms: one 160,000-lane wave at depth 5 (the in-kernel-camera
        # entry on the same lanes in full_camera_ms); max_abs_err: against
        # its plain version (phase 22)
        dict(name="megawave_rays", route="cuda",
             source="pbrt_tpu_torch/csrc/megawave.cu",
             replaces="pbrt_tpu/ops/megawave.py:531",
             launches=ri["launches"], max_abs_err=ri["err"], ms=ri["ms"],
             plain_ms=ri["plain_ms"], bound_ms=ri["bound"][0],
             bound_by=ri["bound"][1], library_ms=None,
             full_camera_ms=ri["full_camera_ms"]),
        # launches: phase 24's four queries; ms and plain_ms: 2^20 raster
        # rays, closest hit, on the terrain (every set's kernel in ms_all)
        dict(name="bvh8_forest", route="cuda",
             source="pbrt_tpu_torch/csrc/bvh8_forest.cu",
             replaces="pbrt_tpu/ops/pallas_bvh8.py:830",
             launches=tr["forest"]["launches"],
             max_abs_err=tr["forest"]["err"], ms=tr["forest"]["ms"],
             plain_ms=tr["forest"]["plain_ms"],
             bound_ms=tr["forest"]["bound"][0],
             bound_by=tr["forest"]["bound"][1], library_ms=None,
             ms_all=tr["forest"]["ms_all"],
             page_copies=tr["forest"]["page_copies"]),
        # launches: the rounds of phase 24's four queries; ms: the round
        # kernels of the 2^20 raster closest-hit query (the whole query,
        # with the pre-pass and the schedule, in query_ms; every set's in
        # ms_all)
        dict(name="bvh8_binned", route="cuda",
             source="pbrt_tpu_torch/csrc/bvh8_binned.cu",
             replaces="pbrt_tpu/ops/pallas_bvh8.py:1052",
             launches=tr["binned"]["launches"],
             max_abs_err=tr["binned"]["err"], ms=tr["binned"]["ms"],
             plain_ms=tr["binned"]["plain_ms"],
             bound_ms=tr["binned"]["bound"][0],
             bound_by=tr["binned"]["bound"][1], library_ms=None,
             query_ms=tr["binned"]["query_ms"],
             rounds=tr["binned"]["rounds"],
             entries_ms=tr["binned"]["entries_ms"],
             schedule_ms=tr["binned"]["schedule_ms"],
             ms_all=tr["binned"]["ms_all"],
             page_copies=tr["binned"]["page_copies"]),
        *probes,
    ]
    print(json.dumps(dict(render=dict(
        paths_per_sec=stats["paths_per_sec"], seconds=stats["seconds"],
        mrse=m, mean_ratio_err=ratio), meshfield=dict(
        paths_per_sec=mstats["paths_per_sec"], seconds=mstats["seconds"],
        mrse=m_mrse, mean_ratio_err=m_ratio), cornell_general=dict(
        paths_per_sec=gstats["paths_per_sec"], seconds=gstats["seconds"],
        mrse=g_mrse, mean_ratio_err=g_ratio), instances=dict(
        paths_per_sec=istats["paths_per_sec"], seconds=istats["seconds"],
        mrse=i_mrse, mean_ratio_err=i_ratio), hair=cr["hair"],
        hair_ref=cr["hair_ref"], rays_in=ri["render"],
        terrain_bvh8_ms=tr["bvh8_ms"], patches=pt)))
    print(f"card: {card}")
    print(json.dumps(dict(kernels=kernels)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
