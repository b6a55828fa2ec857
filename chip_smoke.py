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
     max depth 5, launch counts read around it (the front end's lanes
     kernel, the megakernel and the film kernel once a wave), the image
     gated against
     the reference renderer's golden (goldens/cornell_400_64spp.exr) with
     the MRSE and mean-ratio gates of tools/golden.py, and written to
     pbrt_tpu_torch/_build/;
  6. times with CUDA events at the main path's wave shape (160,000 lanes):
     each kernel beside its plain version, and the render in paths/s; the
     megakernel's bound from the plain version's count of its work on the
     same lanes (closest-hit and shadow tests, shading, the sampler's
     integer work) and the warp busy share of the plain version's
     schedule (a path a thread, 32 lanes in a row);
  7. the BVH8 kernel against its plain version on the card: meshfield's
     BVH8, 2^20 seeded rays from the world box +-1, closest hit (t_max
     1e30: t, prim, b1, b2 bit for bit) and any hit (t_max 30: the hit
     flag);
  8. the meshfield path through the user entry points
     (scene.parser.parse_file -> integrators.render.render): 200x200,
     32 spp, max depth 4, every closest and shadow query through the BVH8
     kernel, launch counts read around it, the image gated against
     goldens/meshfield_200_32spp.exr and written to pbrt_tpu_torch/_build/;
  9. cornell through the general wave (PathOptions(megakernel=False)):
     400x400, 64 spp, max depth 5, every query through the triangle
     kernel, launch counts read around it, gated like phase 5;
 10. times with CUDA events: the BVH8 kernel (through the wrapper and as
     the bare launch, arguments prepared once) and its plain version at
     2^20 rays, closest and any hit, and the two renders in paths/s;
 11. the bvh8 and bvh2 libraries' ptxas reports: registers, stack frame
     and spills of the BVH8 kernel and of bvh2's two kernels (single
     level, two levels);
 12. the single-level bvh2 kernel against its plain version: meshfield's
     binary BVH, the 2^20 rays of phase 7, closest and any hit (t_max 30);
 13. the two-level bvh2 kernel against its plain version: meshfield's
     triangles as one prototype instanced 64 times on an 8x8 grid, each
     turned about y by a seeded angle, and the instances golden's own
     tables, 2^20 rays from each world box +-1, closest hit (t, prim, b1,
     b2, inst bit for bit) and any hit (the hit flag);
 14. the instances path through the user entry points (parse_file ->
     render): 200x200, 32 spp, max depth 3, every closest and shadow query
     through the two-level kernel, launch counts read around it, the image
     gated against goldens/instances_200_32spp.exr and written to
     pbrt_tpu_torch/_build/;
 15. times with CUDA events: both bvh2 entries and their plain versions
     (the two-level one also as the bare launch) beside the BVH8 kernel on
     the same rays, and the instances render in paths/s;
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
     beside the in-kernel-camera one (and its bound, as phase 6's), and the
     page bytes staged beside the tables' bytes;
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
 30. its time in paths/s, set-up apart;
 31. the triangle kernel above one shared-memory tile: the 1,280
     triangles of a subdivision-3 icosphere (the pool a scene built with
     the default force_bvh=None hands it) and a seeded soup of 4,096, 2^14
     box rays, closest and any hit, with phase 3's gates and t, prim, b1,
     b2 bit-equal to the plain version; bit-equality too on the pools of
     32 (cornell), 4 (hair) and 2 (patches) triangles;
 32. the sphere scene (scenes.make_furnace_sphere, albedo 0.8, 200x200, 16
     spp, max depth 5) through render once with force_bvh=None (every
     query through the triangle kernel, launch counts read around it) and
     once with force_bvh=True (the BVH8 kernel): the two images within rel
     1e-4 (floor 1e-3) on >= 99.9% of pixels, their means within 1e-3;
 33. times with CUDA events at the launch size, 160,000 box rays, closest
     hit: the triangle kernel through its wrapper and as the bare launch
     (outputs allocated once) at 32, 1,280 and 4,096 triangles, each with
     its bound, and the BVH8 kernel on the same two meshes and rays, bit-
     equal there to its plain version (closest hit, and any hit at t_max
     1.5);
 34. one wave of meshfield, instances and hair (160,000 lanes each): the
     queries the wave hands the BVH8, two-level and curve kernels (camera
     rays, each bounce, the shadow rays), recorded and timed again with
     CUDA events through the wrapper and as the bare launch; the BVH8 and
     two-level kernels on every query bit-equal to their plain versions
     (the hit flag at any hit), each query's bound from the plain
     version's count of its work (traversal_bound); the curve kernel on the hair wave's camera rays,
     first bounce and first shadow query bit-equal to its plain version;
 35. the envlit path through the user entry points (parse_file -> render):
     scenes/envlit.pbrt (an image infinite light from scenes/sky.exr, a
     rough gold conductor, a smooth dielectric; 1,538 triangles, under the
     BVH crossover, so every closest and shadow query goes through the
     triangle kernel, six 256-row tiles), 200x200, 64 spp, max depth 5,
     the general wave (the megakernel refuses the scene), launch counts
     read around it, the image gated against goldens/envlit_200_64spp.exr
     and written to pbrt_tpu_torch/_build/, paths/s with set-up apart;
 36. the triangle kernel on the queries of one envlit wave (160,000
     lanes): the camera rays, each bounce and each shadow query recorded,
     each launch bit-equal to its plain version (run in chunks of rays:
     it makes rays x triangles tensors), each bare launch timed queued,
     each query's bound (its bytes, or the triangle tests its rays need:
     every live ray against every triangle at closest hit, up to the first
     group with a hit at any hit);
 37. the manylight path through the user entry points (parse_file ->
     render): scenes/manylight.pbrt (576 emissive quads, 1,152 of its
     1,324 triangles, under "string lightsampler" "bvh": the light-BVH
     walk picks each shading point's light and weighs each emitter hit),
     200x200, 32 spp, max depth 3, the general wave, every query through
     the triangle kernel, launch counts read around it, the image gated
     against goldens/manylight_200_32spp.exr (MRSE <= 0.08, mean ratio
     error <= 0.03) and written to pbrt_tpu_torch/_build/, paths/s with
     set-up apart;
 38. the same for scenes/manylight16k.pbrt (16,928 emissive triangles of
     17,100, a 15-level light BVH, every query through the BVH8 kernel),
     200x200, 32 spp, max depth 3, its golden's gates as 37's;
 39. the same for scenes/killeroo.pbrt (two killermesh.ply copies under
     a rough gold conductor and a rough dielectric, 163,842 triangles
     through the BVH8 kernel, the floor's imagemap on checker.png MIP-
     filtered by the ray cone, the sky image light), 200x200, 32 spp, max
     depth 5, gated at MRSE <= 0.06 with the 0.2% largest pixel errors
     trimmed (tools/golden.py's mrse) and mean ratio error <= 0.03; with
     each rung the BVH build's time (native SAH, BVH8 collapse) and the
     scene's tables' bytes on the card;
 40. one wave of each (160,000 lanes): the triangle kernel on manylight's
     queries (as phase 36) and the BVH8 kernel on manylight16k's and
     killeroo's (as phase 34), every query bit-equal to its plain
     version, each bare launch timed queued beside its bound and the
     launches a render makes.
 41. the plytex path through the user entry points (parse_file ->
     render): scenes/plytex.pbrt (killeroo's checker floor and sky, blob.ply
     under a rough gold conductor: 5,122 triangles through the BVH8
     kernel; an exact rough-dielectric sphere, tensor code merged over
     every query), 200x200, 64 spp, max depth 5, gated at MRSE <= 0.05 with
     the 0.2% largest pixel errors trimmed and mean ratio error <= 0.03;
 42. the volume path the same way: scenes/volume.pbrt (a 24^3 uniformgrid
     medium inside a 12-triangle null-material interface box over a
     2-triangle floor, a uniform infinite light), which render hands to the
     volumetric integrator (integrators/volpath.py), 200x200, 32 spp, max
     depth 6, every main query through the triangle kernel, gated at MRSE
     <= 0.10 and mean ratio error <= 0.03; the flight loops' steps;
 43. the BVH8 kernel on the queries of one plytex wave and the triangle
     kernel on one volume wave's (as phases 34 and 36): every query
     bit-equal to its plain version, bare launches queued beside bounds;
 44. scenes.make_medium_shell (a homogeneous medium inside a 320-triangle
     icosphere interface shell, above the 256 the brute-force interface
     test takes) through render at 200x200, 16 spp, depth 5: every
     interface query through the single-level bvh2 kernel (TPU kernel 7's
     counterpart, on a render path), the main queries through the
     triangle kernel, no plain version, the image finite and lit; then
     every interface query of one wave bit-equal to the plain version,
     bare launches queued beside their bounds;
 45. the megakernel front end's lanes and film kernels (ops/megafront)
     and the readout kernel (ops/film_readout) on a 1920x1080 cornell
     wave: each bit-equal to its plain version,
     then bare launches queued beside their bounds (bytes) and the
     megakernel's (front_phases).
 46. the BxDF kernel (ops/bxdf) on one killeroo wave (200x200, 4 spp:
     160,000 lanes, depth 5): every bsdf_f, bsdf_pdf and bsdf_sample call
     the wave makes, through the kernel, bit-equal to the plain version on
     the same inputs; then depth 0's eval and sample as bare launches
     queued beside their bounds (bytes), the wrapper's calls and the plain
     versions' times (bxdf_phases).
A bare launch (the launch alone, its arguments prepared once) is timed
queued: its launches are enqueued behind a spin kernel, so that the card
runs them back to back and the time is the device's, whatever the host
takes to make them (cuda_ms). Phase 2 builds every kernel (one nvcc per source, all started together)
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
ENV_SCENE = ROOT / "scenes" / "envlit.pbrt"
ENV_GOLDEN = ROOT / "goldens" / "envlit_200_64spp.exr"
ENV_GATE_MRSE = 0.06    # tools/golden.py CONFIGS, envlit (no trim)
ENV_GATE_MEAN_RATIO = 0.02
# phases 37-39, 41-42 (tools/golden.py CONFIGS: scene, spp, depth, MRSE
# gate, mean-ratio gate, trim)
GOLDEN_RUNGS = {
    "manylight": (32, 3, 0.08, 0.03, 0.0),
    "manylight16k": (32, 3, 0.08, 0.03, 0.0),
    "killeroo": (32, 5, 0.06, 0.03, 0.002),
    "plytex": (64, 5, 0.05, 0.03, 0.002),
    "volume": (32, 6, 0.10, 0.03, 0.0),
}
# rays a chunk of the triangle kernel's plain version in phase 36
PLAIN_CHUNK = 1 << 14
# the bound's peaks (H100 SXM data sheet) and the f32 operations of one
# unit of work, counted from the kernels' sources
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# INT32: 64 lanes an SM against the FP32 pipe's 128 (Hopper white paper),
# half the f32 rate
PEAK_INT32_PER_S = 33.5e12
SLAB_OPS = 26           # 6 sub, 6 mul, 6 min/max, 6 for tmin/tmax, 2 test
TRI_OPS = 60            # Moeller-Trumbore on rows with precomputed edges
TRI_RAW_OPS = 64        # on raw vertices: 6 edge subtractions, no tolerance
TRI_OPS_EDGES = TRI_RAW_OPS - 6  # the same, edges subtracted at upload
BVH8_CHILD_OPS = 12 + SLAB_OPS   # dequantise a child box, then its slab
ENTER_OPS = 39          # a ray through w2o (33) and its 3 inverse dirs
FOREST_CHILD_OPS = SLAB_OPS      # the forest's children are not quantised
TERRAIN_N = 708                 # tools/exp_1m.py's terrain: 999,698 tris
TERRAIN_RAYS = 1 << 20
# phase 31's rays a pool (the plain version makes rays x triangles tensors)
# and the rays of a render's wave, the launch size of phases 33 and 34
BIG_POOL_RAYS = 1 << 14
LAUNCH_RAYS = 160000
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
# csrc/megawave.cu, f32 operations of one unit of its work besides the
# triangle tests (a division, square root or transcendental counts one),
# each unit as the plain version counts it (ops/megawave._path_loop):
# the camera section a lane (pixel decode, filter sample, pinhole);
# shading a hit (hit point, error bounds, normal, frame, albedo at 4
# wavelengths, the light sample and its pdfs, f and Le); an emissive hit's
# MIS; a shadow ray's origin offset and length; an unoccluded ray's
# contribution; a BSDF sample (concentric disk, pdf, beta); the next ray's
# direction and offset origin (a lane that goes on); a roulette draw
MEGA_CAMERA_OPS = 178
MEGA_SHADE_OPS = 276
MEGA_EMIT_OPS = 48
MEGA_SHADOW_RAY_OPS = 49
MEGA_UNOCCLUDED_OPS = 25
MEGA_BSDF_OPS = 52
MEGA_NEXT_RAY_OPS = 53
MEGA_RR_OPS = 17
# and the sampler's integer operations: a 1D draw (index shuffle 14, the
# product of dimension 0 as a bit reversal 1, scramble 12), a 2D draw (the
# product of dimension 1 as four byte-table lookups 9, a second scramble
# 12), the pixel decode (28)
MEGA_D1_INT_OPS = 27
MEGA_D2_INT_OPS = 48
MEGA_CAMERA_INT_OPS = 28
# what the TPU copy probes check (tools/exp_dma_var.py, exp_dma_var2.py)
# or print (exp_dma_min.py: row means at stages 1-2, then at stages 3-4)
PROBE_VALUES = {"var": 4096.0, "var2": [8192.0, 12288.0, 16384.0, 20480.0],
                "min": {False: [0.0, 2048.0, 4096.0, 6144.0],
                        True: [2048.0, 2048.0, 10240.0, 6144.0]}}


def check(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def wave_launches(launches):
    """The launches of a render's wave kernels: launches less the film
    readout's, which a render makes once (checked here)."""
    readout = launches.get("film_readout", 0)
    check(readout == 1, f"not one readout launch a render: {readout}")
    return sum(launches.values()) - readout


def mrse(img, ref, trim=0.0):
    """Relative MSE, tools/golden.py mrse: trim drops that share of the
    largest per-pixel errors first."""
    import numpy as np
    d = img - ref
    e = (d * d / (ref * ref + 0.01)).mean(axis=-1).reshape(-1)
    if trim > 0:
        e = np.sort(e)[:max(1, int(len(e) * (1.0 - trim)))]
    return float(e.mean())


# cycles of the spin kernel a queued timing puts ahead of each of its
# launches (~0.11 ms at the H100's 1.755 GHz: more than the host takes to
# enqueue one)
QUEUE_SPIN = 200_000


def cuda_ms(fn, reps, warmup=1, queued=False):
    """Mean milliseconds per call of fn over reps calls, CUDA events.
    queued: the calls are enqueued behind a spin kernel, so that the card
    runs them back to back and the time is the device's alone, whatever
    the host takes to launch them."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(QUEUE_SPIN * reps)
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


def gate(img, golden, shape, max_mrse, max_ratio, label, trim=0.0):
    """Hold a render to a reference-renderer golden (trim: mrse's);
    returns (mrse, mean ratio error)."""
    import numpy as np
    from pbrt_tpu_torch.utils import image
    check(img.shape == shape and bool(np.isfinite(img).all()),
          f"{label}: render output shape or values")
    ref = image.read_exr(golden)
    m = mrse(img, ref, trim)
    ratio = abs(float(img.mean()) / max(float(ref.mean()), 1e-9) - 1.0)
    print(f"[{label}] mrse {m:.5f} (gate {max_mrse}"
          + (f", the {trim:.1%} largest pixel errors trimmed" if trim else "")
          + f"), mean ratio err {ratio:.5f} (gate {max_ratio})", flush=True)
    check(m <= max_mrse and ratio <= max_ratio, f"{label}: golden gate")
    return m, ratio


def bound(n_bytes, n_ops, n_int_ops=0):
    """(bound_ms, bound_by): the least time of the work on the card: its
    bytes, its f32 operations or its INT32 operations (separate pipes) at
    their peak rates, whichever takes longest."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = max(n_ops / PEAK_F32_PER_S, n_int_ops / PEAK_INT32_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def megawave_bound(w, work):
    """The megakernel's bound on wave w from the plain version's count of
    its work on the same lanes: (bound_ms, bound_by) and its parts. Bytes:
    lam, le, mi (and o, d) read and L (and fw) written once a lane, the
    tables once. f32 operations: the closest-hit tests of live lanes, the
    shadow rays' tests (groups of four up to the first with a hit, all
    when unoccluded), the shading (MEGA_*_OPS); INT32: the sampler's."""
    n = w.lam.shape[0]
    camera = w.o is None
    n_bytes = n * (16 + 16 + 4 + 16 + (4 if camera else 24)) + 4 * sum(
        x.numel() for x in (w.tri, w.attr, w.light, w.mat)) + 4 * w.seeds.size
    closest = work["live_lane_depths"] * w.n_real * TRI_OPS
    shadow = work["shadow_tests"] * TRI_OPS
    shading = (work["hits"] * MEGA_SHADE_OPS
               + work["emissions"] * MEGA_EMIT_OPS
               + work["shadow_rays"] * MEGA_SHADOW_RAY_OPS
               + work["unoccluded"] * MEGA_UNOCCLUDED_OPS
               + work["bsdf_samples"] * MEGA_BSDF_OPS
               + sum(work["live_by_depth"][1:]) * MEGA_NEXT_RAY_OPS
               + work["rr_draws"] * MEGA_RR_OPS
               + (n * MEGA_CAMERA_OPS if camera else 0))
    int_ops = (work["hits"] * (MEGA_D1_INT_OPS + MEGA_D2_INT_OPS)
               + work["bsdf_samples"] * MEGA_D2_INT_OPS
               + work["rr_draws"] * MEGA_D1_INT_OPS
               + (n * (MEGA_D2_INT_OPS + MEGA_CAMERA_INT_OPS) if camera
                  else 0))
    b_ms, b_by = bound(n_bytes, closest + shadow + shading, int_ops)
    return dict(bound_ms=b_ms, bound_by=b_by, bound_ops_closest=closest,
                bound_ops_shadow=shadow, bound_ops_shading=shading,
                bound_int_ops=int_ops,
                bound_parts_ms=dict(
                    bytes=n_bytes / PEAK_BYTES_PER_S * 1e3,
                    closest=closest / PEAK_F32_PER_S * 1e3,
                    shadow=shadow / PEAK_F32_PER_S * 1e3,
                    shading=shading / PEAK_F32_PER_S * 1e3,
                    int32=int_ops / PEAK_INT32_PER_S * 1e3))


def bare_ms(lib_name, entry, args, reps=20):
    """Mean ms of a launch alone: the library's entry point called with
    arguments prepared once (a wrapper's launch_args), no wrapper host
    work, the launches queued (cuda_ms) so that the host's launch cost is
    not counted either."""
    from pbrt_tpu_torch.ops import _build
    fn = getattr(_build.load_library(lib_name), entry)
    return cuda_ms(lambda: _build.check(fn(*args), entry), reps=reps,
                   warmup=3, queued=True)


def megawave_bare_ms(w, reps=50):
    """Mean ms of the megakernel's launch alone on wave w: its arguments
    prepared once (ops/megawave.launch_args), no wrapper host work."""
    from pbrt_tpu_torch.ops import _build
    from pbrt_tpu_torch.ops import megawave
    lib = _build.load_library("megawave")
    args, _L, _fw, _keep = megawave.launch_args(w)
    return cuda_ms(lambda: _build.check(lib.megawave_launch(*args),
                                        "megawave"), reps=reps, warmup=3,
                   queued=True)


def show_megawave_bound(label, card, b, work):
    """The bound's parts, and from the plain version's count (work) the
    live lanes at each depth and the warp busy share of its schedule: one
    path a thread, 32 consecutive lanes side by side, as the kernel ran
    before its persistent grid (the persistent kernel's own share is not
    measured)."""
    print(f"[{label}] card {card}: bound {b['bound_ms']:.5f} ms by "
          f"{b['bound_by']}; parts, ms at peak: "
          + ", ".join(f"{k} {v:.5f}" for k, v in b["bound_parts_ms"].items())
          + f"; f32 operations: closest hit {b['bound_ops_closest']}, shadow "
          f"{b['bound_ops_shadow']}, shading {b['bound_ops_shading']}; INT32 "
          f"{b['bound_int_ops']}; live lanes by depth {work['live_by_depth']}"
          "; warp busy share of the plain schedule (a path a thread, 32 "
          f"lanes in a row) {work['warp_busy_share']:.4f}", flush=True)


def traversal_bound(work, n_rays, out_bytes, tables, tri_ops=TRI_RAW_OPS,
                    visit_ops=SLAB_OPS):
    """Bound of a BVH query: rays read once (o, d, t_max: 28 B), hits
    written once, tables read once; node visits, triangle tests and
    instance entries as the plain version counted them on the same rays."""
    n_bytes = n_rays * (28 + out_bytes) + sum(4 * x.numel() for x in tables)
    n_ops = (work["node_visits"] * visit_ops + work["tri_tests"] * tri_ops
             + work.get("instance_entries", 0) * ENTER_OPS)
    return bound(n_bytes, n_ops)


def two_level_bound_tables(scene):
    """The tables the two-level query must read, for traversal_bound: the
    node rows, 10 floats a triangle (tri_geo_tlas: p0, p1, p2, id) and 14
    words an instance (w2o, BLAS root, id), not the kernel's padded rows."""
    return (scene.tlas_nodes, scene.tri_geo_tlas,
            scene.tlas_kernel.insts[:, :14])


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


def hold_bits(got, want, label, any_hit):
    """A BVH kernel's outputs against its plain version's, bit for bit:
    the hit flag at any hit; t, prim, b1, b2 (and inst) at closest hit.
    got: the wrapper's dict or the launch's tuple; want: the plain
    version's tuple (t, prim, b1, b2[, inst]). Returns max |dt| where both
    hit (0 when bit-equal)."""
    import torch
    names = ("t", "prim", "b1", "b2", "inst")
    if isinstance(got, dict):
        got = tuple(got[k] for k in names if k in got)
    torch.cuda.synchronize()
    hit_eq = torch.equal(got[1] >= 0, want[1] >= 0)
    exact = all(torch.equal(g, w) for g, w in zip(got, want))
    both = (got[1] >= 0) & (want[1] >= 0)
    err = (got[0][both] - want[0][both]).abs().max().item() \
        if bool(both.any()) else 0.0
    print(f"[{label}] any_hit={any_hit}: {got[0].shape[0]} rays, hit share "
          f"{(want[1] >= 0).float().mean().item():.4f}, hit flag equal "
          f"{hit_eq}, {', '.join(names[:len(got)])} bit-equal {exact}",
          flush=True)
    check(hit_eq and (exact or any_hit),
          f"{label} (any_hit={any_hit}) differs from its plain version")
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


def seeded_box_rays(lo, hi, n, device, seed):
    """n rays from the box lo - 1 .. hi + 1, normally distributed
    directions."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo - 1, hi + 1, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return torch.as_tensor(o, device=device), torch.as_tensor(d, device=device)


def tlas_box_rays(scene, n, device, seed):
    """n rays from the TLAS root box (every instance's world bounds) +-1."""
    box = scene.tlas_nodes[scene.tlas_root, :6].cpu().numpy()
    return seeded_box_rays(box[:3], box[3:], n, device, seed)


def reset_counts(counters):
    for c in counters:
        c.launches = 0
        c.plain = 0


def box_rays(scene, n, device, seed=0):
    """bench.py's Mrays/s rays: origins uniform in the world box +-1,
    normally distributed directions."""
    tri = scene.tri_all[:, :9].reshape(-1, 3).cpu().numpy()
    return seeded_box_rays(tri.min(axis=0), tri.max(axis=0), n, device, seed)


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
    ckw = dict(depth=hair.curve_depth, wide=hair.curve_wide)
    print(f"[17 curves] hair: {hair.curve_mats.shape[0]} spans, "
          f"{hair.curve_segs.shape[0]} sub-segments "
          f"({4 * hair.curve_segs.numel() / 2**20:.1f} MiB of rows), "
          f"{hair.curve_nodes.shape[0]} nodes ({hair.curve_wide.shape[0]} "
          f"rows of the kernel's own table), depth {hair.curve_depth}, "
          f"{hair.n_tris} triangles; set-up {hair_setup:.2f} s (text "
          f"{t_gen:.2f} s, parse and build {hair_setup - t_gen:.2f} s)",
          flush=True)
    box = hair.curve_nodes[0, :6].cpu().numpy()
    o17, d17 = seeded_box_rays(box[:3], box[3:], n_rays, dev, seed=17)
    crv_work, crv_err = {}, 0.0
    for any_hit, t_max in ((False, 1e30), (True, 30.0)):
        tv = torch.full((n_rays,), t_max, device=dev)
        t_k, seg_k = curves.curves_intersect(*ctab, o17, d17, tv, any_hit,
                                             **ckw)
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
            got = curves.intersect_curves(*ctab, o17, d17, tv, **ckw)
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
                *ctab, o17, d17, tv, any_hit, **ckw), reps=20, warmup=3),
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
                tri_err=hair_tri_err, desc=hdesc,
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
    k3_work = megawave.counter.work
    k3_bound = megawave_bound(w22, k3_work)
    L2, _fw2 = megawave.wave_full(w6)
    # the in-kernel camera's own rays (the plain version's camera, which
    # phase 6 holds to the kernel's bit for bit) through the rays-in entry
    o2, d2, _fw = megawave._camera_rays(w6, megawave._ZSobol(
        megawave.widen_mi(w6.mi), w6.seeds, w6.B))
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
    check(launches["megawave"] == 64 and wave_launches(launches) == 64,
          "the rays-in path launched other than 64 megakernels")
    check(plain == 0, "the rays-in path ran a plain version on the card")
    m, ratio = gate(img, GOLDEN, (400, 400, 3), GATE_MRSE, GATE_MEAN_RATIO,
                    "23 rays-in path golden")
    image.write_exr(_build.BUILD_DIR / "cornell_rays_in_400_64spp.exr", img)

    # ---- 25 (megakernels). times at the main path's wave ----
    k3_ms = cuda_ms(lambda: megawave.wave_full(w22), reps=20, warmup=3)
    k2_ms = cuda_ms(lambda: megawave.wave_full(w6), reps=20, warmup=3)
    k3_bare_ms = megawave_bare_ms(w22)
    k3_plain_ms = cuda_ms(lambda: megawave.wave_full_plain(w22), reps=2)
    print(f"[25 times] card {card}: megakernel v1 (rays in) {k3_ms:.4f} ms "
          f"through the wrapper, {k3_bare_ms:.4f} ms the bare launch, vs v2 "
          f"(in-kernel camera) {k2_ms:.4f} ms through the wrapper, vs plain "
          f"{k3_plain_ms:.4f} ms per 160,000-lane wave", flush=True)
    show_megawave_bound("25 megakernel v1 bound", card, k3_bound, k3_work)
    return dict(launches=launches["megawave"], err=err, ms=k3_ms,
                plain_ms=k3_plain_ms, full_camera_ms=k2_ms, bound=k3_bound,
                bare_ms=k3_bare_ms,
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
          and wave_launches(launches) == launches["tri_intersect"],
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
                tri_launches=launches["tri_intersect"], desc=desc)


def big_pool(which, device):
    """The meshes of phases 31-33 on both triangle routes: "sphere", the
    1,280 triangles of a subdivision-3 icosphere, or "soup", 4,096 seeded
    small triangles in the unit box. Returns dict(pool (the brute-force
    rows), n_real, bvh8 (the BVH8 tables of the same triangles), lo, hi)."""
    import numpy as np
    import torch
    from pbrt_tpu_torch import scenes
    from pbrt_tpu_torch.ops import bvh as bvh_mod
    from pbrt_tpu_torch.ops import bvh8
    from pbrt_tpu_torch.ops import tri_intersect as ti
    if which == "sphere":
        v, f, _n = scenes.make_sphere_mesh((0.0, 0.0, 0.0), 1.0, subdiv=3)
        tri = v[f].reshape(-1, 9)
    else:
        rs = np.random.RandomState(31)
        p0 = rs.uniform(-1, 1, (4096, 1, 3))
        tri = (p0 + rs.normal(scale=0.05, size=(4096, 3, 3))).reshape(-1, 9)
    tri = tri.astype(np.float32)
    p = (tri[:, 0:3], tri[:, 3:6], tri[:, 6:9])
    lo = np.minimum(np.minimum(p[0], p[1]), p[2])
    hi = np.maximum(np.maximum(p[0], p[1]), p[2])
    return dict(pool=torch.as_tensor(ti.pad_triangles(tri), device=device),
                n_real=len(tri),
                bvh8=bvh8.build_bvh8(lo, hi, bvh_mod.pack_tri_geo(*p),
                                     device=device),
                lo=lo.min(axis=0), hi=hi.max(axis=0))


def record_calls(module, name, run):
    """The positional and keyword arguments of every call of module.name
    made while run() runs."""
    calls = []
    fn = getattr(module, name)

    def recording(*a, **k):
        calls.append((a, k))
        return fn(*a, **k)
    setattr(module, name, recording)
    try:
        run()
    finally:
        setattr(module, name, fn)
    return calls


def wave_queries(module, name, any_hit_arg, desc, max_depth, device):
    """One wave of desc's scene (as many sample indices as fit 2^18 lanes)
    through render: the calls it makes to the kernel wrapper module.name,
    split into closest-hit queries (the camera rays, then each bounce) and
    any-hit queries (the shadow rays)."""
    from pbrt_tpu_torch import samplers as smp
    from pbrt_tpu_torch.integrators import path as path_mod
    from pbrt_tpu_torch.integrators import render
    W, H = desc.camera.width, desc.camera.height
    m = 1
    while m * 2 * W * H <= render.MAX_WAVE_LANES and \
            desc.sampler.spp % (m * 2) == 0:
        m *= 2
    calls = record_calls(module, name, lambda: render.render(
        desc.scene, desc.camera, device=device,
        sampler=smp.make_sampler("zsobol", spp=m, full_resolution=(W, H)),
        opts=path_mod.PathOptions(max_depth=max_depth)))
    closest = [c for c in calls if not c[0][any_hit_arg]]
    shadow = [c for c in calls if c[0][any_hit_arg]]
    return closest, shadow, W * H * m


def bvh_wave(label, scene, closest, shadow, arg, card, dev, tag="34 wave"):
    """Phase 34 for the BVH8 ("bvh8"), two-level ("two_level") or, on a
    scene's interface BVH, the single-level ("bvh2") kernel on
    the queries of one wave (the wrapper's recorded calls, o, d, t_max the
    three arguments before any_hit, at position arg): each query's bare
    launch (arguments prepared once) beside the wrapper, the kernel bit-equal
    to its plain version, and the query's bound from the plain version's
    count of its work on those rays (traversal_bound). Returns the wave's
    dict entries."""
    import torch
    from pbrt_tpu_torch.ops import bvh2
    from pbrt_tpu_torch.ops import bvh8
    if label == "bvh8":
        b8 = scene.bvh8
        tables = (b8.nodes_f, b8.nodes_q, b8.tris, b8.prim_indices)

        def launch(o, d, tv, any_hit):
            return bvh8._launch(b8, o, d, tv, any_hit)

        def bare(o, d, tv, any_hit, out):
            return bare_ms("bvh8", "bvh8_intersect_launch", bvh8.launch_args(
                b8, o, d, tv, any_hit, out=out)[0])

        def plain(o, d, tv, any_hit):
            return bvh8.bvh8_intersect_plain(b8, o, d, tv, any_hit), \
                bvh8.counter.work
        kw = dict(out_bytes=16, tri_ops=TRI_OPS,
                  visit_ops=8 * BVH8_CHILD_OPS)
    elif label == "bvh2":
        # the single-level kernel on a scene's interface BVH (phase 44)
        nodes, tris = scene.iface_nodes, scene.iface_tris_bvh
        tables = (nodes, tris)

        def launch(o, d, tv, any_hit):
            return bvh2._launch(nodes, tris, o, d, tv, any_hit)

        def bare(o, d, tv, any_hit, out):
            return bare_ms("bvh2", "bvh2_intersect_launch",
                           bvh2.launch_args_single(nodes, tris, o, d, tv,
                                                   any_hit, out=out)[0])

        def plain(o, d, tv, any_hit):
            return bvh2.bvh2_intersect_plain(nodes, tris, o, d, tv,
                                             any_hit), \
                bvh2.counter_bvh2.work
        kw = dict(out_bytes=16, tri_ops=TRI_RAW_OPS)
    else:
        kt = scene.tlas_kernel
        tables = two_level_bound_tables(scene)
        args = (scene.tlas_nodes, scene.inst_rows, scene.tri_geo_tlas,
                scene.tlas_root)

        def launch(o, d, tv, any_hit):
            return bvh2._launch_two_level(scene.tlas_nodes, kt,
                                          scene.tlas_root, o, d, tv, any_hit)

        def bare(o, d, tv, any_hit, out):
            return bare_ms("bvh2", "two_level_launch", bvh2.launch_args(
                scene.tlas_nodes, kt, scene.tlas_root, o, d, tv, any_hit,
                out=out)[0])

        def plain(o, d, tv, any_hit):
            return bvh2.two_level_plain(*args, o, d, tv, any_hit), \
                bvh2.counter_two_level.work
        kw = dict(out_bytes=20, tri_ops=TRI_OPS_EDGES)
    names = ["camera rays"] + [f"bounce {i}" for i in range(1, len(closest))]
    names += [f"shadow {i}" for i in range(1, len(shadow) + 1)]
    queries = []
    for name, (a, _k) in zip(names, closest + shadow):
        o, d = a[arg - 3].contiguous(), a[arg - 2].contiguous()
        tv = torch.as_tensor(a[arg - 1], dtype=torch.float32, device=dev)
        tv = tv.expand(o.shape[0]).contiguous()
        any_hit = bool(a[arg])
        res = launch(o, d, tv, any_hit)
        want, work = plain(o, d, tv, any_hit)
        hold_bits(res, want, f"{tag} {label} {name}", any_hit)
        b_ms, b_by = traversal_bound(work, o.shape[0], kw["out_bytes"],
                                     tables, tri_ops=kw["tri_ops"],
                                     visit_ops=kw.get("visit_ops", SLAB_OPS))
        queries.append(dict(query=name, rays=o.shape[0], any_hit=any_hit,
                            bare_ms=bare(o, d, tv, any_hit, res),
                            bound_ms=b_ms, bound_by=b_by,
                            hit_share=(want[1] >= 0).float().mean().item(),
                            work=work))
    ms = [q["bare_ms"] for q in queries]
    entry = dict(queries=queries, bare_sum_ms=sum(ms),
                 bound_sum_ms=sum(q["bound_ms"] for q in queries))
    entry["bound_ms"] = entry["bound_sum_ms"] / len(queries)
    print(f"[{tag}] card {card}: {label} on one wave: bare launches "
          + ", ".join(f"{q['query']} {q['bare_ms']:.4f} ms (bound "
                      f"{q['bound_ms']:.5f} by {q['bound_by']})"
                      for q in queries)
          + f"; {len(queries)} launches, {entry['bare_sum_ms']:.4f} ms in all "
          f"({entry['bound_sum_ms'] / entry['bare_sum_ms'] * 100:.1f}% of the "
          "bound); every query bit-equal to the plain version", flush=True)
    return entry


def redesign_phases(dev, card, named, cornell, descs):
    """Phases 31-34: the triangle kernel above one tile and on both routes
    of the sphere scene, its times at the launch size beside the BVH8
    kernel's, and kernels 4, 8 and 9 on the queries of one wave of their
    render paths. descs: the parsed meshfield, instances, hair and patches
    scenes. Returns what the kernels line needs."""
    import numpy as np
    import torch
    from pbrt_tpu_torch import scenes
    from pbrt_tpu_torch.integrators import path as path_mod
    from pbrt_tpu_torch.integrators import render
    from pbrt_tpu_torch.ops import bvh2
    from pbrt_tpu_torch.ops import bvh8
    from pbrt_tpu_torch.ops import curves
    from pbrt_tpu_torch.ops import tri_intersect as ti
    t_start = time.perf_counter()
    # ---- 31. the triangle kernel against its plain version ----
    pools = {w: big_pool(w, dev) for w in ("sphere", "soup")}
    n31 = BIG_POOL_RAYS
    err31 = 0.0
    for which, pl_ in pools.items():
        o, d = seeded_box_rays(pl_["lo"], pl_["hi"], n31, dev, seed=31)
        for any_hit, t_max in ((False, 1e30), (True, 1.5)):
            tv = torch.full((n31,), t_max, device=dev)
            got = ti.tri_intersect(pl_["pool"], o, d, tv, pl_["n_real"],
                                   any_hit)
            want = ti.tri_intersect_plain(pl_["pool"], o, d, tv,
                                          pl_["n_real"], any_hit)
            torch.cuda.synchronize()
            same = got[1] == want[1]
            agree = same.float().mean().item()
            hit = same & (want[1] >= 0)
            ok = torch.allclose(got[0][hit], want[0][hit], rtol=1e-5, atol=0)
            exact = all(torch.equal(g, w) for g, w in zip(got, want))
            err = (got[0][hit] - want[0][hit]).abs().max().item() \
                if bool(hit.any()) else 0.0
            err31 = max(err31, err)
            print(f"[31 tri_intersect] {which}, {pl_['n_real']} triangles, "
                  f"any_hit={any_hit}: prim equal on {agree * 100:.4f}% of "
                  f"{n31} rays, hit share "
                  f"{(want[1] >= 0).float().mean().item():.4f}, max |dt| "
                  f"{err:.3g}; t, prim, b1, b2 bit-equal {exact}",
                  flush=True)
            check(agree >= 0.9999 and ok and exact,
                  f"tri_intersect at {pl_['n_real']} triangles differs from "
                  "its plain version")
    small = (("cornell", cornell.tri_pallas, cornell.mega.n_tris),
             ("hair", descs["hair"].scene.tri_pallas,
              descs["hair"].scene.n_tris),
             ("patches", descs["patches"].scene.tri_pallas,
              descs["patches"].scene.n_tris))
    o, d, t_any = seeded_rays(1 << 16, dev, seed=31)
    for label, pool, n_real in small:
        for any_hit, tv in ((False, torch.full_like(t_any, 1e30)),
                            (True, t_any)):
            got = ti.tri_intersect(pool, o, d, tv, n_real, any_hit)
            want = ti.tri_intersect_plain(pool, o, d, tv, n_real, any_hit)
            exact = all(torch.equal(g, w) for g, w in zip(got, want))
            print(f"[31 tri_intersect] {label}'s {n_real} triangles, "
                  f"any_hit={any_hit}: t, prim, b1, b2 bit-equal {exact} on "
                  f"{o.shape[0]} rays", flush=True)
            check(exact, f"tri_intersect on {label}'s pool differs from its "
                  "plain version")

    # ---- 32. the sphere scene on both routes ----
    imgs = {}
    for force in (None, True):
        sphere, scam = scenes.make_furnace_sphere(
            albedo=0.8, width=200, height=200, subdiv=3, device=dev,
            force_bvh=force)
        reset_counts(named.values())
        imgs[force], sstats = render.render(
            sphere, scam, spp=16, device=dev,
            opts=path_mod.PathOptions(max_depth=5))
        launches = {c: k.launches for c, k in named.items() if k.launches}
        plain = sum(k.plain for k in named.values())
        print(f"[32 sphere] force_bvh={force}: {sphere.n_tris} triangles, "
              f"launches {launches}, plain-version runs {plain}; "
              f"{sstats['paths_per_sec']:.6g} paths/s, image mean "
              f"{float(imgs[force].mean()):.6g}", flush=True)
        route = "bvh8" if force else "tri_intersect"
        check(wave_launches(launches) == launches.get(route, 0) > 0
              and plain == 0,
              f"the sphere scene with force_bvh={force} left the {route} "
              "route")
        if force is None:
            sphere_launches = launches.get("tri_intersect", 0)
    a, b = imgs[None], imgs[True]
    check(a.shape == (200, 200, 3) and bool(np.isfinite(a).all()),
          "sphere: render output shape or values")
    rel = (np.abs(a - b) / np.maximum(np.abs(b), 1e-3)).max(axis=-1)
    within = float((rel <= 1e-4).mean())
    mean_rel = abs(float(a.mean()) / float(b.mean()) - 1.0)
    print(f"[32 sphere] brute force against BVH8: {within * 100:.4f}% of "
          f"pixels within rel 1e-4 (floor 1e-3), max rel {rel.max():.3g}, "
          f"means differ by {mean_rel:.3g}", flush=True)
    check(within >= 0.999 and mean_rel < 1e-3,
          "the sphere scene's two routes give different images")

    # ---- 33. times at the launch size ----
    n33 = LAUNCH_RAYS
    tri_ms = {}
    for label, pool, n_real, lo, hi, b8 in (
            (32, cornell.tri_pallas, cornell.mega.n_tris, None, None, None),
            *((pl_["n_real"], pl_["pool"], pl_["n_real"], pl_["lo"],
               pl_["hi"], pl_["bvh8"]) for pl_ in pools.values())):
        if lo is None:
            o, d, _t = seeded_rays(n33, dev, seed=8)
        else:
            o, d = seeded_box_rays(lo, hi, n33, dev, seed=33)
        tv = torch.full((n33,), 1e30, device=dev)
        out = ti.tri_intersect(pool, o, d, tv, n_real, False)
        k_ms = cuda_ms(lambda: ti.tri_intersect(pool, o, d, tv, n_real,
                                                False), reps=20, warmup=3)
        t_bare = cuda_ms(lambda: ti._launch(pool, o, d, tv, n_real, False,
                                            out=out), reps=20, warmup=3,
                         queued=True)
        b_ms, b_by = bound(n33 * (28 + 16) + 4 * pool.numel(),
                           n33 * n_real * TRI_OPS)
        b8_ms = None if b8 is None else cuda_ms(
            lambda: bvh8.bvh8_intersect(b8, o, d, tv, False), reps=20,
            warmup=3)
        if b8 is not None:
            for any_hit, t_b8 in ((False, tv), (True, torch.full_like(
                    tv, 1.5))):
                hold_bits(bvh8.bvh8_intersect(b8, o, d, t_b8, any_hit),
                          bvh8.bvh8_intersect_plain(b8, o, d, t_b8, any_hit),
                          f"33 bvh8 at {label} triangles", any_hit)
        tri_ms[label] = dict(ms=k_ms, bare_ms=t_bare, bound_ms=b_ms,
                             bound_by=b_by, bvh8_ms=b8_ms)
        print(f"[33 times] card {card}: tri_intersect at {label} triangles "
              f"x {n33} rays, closest hit: {k_ms:.4f} ms through the "
              f"wrapper, {t_bare:.4f} ms the bare launch (outputs allocated"
              f" once), bound {b_ms:.5f} ms by {b_by}"
              + ("" if b8_ms is None else
                 f"; the BVH8 kernel on the same mesh and rays {b8_ms:.4f} "
                 f"ms ({k_ms / b8_ms:.1f}x faster)"), flush=True)

    # ---- 34. kernels 4, 8 and 9 on one wave's own queries ----
    wave_ms = {}
    for label, module, fn_name, arg, key, depth in (
            ("bvh8", bvh8, "bvh8_intersect", 4, "meshfield", 4),
            ("two_level", bvh2, "two_level_intersect", 7, "instances", 3),
            ("curves", curves, "curves_intersect", 5, "hair", 5)):
        closest, shadow, lanes = wave_queries(module, fn_name, arg,
                                              descs[key], depth, dev)
        fn = getattr(module, fn_name)
        ms = [[cuda_ms(lambda: fn(*a, **k), reps=10, warmup=2)
               for a, k in group] for group in (closest, shadow)]
        wave_ms[label] = dict(
            lanes=lanes, camera_ms=ms[0][0], bounce_ms=ms[0][1:],
            shadow_ms=ms[1], launches=len(closest) + len(shadow),
            sum_ms=sum(ms[0]) + sum(ms[1]))
        if label != "curves":
            print(f"[34 wave] card {card}: {label} on one {key} wave of "
                  f"{lanes} lanes, through the wrapper: camera rays "
                  f"{ms[0][0]:.4f} ms, bounces "
                  f"{[round(x, 4) for x in ms[0][1:]]} ms, shadow rays "
                  f"{[round(x, 4) for x in ms[1]]} ms; "
                  f"{wave_ms[label]['sum_ms']:.4f} ms in all", flush=True)
            wave_ms[label].update(bvh_wave(label, descs[key].scene, closest,
                                           shadow, arg, card, dev))
            continue
        # the curve kernel: a launch's bound at this size, the rays in, the
        # hits out and the tables once (bytes)
        sc_ = descs[key].scene
        b_ms, _by = bound(lanes * (28 + 8) + sum(
            4 * x.numel() for x in (sc_.curve_nodes, sc_.curve_segs)), 0)
        # the device's time a query: its bare launch (arguments prepared
        # once, no wrapper work), queued
        dev_ms = []
        for a, _k in closest + shadow:
            o, d = a[2].contiguous(), a[3].contiguous()
            tv = torch.as_tensor(a[4], dtype=torch.float32, device=dev)
            tv = tv.expand(o.shape[0]).contiguous()
            kargs, _out, _keep = curves.launch_args(
                sc_.curve_nodes, sc_.curve_wide, sc_.curve_segs, o, d, tv,
                bool(a[5]))
            dev_ms.append(bare_ms("curves", "curves_intersect_launch",
                                  kargs))
        wave_ms[label].update(bound_ms=b_ms, bare_ms=dev_ms,
                              bare_sum_ms=sum(dev_ms))
        print(f"[34 wave] card {card}: {label} on one {key} wave of {lanes} "
              f"lanes: camera rays {ms[0][0]:.4f} ms, bounces "
              f"{[round(x, 4) for x in ms[0][1:]]} ms, shadow rays "
              f"{[round(x, 4) for x in ms[1]]} ms; "
              f"{wave_ms[label]['launches']} launches, "
              f"{wave_ms[label]['sum_ms']:.4f} ms in all, "
              f"{wave_ms[label]['bare_sum_ms']:.4f} ms the bare launches "
              f"(queued); a launch's bound at this size {b_ms:.5f} ms "
              "(bytes)", flush=True)
        hair = descs[key].scene
        for what, (a, k) in (("camera rays", closest[0]),
                             ("first bounce", closest[1]),
                             ("first shadow query", shadow[0])):
            t_k, seg_k = fn(*a, **k)
            t_p, seg_p = curves.curves_intersect_plain(
                hair.curve_nodes, hair.curve_segs, a[2], a[3],
                torch.as_tensor(a[4], device=dev).expand(a[2].shape[0]),
                a[5])
            torch.cuda.synchronize()
            hit_eq = torch.equal(seg_k >= 0, seg_p >= 0)
            exact = torch.equal(seg_k, seg_p) and torch.equal(t_k, t_p)
            print(f"[34 wave] curves, hair wave's {what} (any_hit={a[5]}): "
                  f"hit share {(seg_p >= 0).float().mean().item():.4f}, hit "
                  f"equal {hit_eq}, t and segment bit-equal {exact}; plain "
                  f"work {curves.counter.work}", flush=True)
            check(hit_eq and (exact or a[5]),
                  f"curves on the hair wave's {what} differs from the plain "
                  "version")
    print(f"[34 wave] phases 31-34 took {time.perf_counter() - t_start:.1f} "
          "s", flush=True)
    return dict(tri_ms=tri_ms, tri_err=err31, sphere_launches=sphere_launches,
                wave_ms=wave_ms)


def tri_plain_chunked(pool, o, d, t_max, n_real, any_hit):
    """The triangle kernel's plain version over chunks of PLAIN_CHUNK rays
    (its rays x triangles tensors of a whole wave would not fit); every ray
    is independent of the others, so the result is the whole call's."""
    import torch
    from pbrt_tpu_torch.ops import tri_intersect as ti
    parts = [ti.tri_intersect_plain(pool, o[i:i + PLAIN_CHUNK],
                                    d[i:i + PLAIN_CHUNK],
                                    t_max[i:i + PLAIN_CHUNK], n_real, any_hit)
             for i in range(0, o.shape[0], PLAIN_CHUNK)]
    return tuple(torch.cat(x) for x in zip(*parts))


def tri_query_bound(pool, n_real, t_max, want, any_hit):
    """A brute-force query's bound: rays in (28 B) and hits out (16 B) once,
    the pool once; the triangle tests its rays need: none for a dead ray
    (t_max <= 0), every triangle at closest hit, the triangles up to the
    end of the first group of ti.GROUP with a hit at any hit (all on a
    miss). Returns (bound_ms, bound_by, tests)."""
    from pbrt_tpu_torch.ops import tri_intersect as ti
    live = t_max > 0
    if any_hit:
        prim = want[1].long()
        per_ray = ((prim // ti.GROUP + 1) * ti.GROUP).clamp(max=n_real)
        per_ray = per_ray.where(prim >= 0, n_real)
        tests = int(per_ray[live].sum().item())
    else:
        tests = int(live.sum().item()) * n_real
    n = t_max.shape[0]
    b_ms, b_by = bound(n * (28 + 16) + 4 * pool.numel(), tests * TRI_OPS)
    return b_ms, b_by, tests


def tri_wave(desc, depth, dev, card, tag, render_launches):
    """The triangle kernel on the queries of one wave of desc's scene
    (phases 36 and 40): the camera rays, each bounce and each shadow query
    recorded (wave_queries), each launch bit-equal to its plain version
    (tri_plain_chunked), each bare launch timed queued, each query's bound
    (tri_query_bound). Returns the wave's dict."""
    import torch
    from pbrt_tpu_torch.ops import tri_intersect as ti
    closest, shadow, lanes = wave_queries(ti, "tri_intersect", 5, desc,
                                          depth, dev)
    names = ["camera rays"] + [f"bounce {i}" for i in range(1, len(closest))]
    names += [f"shadow {i}" for i in range(1, len(shadow) + 1)]
    queries = []
    for name, (a, _k) in zip(names, closest + shadow):
        pool, o, d, tv, n_real, any_hit = a
        o, d = o.contiguous(), d.contiguous()
        tv = torch.as_tensor(tv, dtype=torch.float32, device=dev)
        tv = tv.expand(o.shape[0]).contiguous()
        any_hit = bool(any_hit)
        res = ti._launch(pool, o, d, tv, n_real, any_hit)
        want = tri_plain_chunked(pool, o, d, tv, n_real, any_hit)
        hold_bits(res, want, f"{tag} tri_intersect {name}", any_hit)
        b_ms, b_by, tests = tri_query_bound(pool, n_real, tv, want, any_hit)
        t_bare = cuda_ms(lambda: ti._launch(pool, o, d, tv, n_real, any_hit,
                                            out=res), reps=20, warmup=3,
                         queued=True)
        queries.append(dict(query=name, rays=o.shape[0], any_hit=any_hit,
                            live=int((tv > 0).sum().item()), tests=tests,
                            hit_share=(want[1] >= 0).float().mean().item(),
                            bare_ms=t_bare, bound_ms=b_ms, bound_by=b_by))
    wave = dict(lanes=lanes, queries=queries,
                bare_sum_ms=sum(q["bare_ms"] for q in queries),
                bound_sum_ms=sum(q["bound_ms"] for q in queries),
                launches=len(queries))
    wave["bound_ms"] = wave["bound_sum_ms"] / len(queries)
    print(f"[{tag} wave] card {card}: tri_intersect at "
          f"{desc.scene.n_tris} triangles on one wave of {lanes} lanes, "
          "bare launches queued: " + ", ".join(
              f"{q['query']} {q['bare_ms']:.4f} ms (live rays {q['live']}, "
              f"bound {q['bound_ms']:.5f} by {q['bound_by']})"
              for q in queries)
          + f"; {len(queries)} launches, {wave['bare_sum_ms']:.4f} ms in all "
          f"({wave['bound_sum_ms'] / wave['bare_sum_ms'] * 100:.1f}% of the "
          f"bound); a render makes {render_launches}; every query "
          "bit-equal to the plain version", flush=True)
    return wave


def envlit_phases(dev, card, named):
    """Phases 35-36, the envlit path: scenes/envlit.pbrt through parse_file
    -> render, gated against its golden, its time; then the triangle
    kernel on one envlit wave's own queries."""
    import torch
    from pbrt_tpu_torch.integrators import path as path_mod
    from pbrt_tpu_torch.integrators import render
    from pbrt_tpu_torch.ops import _build
    from pbrt_tpu_torch.scene import parser
    from pbrt_tpu_torch.utils import image
    # ---- 35. the envlit path through the entry points ----
    reset_counts(named.values())
    t0 = time.perf_counter()
    desc = parser.parse_file(ENV_SCENE, device=dev)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    s = desc.scene
    check(s.n_tris == 1538 and not s.use_bvh and s.mega is None
          and s.env is not None and s.env.texels.shape == (128 * 128, 4),
          "envlit: scene tables")
    img, stats = render.render(s, desc.camera, sampler=desc.sampler,
                               device=dev,
                               opts=path_mod.PathOptions(max_depth=5))
    launches = {c: k.launches for c, k in named.items()}
    plain = sum(k.plain for k in named.values())
    print(f"[35 envlit] {s.n_tris} triangles ({s.tri_pallas.numel() // 16} "
          f"pool rows), BxDF tags {s.bxdf_tags}, light tags {s.light_tags}, "
          f"env {s.env.width}x{s.env.height}; launches {launches}, "
          f"plain-version runs {plain}; {stats['lanes_per_wave']} lanes per "
          "wave", flush=True)
    check(launches["tri_intersect"] >= 1
          and wave_launches(launches) == launches["tri_intersect"],
          "envlit left the triangle-kernel route")
    check(plain == 0, "envlit ran a plain version on the card")
    m, ratio = gate(img, ENV_GOLDEN, (200, 200, 3), ENV_GATE_MRSE,
                    ENV_GATE_MEAN_RATIO, "35 envlit golden")
    print(f"[35 envlit golden] margins: mrse {ENV_GATE_MRSE - m:.5f}, mean "
          f"ratio err {ENV_GATE_MEAN_RATIO - ratio:.5f} under the gates",
          flush=True)
    image.write_exr(_build.BUILD_DIR / "envlit_200_64spp.exr", img)
    print(f"[35 times] card {card}: envlit 200x200x64 depth 5 "
          f"{stats['paths_per_sec']:.6g} paths/s ({stats['seconds']:.3f} s),"
          f" set-up (parse, sky.exr, alias table, build) {setup:.3f} s apart",
          flush=True)

    # ---- 36. the triangle kernel on one envlit wave's queries ----
    wave = tri_wave(desc, 5, dev, card, "36 envlit",
                    launches["tri_intersect"])
    return dict(render=dict(paths_per_sec=stats["paths_per_sec"],
                            seconds=stats["seconds"], setup_s=setup, mrse=m,
                            mean_ratio_err=ratio),
                launches=launches["tri_intersect"], wave=wave)


def device_bytes(obj, seen=None):
    """Bytes of every tensor a scene holds, through its nested tables (the
    BVH8, the light sampler, the texture pool, the image light)."""
    import dataclasses
    import torch
    seen = set() if seen is None else seen
    if isinstance(obj, torch.Tensor):
        if obj.data_ptr() in seen:
            return 0
        seen.add(obj.data_ptr())
        return obj.numel() * obj.element_size()
    if dataclasses.is_dataclass(obj):
        return sum(device_bytes(getattr(obj, f.name), seen)
                   for f in dataclasses.fields(obj))
    return 0


def timed_calls(targets, run):
    """Run run() with each (module, name) of targets wrapped to add its
    synchronized wall time to a total. Returns (run's result, {name:
    seconds})."""
    import torch
    totals = {name: 0.0 for _m, name in targets}
    saved = []
    for module, name in targets:
        fn = getattr(module, name)
        saved.append((module, name, fn))

        def wrapped(*a, _fn=fn, _name=name, **k):
            t0 = time.perf_counter()
            out = _fn(*a, **k)
            torch.cuda.synchronize()
            totals[_name] += time.perf_counter() - t0
            return out
        setattr(module, name, wrapped)
    try:
        return run(), totals
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


def golden_rung(name, dev, card, named, route, tag):
    """One rung of phases 37-39 and 41-42: scenes/<name>.pbrt through
    parse_file -> render at its golden's spp and depth (render picks the
    volumetric integrator for a scene with media), every query through the
    kernel of route ("tri_intersect" or "bvh8") and no plain version, the
    image gated against goldens/<name>_200_<spp>spp.exr with
    tools/golden.py's gates and written to pbrt_tpu_torch/_build/, paths/s
    with set-up apart. Returns (the parsed scene, the rung's dict)."""
    import torch
    from pbrt_tpu_torch.integrators import path as path_mod
    from pbrt_tpu_torch.integrators import render
    from pbrt_tpu_torch.ops import _build
    from pbrt_tpu_torch.ops import bvh as bvh_mod
    from pbrt_tpu_torch.ops import bvh8
    from pbrt_tpu_torch.scene import parser
    from pbrt_tpu_torch.utils import image
    spp, depth, max_mrse, max_ratio, trim = GOLDEN_RUNGS[name]
    reset_counts(named.values())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    desc, build_s = timed_calls(
        [(bvh8, "build_bvh8"), (bvh_mod, "build_bvh"),
         (bvh8, "collapse_to_bvh8")],
        lambda: parser.parse_file(ROOT / "scenes" / f"{name}.pbrt",
                                  device=dev))
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    s = desc.scene
    check(desc.sampler.spp == spp and s.mega is None,
          f"{name}: the scene's sampler or route")
    img, stats = render.render(s, desc.camera, sampler=desc.sampler,
                               device=dev,
                               opts=path_mod.PathOptions(max_depth=depth))
    launches = {c: k.launches for c, k in named.items()}
    plain = sum(k.plain for k in named.values())
    n_bytes = device_bytes(s)
    print(f"[{tag}] {s.n_tris} triangles, {s.light_sampler.n_lights} "
          f"lights (sampler kind {s.light_sampler.kind}"
          + (f", light BVH depth {s.light_sampler.max_depth}"
             if hasattr(s.light_sampler, "max_depth") else "")
          + f"), BxDF tags {s.bxdf_tags}, textures {s.has_textures}; "
          f"launches {launches}, plain-version runs {plain}; "
          f"{stats['lanes_per_wave']} lanes per wave; the tables "
          f"{n_bytes / 2**20:.2f} MiB on the card; BVH build "
          f"{build_s['build_bvh8']:.3f} s (native SAH "
          f"{build_s['build_bvh']:.3f} s, BVH8 collapse "
          f"{build_s['collapse_to_bvh8']:.3f} s)", flush=True)
    check(launches[route] >= 1
          and wave_launches(launches) == launches[route],
          f"{name} left the {route} route")
    check(plain == 0, f"{name} ran a plain version on the card")
    m, ratio = gate(img, ROOT / "goldens" / f"{name}_200_{spp}spp.exr",
                    (200, 200, 3), max_mrse, max_ratio, f"{tag} golden",
                    trim=trim)
    print(f"[{tag} golden] margins: mrse {max_mrse - m:.5f}, mean ratio err "
          f"{max_ratio - ratio:.5f} under the gates", flush=True)
    image.write_exr(_build.BUILD_DIR / f"{name}_200_{spp}spp.exr", img)
    print(f"[{tag} times] card {card}: {name} 200x200x{spp} depth {depth} "
          f"{stats['paths_per_sec']:.6g} paths/s ({stats['seconds']:.3f} s),"
          f" set-up (parse and build) {setup:.3f} s apart", flush=True)
    return desc, dict(paths_per_sec=stats["paths_per_sec"],
                      seconds=stats["seconds"], setup_s=setup, mrse=m,
                      mean_ratio_err=ratio, launches=launches[route],
                      device_bytes=n_bytes,
                      bvh_build_s=build_s["build_bvh8"],
                      bvh_sah_s=build_s["build_bvh"],
                      bvh_collapse_s=build_s["collapse_to_bvh8"])


def manylight_killeroo_phases(dev, card, named):
    """Phases 37-40: the manylight, manylight16k and killeroo rungs
    through parse_file -> render, gated against their goldens; then
    kernels 1 and 4 on one wave's own queries of each."""
    from pbrt_tpu_torch.ops import bvh8
    out = {}
    descs = {}
    for name, route, tag in (("manylight", "tri_intersect", "37 manylight"),
                             ("manylight16k", "bvh8", "38 manylight16k"),
                             ("killeroo", "bvh8", "39 killeroo")):
        descs[name], out[name] = golden_rung(name, dev, card, named, route,
                                             tag)
    # ---- 40. kernels 1 and 4 on these waves' own queries ----
    out["manylight"]["wave"] = tri_wave(
        descs["manylight"], GOLDEN_RUNGS["manylight"][1], dev, card,
        "40 manylight", out["manylight"]["launches"])
    for name in ("manylight16k", "killeroo"):
        depth = GOLDEN_RUNGS[name][1]
        closest, shadow, lanes = wave_queries(bvh8, "bvh8_intersect", 4,
                                              descs[name], depth, dev)
        wave = bvh_wave("bvh8", descs[name].scene, closest, shadow, 4, card,
                        dev, tag=f"40 {name} wave")
        wave.update(lanes=lanes, launches=len(closest) + len(shadow))
        print(f"[40 {name} wave] a render makes {out[name]['launches']} "
              "launches of the BVH8 kernel", flush=True)
        out[name]["wave"] = wave
    return out


def plytex_volume_phases(dev, card, named):
    """Phases 41-44: the plytex and volume rungs through parse_file ->
    render, gated against their goldens; kernel 4 on one plytex wave's
    queries and kernel 1 on one volume wave's; the medium-shell scene
    through render and kernel 7 on one of its waves' interface queries."""
    import types
    import numpy as np
    import torch
    from pbrt_tpu_torch import samplers as smp
    from pbrt_tpu_torch import scenes, spans
    from pbrt_tpu_torch.integrators import path as path_mod
    from pbrt_tpu_torch.integrators import render
    from pbrt_tpu_torch.ops import _build
    from pbrt_tpu_torch.ops import bvh2
    from pbrt_tpu_torch.ops import bvh8
    from pbrt_tpu_torch.utils import image
    out, descs = {}, {}
    # ---- 41. plytex: the BVH8 route with the exact sphere merged ----
    descs["plytex"], out["plytex"] = golden_rung("plytex", dev, card, named,
                                                 "bvh8", "41 plytex")
    s = descs["plytex"].scene
    check(s.n_tris == 5122 and s.n_spheres == 1 and s.use_bvh,
          "plytex: scene tables")
    # ---- 42. volume: the volumetric wave, kernel 1 ----
    flight = dict(calls="flight.calls", steps="flight.steps",
                  shadow_calls="shadow.calls", shadow_steps="shadow.steps")
    before = {k: spans.counter(c) for k, c in flight.items()}
    descs["volume"], out["volume"] = golden_rung("volume", dev, card, named,
                                                 "tri_intersect", "42 volume")
    s = descs["volume"].scene
    check(s.has_media and s.has_medium_interfaces and not s.use_iface_bvh
          and s.n_tris == 2, "volume: scene tables")
    fs = {k: spans.counter(c) - before[k] for k, c in flight.items()}
    out["volume"]["flight"] = fs
    print(f"[42 volume] flight loops of the render: {fs['calls']} free "
          f"flights in {fs['steps']} steps ({fs['steps'] / fs['calls']:.1f} "
          f"a flight), {fs['shadow_calls']} shadow loops in "
          f"{fs['shadow_steps']} steps "
          f"({fs['shadow_steps'] / max(fs['shadow_calls'], 1):.1f} a loop)",
          flush=True)

    # ---- 43. kernel 4 on a plytex wave, kernel 1 on a volume wave ----
    closest, shadow, lanes = wave_queries(bvh8, "bvh8_intersect", 4,
                                          descs["plytex"],
                                          GOLDEN_RUNGS["plytex"][1], dev)
    wave = bvh_wave("bvh8", descs["plytex"].scene, closest, shadow, 4, card,
                    dev, tag="43 plytex wave")
    wave.update(lanes=lanes, launches=len(closest) + len(shadow))
    out["plytex"]["wave"] = wave
    print(f"[43 plytex wave] a render makes {out['plytex']['launches']} "
          "launches of the BVH8 kernel", flush=True)
    out["volume"]["wave"] = tri_wave(descs["volume"],
                                     GOLDEN_RUNGS["volume"][1], dev, card,
                                     "43 volume", out["volume"]["launches"])

    # ---- 44. the medium shell: kernel 7 on the interface route ----
    reset_counts(named.values())
    t0 = time.perf_counter()
    shell, cam = scenes.make_medium_shell(200, 200, device=dev)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    check(shell.use_iface_bvh and shell.iface_tris.shape[0] == 320,
          "medium shell: the interface BVH route")
    sampler = smp.make_sampler("zsobol", spp=16, full_resolution=(200, 200))
    img, stats = render.render(shell, cam, sampler=sampler, device=dev,
                               opts=path_mod.PathOptions(max_depth=5))
    launches = {c: k.launches for c, k in named.items()}
    plain = sum(k.plain for k in named.values())
    print(f"[44 shell] {shell.iface_tris.shape[0]} interface triangles "
          f"(BVH depth {shell.iface_depth}), {shell.n_tris} triangles; "
          f"launches {launches}, plain-version runs {plain}", flush=True)
    check(launches["bvh2"] >= 1 and launches["tri_intersect"] >= 1
          and wave_launches(launches) == launches["bvh2"]
          + launches["tri_intersect"], "the shell left its kernels' route")
    check(plain == 0, "the shell ran a plain version on the card")
    check(bool(np.isfinite(img).all()) and float(img.mean()) > 0,
          "the shell's image: finite and lit")
    image.write_exr(_build.BUILD_DIR / "shell_200_16spp.exr", img)
    print(f"[44 times] card {card}: medium shell 200x200x16 depth 5 "
          f"{stats['paths_per_sec']:.6g} paths/s ({stats['seconds']:.3f} s),"
          f" set-up {setup:.3f} s apart; image mean {float(img.mean()):.5f}",
          flush=True)
    desc = types.SimpleNamespace(scene=shell, camera=cam, sampler=sampler)
    closest, shadow, lanes = wave_queries(bvh2, "bvh2_intersect", 5, desc,
                                          5, dev)
    check(closest and not shadow, "the shell's interface queries")
    wave = bvh_wave("bvh2", shell, closest, shadow, 5, card, dev,
                    tag="44 shell wave")
    wave.update(lanes=lanes, launches=len(closest))
    out["shell"] = dict(paths_per_sec=stats["paths_per_sec"],
                        seconds=stats["seconds"], setup_s=setup,
                        launches=launches["bvh2"],
                        tri_launches=launches["tri_intersect"], wave=wave)
    print(f"[44 shell wave] a render makes {launches['bvh2']} launches of "
          "the single-level bvh2 kernel", flush=True)
    return out


def front_phases(dev, card):
    """Phase 45: the front end's lanes and film kernels (ops/megafront) and
    the film's readout kernel (ops/film_readout) on cornell.1080p's wave
    (1920x1080, one sample index a wave, sample index 37 of 64): each
    against its plain version on the card (mi, lam, le, the film's
    accumulator and the image bit for bit), then each timed with CUDA events
    as bare launches queued behind a spin (the device's time) beside its
    bound (bytes once over 3.35 TB/s) and its plain version's time, and the
    megakernel's launch on the same wave."""
    import torch
    from pbrt_tpu_torch import film as film_mod
    from pbrt_tpu_torch import filters as flt
    from pbrt_tpu_torch import samplers as smp
    from pbrt_tpu_torch import scenes
    from pbrt_tpu_torch.ops import film_readout, megafront, megawave
    from pbrt_tpu_torch.utils import color as pcolor
    W, H, s = 1920, 1080, 37
    scene, cam = scenes.make_cornell_box(W, H, device=dev)
    film = film_mod.make_film(W, H, dev)
    front = megafront.prepare(
        scene, cam, smp.make_sampler("zsobol", 64, 3, full_resolution=(W, H)),
        flt.make_filter("gaussian"), film_mod.make_pixel_sensor(), film, 1)
    w, n = front.full, W * H
    megafront.lanes(front, s)
    got = [x.clone() for x in (w.mi, w.lam, w.le)]
    megafront.lanes_plain(front, s)
    lanes_eq = all(torch.equal(g.view(torch.int32), x.view(torch.int32))
                   for g, x in zip(got, (w.mi, w.lam, w.le)))
    megawave.launch(front.mega_args)
    film.accum.uniform_()
    accum0 = film.accum.clone()
    megafront.film(front)
    got = film.accum.clone()
    film.accum.copy_(accum0)
    megafront.film_plain(front)
    film_eq = torch.equal(got.view(torch.int32), film.accum.view(torch.int32))
    ro_args = (film.accum, H, W, front.sensor.xyz_from_sensor_rgb,
               pcolor.srgb().rgb_from_xyz)
    readout_eq = torch.equal(
        film_readout.film_readout(*ro_args).view(torch.int32),
        film_readout.film_readout_plain(*ro_args).view(torch.int32))
    print(f"[45 front] {n} lanes: lanes kernel bit-equal to its plain version"
          f" {lanes_eq}; film kernel's accumulator bit-equal {film_eq}; "
          f"readout kernel's image bit-equal {readout_eq}", flush=True)
    check(lanes_eq, "the lanes kernel differs from its plain version")
    check(film_eq, "the film kernel differs from its plain version")
    check(readout_eq, "the readout kernel differs from its plain version")
    lanes_b = bound(n * (4 + 16 + 16) + 4 * 471, 0)
    film_b = bound(n * (16 + 4 + 16) + 2 * 32 * n, 0)
    # the accumulator's 32 B rows read (16 B used, a whole sector fetched),
    # the image's 12 B a pixel written
    readout_b = bound(n * (32 + 12), 0)
    t = dict(lanes=cuda_ms(lambda: megafront.lanes(front, s), 50, 3, True),
             film=cuda_ms(lambda: megafront.film(front), 50, 3, True),
             megawave=cuda_ms(lambda: megawave.launch(front.mega_args), 20,
                              3, True),
             readout=cuda_ms(lambda: film_readout.film_readout(*ro_args), 50,
                             3, True),
             lanes_plain=cuda_ms(lambda: megafront.lanes_plain(front, s), 5),
             film_plain=cuda_ms(lambda: megafront.film_plain(front), 5),
             readout_plain=cuda_ms(
                 lambda: film_readout.film_readout_plain(*ro_args), 5))
    print(f"[45 times] card {card}: bare queued ms: lanes kernel "
          f"{t['lanes']:.4f} (bound {lanes_b[0]:.4f}, {lanes_b[1]}; plain "
          f"{t['lanes_plain']:.3f}), film kernel {t['film']:.4f} (bound "
          f"{film_b[0]:.4f}, {film_b[1]}; plain {t['film_plain']:.3f}), "
          f"readout kernel {t['readout']:.4f} (bound {readout_b[0]:.4f}, "
          f"{readout_b[1]}; plain {t['readout_plain']:.3f}), megakernel "
          f"{t['megawave']:.4f}", flush=True)
    return dict(ms=t, lanes_bound=lanes_b, film_bound=film_b,
                readout_bound=readout_b)


def same_bits(a, b) -> bool:
    """Equal bit for bit (zeros with their sign), any NaN matching any
    NaN; bools equal."""
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.bool:
        return torch.equal(a, b)
    return bool(((a.view(torch.int32) == b.view(torch.int32))
                 | (torch.isnan(a) & torch.isnan(b))).all())


def bxdf_phases(dev, card):
    """Phase 46: the BxDF kernel (ops/bxdf, csrc/bxdf.cu) on one killeroo
    wave (200x200, 4 spp: 160,000 lanes, depth 5): every bsdf_f, bsdf_pdf
    and bsdf_sample call of the wave goes through the kernel and is held
    bit for bit to the plain version on the same inputs; then depth 0's
    eval and sample are timed as bare launches queued behind a spin (the
    device's time) beside their bound (every input byte read and output
    byte written once over 3.35 TB/s), through the wrapper (host and
    device), and the plain versions (bsdf_f_plain + bsdf_pdf_plain, as NEE
    calls both; bsdf_sample_plain)."""
    import ctypes
    import torch
    from pbrt_tpu_torch import bxdfs
    from pbrt_tpu_torch import samplers as smp
    from pbrt_tpu_torch.integrators import path as path_mod
    from pbrt_tpu_torch.integrators import render
    from pbrt_tpu_torch.ops import bxdf
    from pbrt_tpu_torch.scene import parser
    desc = parser.parse_file(ROOT / "scenes" / "killeroo.pbrt", device=dev)
    W, H = desc.camera.width, desc.camera.height
    names = ("bsdf_f", "bsdf_pdf", "bsdf_sample")
    calls = {name: [] for name in names}
    fns = {name: getattr(bxdfs, name) for name in names}

    def recorder(name):
        def recording(*a):
            calls[name].append(a)
            return fns[name](*a)
        return recording
    launches, plain = bxdf.counter.launches, bxdf.counter.plain
    for name in names:
        setattr(bxdfs, name, recorder(name))
    try:
        render.render(desc.scene, desc.camera, device=dev,
                      sampler=smp.make_sampler("zsobol", spp=4,
                                               full_resolution=(W, H)),
                      opts=path_mod.PathOptions(max_depth=5))
    finally:
        for name in names:
            setattr(bxdfs, name, fns[name])
    torch.cuda.synchronize()
    n_calls = sum(len(c) for c in calls.values())
    launched = bxdf.counter.launches - launches
    check(launched == n_calls and bxdf.counter.plain == plain,
          f"the wave's {n_calls} BxDF calls made {launched} kernel launches "
          f"and {bxdf.counter.plain - plain} plain runs")
    bad = []
    for name in ("bsdf_f", "bsdf_pdf"):
        for depth, a in enumerate(calls[name]):
            if not same_bits(fns[name](*a),
                             getattr(bxdfs, f"{name}_plain")(*a)):
                bad.append(f"{name} call {depth}")
    for depth, a in enumerate(calls["bsdf_sample"]):
        got, want = bxdfs.bsdf_sample(*a), bxdfs.bsdf_sample_plain(*a)
        bad += [f"bsdf_sample call {depth} {k}" for k in want
                if not same_bits(got[k], want[k])]
    n = calls["bsdf_f"][0][1].shape[0]
    print(f"[46 bxdf] killeroo wave, {n} lanes, tags "
          f"{calls['bsdf_f'][0][0].tags_present}: {n_calls} calls "
          f"({', '.join(f'{k} {len(v)}' for k, v in calls.items())}), "
          f"{launched} launches, every output bit-equal to the plain "
          f"version: {not bad} {bad[:4]}", flush=True)
    check(not bad, f"the BxDF kernel differs from its plain version: {bad}")
    p, wo, wi = calls["bsdf_f"][0]
    sp, swo, uc, u2 = calls["bsdf_sample"][0]
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    eval_args, _ = bxdf.eval_args(p, wo, wi)
    sample_args, _ = bxdf.sample_args(sp, swo, uc, u2)
    # tag 4, albedo 16, alpha_x and alpha_y 8, eta 16, k 16 B and wo 12 a
    # lane, then eval's wi 12, or sample's uc 4 and u2 8; written: f 16 and
    # pdf 4, or also wi 12, eta_scale 4 and four bools
    eval_b = bound(n * (72 + 12 + 20), 0)
    sample_b = bound(n * (72 + (4 if uc is not None else 0) + 8 + 40), 0)
    t = dict(eval=bare_ms("bxdf", "bxdf_eval_launch", (*eval_args, stream),
                          reps=50),
             sample=bare_ms("bxdf", "bxdf_sample_launch",
                            (*sample_args, stream), reps=50),
             eval_wrapper=cuda_ms(lambda: bxdfs.bsdf_f(p, wo, wi), 50, 3),
             sample_wrapper=cuda_ms(
                 lambda: bxdfs.bsdf_sample(sp, swo, uc, u2), 50, 3),
             eval_plain=cuda_ms(lambda: (bxdfs.bsdf_f_plain(p, wo, wi),
                                         bxdfs.bsdf_pdf_plain(p, wo, wi)), 5),
             sample_plain=cuda_ms(
                 lambda: bxdfs.bsdf_sample_plain(sp, swo, uc, u2), 5))
    print(f"[46 times] card {card}: {n} lanes, bare queued ms: eval "
          f"{t['eval']:.4f} (bound {eval_b[0]:.4f}, {eval_b[1]}), sample "
          f"{t['sample']:.4f} (bound {sample_b[0]:.4f}, {sample_b[1]}); "
          f"through the wrapper, one call: bsdf_f {t['eval_wrapper']:.4f}, "
          f"bsdf_sample {t['sample_wrapper']:.4f}; plain: bsdf_f + bsdf_pdf "
          f"{t['eval_plain']:.3f}, bsdf_sample {t['sample_plain']:.3f}",
          flush=True)
    return dict(ms=t, eval_bound=eval_b, sample_bound=sample_b,
                launches=launched)


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
    from pbrt_tpu_torch.ops import film_readout
    from pbrt_tpu_torch.ops import megafront
    from pbrt_tpu_torch.ops import megawave
    from pbrt_tpu_torch.ops import tri_intersect as ti
    from pbrt_tpu_torch.scene import parser
    from pbrt_tpu_torch.utils import image
    from pbrt_tpu_torch.utils import spectrum as spc
    named = {"megawave": megawave.counter, "tri_intersect": ti.counter,
             "mega_lanes": megafront.lanes_counter,
             "mega_film": megafront.film_counter,
             "film_readout": film_readout.counter,
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
    launches = {k: named[k].launches for k in ("mega_lanes", "megawave",
                                               "mega_film", "film_readout",
                                               "tri_intersect")}
    plain_runs = sum(c.plain for c in counters)
    waves5 = 64 * 400 * 400 // stats["lanes_per_wave"]
    print(f"[5 render] launches {launches}, plain-version runs "
          f"{plain_runs}; {stats['seconds']:.3f} s, "
          f"{stats['paths_per_sec']:.6g} paths/s, "
          f"{stats['lanes_per_wave']} lanes per wave", flush=True)
    check(launches["megawave"] == launches["mega_lanes"] ==
          launches["mega_film"] == waves5,
          "main path: not one lanes, megakernel and film launch a wave")
    check(launches["film_readout"] == 1,
          "main path: not one readout launch a render")
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
    mw_work = megawave.counter.work
    mw_bound = megawave_bound(w6, mw_work)
    mw_ms = cuda_ms(lambda: megawave.wave_full(w6), reps=20, warmup=3)
    mw_bare_ms = megawave_bare_ms(w6)
    mw_plain_ms = cuda_ms(lambda: megawave.wave_full_plain(w6), reps=3)
    o6, d6, _t = seeded_rays(n_pix, dev, seed=8)
    far6 = torch.full_like(_t, 1e30)
    ti_ms = cuda_ms(lambda: ti.tri_intersect(scene.tri_pallas, o6, d6, far6,
                                             n_real, False), reps=50,
                    warmup=3)
    ti_plain_ms = cuda_ms(lambda: ti.tri_intersect_plain(
        scene.tri_pallas, o6, d6, far6, n_real, False), reps=5)
    print(f"[6 times] card {card}: megakernel {mw_ms:.4f} ms/wave through "
          f"the wrapper, {mw_bare_ms:.4f} ms the bare launch, vs plain "
          f"{mw_plain_ms:.4f} ms ({n_pix} lanes, depth 5); tri_intersect "
          f"{ti_ms:.4f} ms vs plain {ti_plain_ms:.4f} ms ({n_pix} rays); "
          f"render {stats['paths_per_sec']:.6g} paths/s", flush=True)
    show_megawave_bound("6 megakernel bound", card, mw_bound, mw_work)

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
        want = bvh8.bvh8_intersect_plain(
            b8, o7, d7, torch.full((n_rays,), t_max, device=dev), any_hit)
        if not any_hit:
            b8_work = bvh8.counter.work
        b8_err = max(b8_err, hold_bits(got, want, "7 bvh8", any_hit))

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
        b_ms = bare_ms("bvh8", "bvh8_intersect_launch",
                       bvh8.launch_args(b8, o7, d7, tv, any_hit)[0])
        p_ms = cuda_ms(lambda: bvh8.bvh8_intersect_plain(b8, o7, d7, tv,
                                                         any_hit), reps=2)
        b8_ms[any_hit] = (k_ms, p_ms, b_ms)
        print(f"[10 times] card {card}: bvh8 any_hit={any_hit} kernel "
              f"{k_ms:.4f} ms through the wrapper, {b_ms:.4f} ms the bare "
              f"launch ({n_rays / b_ms / 1e3:.2f} Mrays/s) vs plain "
              f"{p_ms:.4f} ms ({n_rays / p_ms / 1e3:.3f} Mrays/s), {n_rays} "
              "rays", flush=True)
    print(f"[10 times] card {card}: meshfield 200x200x32 "
          f"{mstats['paths_per_sec']:.6g} paths/s; cornell general wave "
          f"400x400x64 {gstats['paths_per_sec']:.6g} paths/s; cornell "
          f"megakernel {stats['paths_per_sec']:.6g} paths/s", flush=True)

    # ---- 11. the bvh8 and bvh2 libraries' ptxas reports ----
    # (an empty log: the library was built before this run)
    for name, what, n_entries in (("bvh8", "the BVH8 kernel", 1),
                                  ("bvh2", "single- and two-level kernels",
                                   2)):
        entries = ptxas_entries(libs[name][1])
        print(f"[11 {name} build] ptxas, {what}: {entries}", flush=True)
        check(not entries or sum("registers" in ln for ln in entries)
              == n_entries, f"{name}: ptxas reported other than {n_entries} "
              "entries")

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
                                           depth=sc8.tlas_depth,
                                           kernel=sc8.tlas_kernel)
            want = bvh2.two_level_plain(*tables, o8, d8, tv, any_hit)
            k8_work[label, any_hit] = bvh2.counter_two_level.work
            k8_err = max(k8_err, hold_bits(got, want, f"13 two_level {label}",
                                           any_hit))
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
            kargs = bvh2.launch_args(sc8.tlas_nodes, sc8.tlas_kernel,
                                     sc8.tlas_root, o8, d8, tv, any_hit)[0]
            k8_ms[label, any_hit] = (
                cuda_ms(lambda: bvh2.two_level_intersect(
                    *tables, o8, d8, tv, any_hit, depth=sc8.tlas_depth,
                    kernel=sc8.tlas_kernel), reps=20, warmup=3),
                cuda_ms(lambda: bvh2.two_level_plain(
                    *tables, o8, d8, tv, any_hit), reps=1),
                bare_ms("bvh2", "two_level_launch", kargs))
            k_ms, p_ms, b_ms = k8_ms[label, any_hit]
            print(f"[15 times] card {card}: two_level {label} any_hit="
                  f"{any_hit} kernel {k_ms:.4f} ms through the wrapper, "
                  f"{b_ms:.4f} ms the bare launch "
                  f"({n_rays / b_ms / 1e3:.2f} Mrays/s) vs plain "
                  f"{p_ms:.4f} ms ({n_rays / p_ms / 1e3:.3f} Mrays/s)",
                  flush=True)
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
    rd = redesign_phases(dev, card, named, scene, dict(
        meshfield=desc, instances=idesc, hair=cr["desc"],
        patches=pt.pop("desc")))
    t_new = time.perf_counter()
    ev = envlit_phases(dev, card, named)
    print(f"[36 envlit wave] phases 35-36 took "
          f"{time.perf_counter() - t_new:.1f} s", flush=True)
    t_new = time.perf_counter()
    mk = manylight_killeroo_phases(dev, card, named)
    print(f"[40 times] phases 37-40 took {time.perf_counter() - t_new:.1f} "
          "s", flush=True)
    t_new = time.perf_counter()
    pv = plytex_volume_phases(dev, card, named)
    shell = pv.pop("shell")
    mk.update(pv)
    print(f"[44 times] phases 41-44 took {time.perf_counter() - t_new:.1f} "
          "s", flush=True)
    mk["front"] = front_phases(dev, card)
    mk["bxdf"] = bxdf_phases(dev, card)

    bad = [name for name in sys.modules
           if name.split(".")[0] in ("jax", "jaxlib", "flax", "pbrt_tpu")]
    check(not bad, f"imported modules of the JAX stack: {bad}")
    # bounds, from this run's inputs: the megakernels' work as their plain
    # version counted it (megawave_bound), the triangle kernel's n_rays x
    # n_real tests, the BVH queries' visits
    ti_bound = bound(n_pix * (28 + 16) + 4 * scene.tri_pallas.numel(),
                     n_pix * n_real * TRI_OPS)
    b8_bound = traversal_bound(b8_work, n_rays, 16,
                               (b8.nodes_f, b8.nodes_q, b8.tris,
                                b8.prim_indices), tri_ops=TRI_OPS,
                               visit_ops=8 * BVH8_CHILD_OPS)
    k7_bound = traversal_bound(k7_work[False], n_rays, 16,
                               (k7["nodes"], k7["tris"]))
    k8_bound = traversal_bound(k8_work["grid64", False], n_rays, 20,
                               two_level_bound_tables(grid),
                               tri_ops=TRI_OPS_EDGES)
    for what, (b_ms, b_by), k_ms in (("megawave", (mw_bound["bound_ms"],
                                                   mw_bound["bound_by"]),
                                      mw_bare_ms),
                                     ("tri_intersect", ti_bound, ti_ms),
                                     ("bvh8", b8_bound, b8_ms[False][2]),
                                     ("bvh2", k7_bound, k7_ms[False][0]),
                                     ("two_level", k8_bound,
                                      k8_ms["grid64", False][2]),
                                     ("curves", cr["bound"],
                                      cr["ms"][False][0]),
                                     ("megawave_rays",
                                      (ri["bound"]["bound_ms"],
                                       ri["bound"]["bound_by"]),
                                      ri["bare_ms"]),
                                     ("bvh8_forest", tr["forest"]["bound"],
                                      tr["forest"]["ms"]),
                                     ("bvh8_binned", tr["binned"]["bound"],
                                      tr["binned"]["ms"])):
        print(f"[bounds] card {card}: {what} bound {b_ms:.5f} ms by {b_by}, "
              f"kernel {k_ms:.4f} ms ({b_ms / k_ms * 100:.2f}% of the "
              "bound)", flush=True)
    # what a render loses in each kernel: its launches x (a launch's time at
    # the size the render launches - its bound); the triangle kernel and
    # the megakernels by their bare launch (the wrapper's time is host work)
    tri32 = rd["tri_ms"][32]
    for what, n_launch, k_ms, b_ms in (
            ("megawave (cornell)", launches["megawave"], mw_bare_ms,
             mw_bound["bound_ms"]),
            ("megawave_rays (rays-in cornell)", ri["launches"],
             ri["bare_ms"], ri["bound"]["bound_ms"]),
            ("tri_intersect (general-wave cornell, 32 triangles)",
             glaunch["tri_intersect"], tri32["bare_ms"], tri32["bound_ms"]),
            ("tri_intersect (envlit, 1,538 triangles)", ev["launches"],
             ev["wave"]["bare_sum_ms"] / ev["wave"]["launches"],
             ev["wave"]["bound_ms"]),
            *((f"{kname} ({name})", mk[name]["launches"],
               mk[name]["wave"]["bare_sum_ms"] / mk[name]["wave"]["launches"],
               mk[name]["wave"]["bound_ms"]) for kname, name in (
                ("tri_intersect", "manylight"), ("bvh8", "manylight16k"),
                ("bvh8", "killeroo"), ("bvh8", "plytex"),
                ("tri_intersect", "volume"))),
            ("bvh2 (the medium shell's interfaces)", shell["launches"],
             shell["wave"]["bare_sum_ms"] / shell["wave"]["launches"],
             shell["wave"]["bound_ms"]),
            *((f"{name} ({path})", n,
               w.get("bare_sum_ms", w["sum_ms"]) / w["launches"],
               w["bound_ms"]) for name, path, n, w in (
                ("bvh8", "meshfield", mlaunch["bvh8"], rd["wave_ms"]["bvh8"]),
                ("two_level", "instances", ilaunch["two_level"],
                 rd["wave_ms"]["two_level"]),
                ("curves", "hair", cr["launches"],
                 rd["wave_ms"]["curves"])))):
        print(f"[launches x gap] card {card}: {what}: {n_launch} launches x "
              f"({k_ms:.4f} - {b_ms:.5f}) ms = {n_launch * (k_ms - b_ms):.2f} "
              "ms a render", flush=True)
    kernels = [
        # ms through the wrapper, bare_ms the launch alone (its arguments
        # prepared once: the launches x gap line's); bound_* from the plain
        # version's count of the work on phase 6's wave (megawave_bound)
        dict(name="megawave", route="cuda",
             source="pbrt_tpu_torch/csrc/megawave.cu",
             replaces="pbrt_tpu/ops/megawave.py:559",
             launches=launches["megawave"], max_abs_err=mw_err,
             ms=mw_ms, bare_ms=mw_bare_ms, plain_ms=mw_plain_ms,
             library_ms=None,
             **mw_bound),
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
             hair_max_abs_err=cr["tri_err"],
             # phases 31-33: 160,000 rays at 32, 1,280 and 4,096 triangles
             # (ms through the wrapper, bare_ms the launch alone, bvh8_ms
             # the BVH8 kernel on the same mesh and rays); the sphere
             # render's launches
             by_triangles=rd["tri_ms"], big_pool_max_abs_err=rd["tri_err"],
             sphere_launches=rd["sphere_launches"],
             # phases 35-36: the envlit render's launches and one envlit
             # wave's queries at 1,538 triangles (bare launches, bounds)
             envlit_launches=ev["launches"], envlit_wave=ev["wave"],
             # phases 37 and 40: the manylight render's launches and one
             # manylight wave's queries at 1,324 triangles
             manylight_launches=mk["manylight"]["launches"],
             manylight_wave=mk["manylight"]["wave"],
             # phases 42-43: the volume render's launches (2 triangles;
             # the interface box is tensor code) and one volume wave's
             volume_launches=mk["volume"]["launches"],
             volume_wave=mk["volume"]["wave"]),
        # launches: the meshfield render (phase 8); ms: closest hit at
        # 2^20 rays (any hit in any_hit_ms)
        dict(name="bvh8", route="cuda",
             source="pbrt_tpu_torch/csrc/bvh8.cu",
             replaces="pbrt_tpu/ops/pallas_bvh8.py:793",
             launches=mlaunch["bvh8"], max_abs_err=b8_err,
             ms=b8_ms[False][0], bare_ms=b8_ms[False][2],
             plain_ms=b8_ms[False][1],
             bound_ms=b8_bound[0], bound_by=b8_bound[1], library_ms=None,
             any_hit_ms=b8_ms[True][0], any_hit_bare_ms=b8_ms[True][2],
             any_hit_plain_ms=b8_ms[True][1],
             # phase 34: the queries of one meshfield wave
             wave=rd["wave_ms"]["bvh8"],
             # phases 38-40: the manylight16k (17,100 triangles) and
             # killeroo (163,842) renders' launches and one wave's queries
             manylight16k_launches=mk["manylight16k"]["launches"],
             manylight16k_wave=mk["manylight16k"]["wave"],
             killeroo_launches=mk["killeroo"]["launches"],
             killeroo_wave=mk["killeroo"]["wave"],
             # phases 41 and 43: the plytex render (5,122 triangles and the
             # merged sphere) and one plytex wave's queries
             plytex_launches=mk["plytex"]["launches"],
             plytex_wave=mk["plytex"]["wave"]),
        # launches: the medium-shell render's interface queries (phase
        # 44, its render path: interface pools above 256 triangles); its
        # checks and times: phases 12 and 15, closest hit on meshfield's
        # binary BVH at 2^20 rays; one shell wave's queries in shell_wave
        dict(name="bvh2", route="cuda", source="pbrt_tpu_torch/csrc/bvh2.cu",
             replaces="pbrt_tpu/ops/pallas_bvh.py:167",
             launches=shell["launches"], max_abs_err=k7_err,
             ms=k7_ms[False][0], plain_ms=k7_ms[False][1],
             bound_ms=k7_bound[0], bound_by=k7_bound[1], library_ms=None,
             any_hit_ms=k7_ms[True][0], any_hit_plain_ms=k7_ms[True][1],
             shell_wave=shell["wave"]),
        # launches: the instances render (phase 14); ms: closest hit on the
        # 64-instance grid at 2^20 rays (the golden's tables in golden_ms)
        dict(name="two_level", route="cuda",
             source="pbrt_tpu_torch/csrc/bvh2.cu",
             replaces="pbrt_tpu/ops/pallas_bvh.py:521",
             launches=ilaunch["two_level"], max_abs_err=k8_err,
             ms=k8_ms["grid64", False][0],
             bare_ms=k8_ms["grid64", False][2],
             plain_ms=k8_ms["grid64", False][1], bound_ms=k8_bound[0],
             bound_by=k8_bound[1], library_ms=None,
             any_hit_ms=k8_ms["grid64", True][0],
             any_hit_bare_ms=k8_ms["grid64", True][2],
             any_hit_plain_ms=k8_ms["grid64", True][1],
             golden_ms=k8_ms["golden", False][0],
             golden_bare_ms=k8_ms["golden", False][2],
             golden_plain_ms=k8_ms["golden", False][1],
             wave=rd["wave_ms"]["two_level"]),
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
             any_hit_plain_ms=cr["ms"][True][1],
             wave=rd["wave_ms"]["curves"]),
        # the rays-in entry of megawave.cu; launches: the 64 waves of phase
        # 23; ms: one 160,000-lane wave at depth 5 (the in-kernel-camera
        # entry on the same lanes in full_camera_ms); max_abs_err: against
        # its plain version (phase 22)
        dict(name="megawave_rays", route="cuda",
             source="pbrt_tpu_torch/csrc/megawave.cu",
             replaces="pbrt_tpu/ops/megawave.py:531",
             launches=ri["launches"], max_abs_err=ri["err"], ms=ri["ms"],
             bare_ms=ri["bare_ms"], plain_ms=ri["plain_ms"], library_ms=None,
             **ri["bound"],
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
        terrain_bvh8_ms=tr["bvh8_ms"], patches=pt, envlit=ev["render"],
        shell={k: v for k, v in shell.items() if k != "wave"},
        **{name: {k: v for k, v in mk[name].items() if k != "wave"}
           for name in GOLDEN_RUNGS})))
    print(f"card: {card}")
    print(json.dumps(dict(kernels=kernels)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
