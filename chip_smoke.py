#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (pbrt_tpu_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1):
  1. start: a CUDA device must be present (else exit 2); print the card's
     name and power limit as nvidia-smi reports them;
  2. build the two CUDA kernels from pbrt_tpu_torch/csrc with nvcc;
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
     each kernel beside its plain version, and the render in paths/s.
The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
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


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import numpy as np
    from pbrt_tpu_torch import filters as flt
    from pbrt_tpu_torch import samplers as smp
    from pbrt_tpu_torch import scenes
    from pbrt_tpu_torch.integrators import path as path_mod
    from pbrt_tpu_torch.integrators import render
    from pbrt_tpu_torch.ops import _build
    from pbrt_tpu_torch.ops import megawave
    from pbrt_tpu_torch.ops import tri_intersect as ti
    from pbrt_tpu_torch.utils import image
    from pbrt_tpu_torch.utils import spectrum as spc

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
    lib_path, log = _build.build()
    _build.load_library()
    regs = [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]
    print(f"[2 build] {lib_path.name} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc sm_90a -fmad=false); ptxas: {regs}", flush=True)

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
    for c in (megawave.counter, ti.counter):
        c.launches = 0
        c.plain = 0
    img, stats = render.render(scene, cam, spp=64, device=dev,
                               opts=path_mod.PathOptions(max_depth=5))
    launches = {"megawave": megawave.counter.launches,
                "tri_intersect": ti.counter.launches}
    plain_runs = megawave.counter.plain + ti.counter.plain
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

    bad = [name for name in sys.modules
           if name.split(".")[0] in ("jax", "jaxlib", "flax", "pbrt_tpu")]
    check(not bad, f"imported modules of the JAX stack: {bad}")
    kernels = [
        dict(name="megawave", route="cuda",
             source="pbrt_tpu_torch/csrc/megawave.cu",
             replaces="pbrt_tpu/ops/megawave.py:559",
             launches=launches["megawave"], max_abs_err=mw_err,
             ms=mw_ms, plain_ms=mw_plain_ms),
        # its test runs inside every megakernel launch
        # (csrc/tri_intersect.cuh); the standalone kernel serves callers
        # outside the main path, so the main path launches it 0 times
        dict(name="tri_intersect", route="cuda",
             source="pbrt_tpu_torch/csrc/tri_intersect.cu",
             replaces="pbrt_tpu/ops/pallas_intersect.py:125",
             launches=launches["tri_intersect"], max_abs_err=tri_err,
             ms=ti_ms, plain_ms=ti_plain_ms,
             runs_inside="megawave"),
    ]
    print(json.dumps(dict(render=dict(
        paths_per_sec=stats["paths_per_sec"], seconds=stats["seconds"],
        mrse=m, mean_ratio_err=ratio))))
    print(f"card: {card}")
    print(json.dumps(dict(kernels=kernels)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
