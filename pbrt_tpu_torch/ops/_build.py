"""Build and load the CUDA kernels of csrc/.

Each `.cu` file compiles with nvcc into a shared library of its own with a
plain C interface, loaded with ctypes (no PyTorch headers, so a build
takes seconds). `build()` starts one nvcc per source, all at once, and
waits for them together. A library is built at first use into
pbrt_tpu_torch/_build/, named by a hash of its source, the shared headers
and the flags, so an edited source rebuilds and an unchanged one is
reused.

Flags: sm_90a (Hopper), -O3, and -fmad=false, so that every multiply and
add rounds on its own the way the plain PyTorch versions' separate ops do
(the triangle and slab tests and the path's hit and Russian-roulette
decisions depend on it).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

from .. import spans

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# source name -> {entry point: argtypes}
SIGNATURES = {
    "tri_intersect": {
        # tri, o, d, t_max, t, prim, b1, b2, n, n_tris, n_real, any_hit,
        # stream
        "tri_intersect_launch": [_P] * 8 + [_I] * 4 + [_P],
    },
    "megawave": {
        # cam, tri, attr, light, mat, seeds, sobol, mi, lam, le, o, d, L,
        # fw, next_lane, n, n_tris, n_real, n_mats, n_lights, n_dims,
        # max_depth, rr_start, B, log2_spp, ls_uniform, 9 filter constants,
        # stream
        "megawave_launch": [_P] * 15 + [_I] * 11 + [_F] * 9 + [_P],
        # n, n_tris, n_real, n_mats, n_lights, n_dims, then out: blocks,
        # blocks an SM, threads a block
        "megawave_grid": [_I] * 6 + [_P] * 3,
    },
    "megafront": {
        # s, seeds, spec, mi, lam, le, n, n_pix, width, log2_spp, B, stream
        "mega_lanes_launch": [_I] + [_P] * 5 + [_I] * 5 + [_P],
        # L, fw, lam, accum, n_pix, m, imaging_ratio, stream
        "mega_film_launch": [_P] * 4 + [_I] * 2 + [_F] + [_P],
    },
    "film": {
        # accum, out, n_pix, s (9 float32, host), m (9 float64, host),
        # stream
        "film_readout_launch": [_P, _P, _I, _P, _P, _P],
    },
    "bxdf": {
        # tag, albedo, alpha_x, alpha_y, eta, k, wo, wi, f, pdf, n,
        # present, single, stream
        "bxdf_eval_launch": [_P] * 10 + [_I] * 3 + [_P],
        # tag, albedo, alpha_x, alpha_y, eta, k, wo, uc, u2, wi, f, pdf,
        # valid, specular, transmission, eta_scale, dispersed, n, present,
        # single, stream
        "bxdf_sample_launch": [_P] * 17 + [_I] * 3 + [_P],
    },
    "bvh8": {
        # nodes_f, nodes_q, tris, prim_indices, o, d, t_max, t, prim, b1,
        # b2, n, any_hit, stream
        "bvh8_intersect_launch": [_P] * 11 + [_I] * 2 + [_P],
        # n, then out: blocks, blocks an SM, threads a block
        "bvh8_grid": [_I] + [_P] * 3,
    },
    "bvh8_forest": {
        # meta, pages, o, d, t_max, t, prim, b1, b2, n, n_chunks,
        # page_floats, any_hit, stream
        "bvh8_forest_launch": [_P] * 9 + [_I] * 4 + [_P],
    },
    "bvh8_binned": {
        # nodes_f, nodes_q, tris, page_start, sched, valid, o, d, t, slot,
        # b1, b2, n, P, nfl, nql, tl, any_hit, stream
        "bvh8_binned_launch": [_P] * 12 + [_I] * 6 + [_P],
    },
    "bvh2": {
        # nodes, tris, o, d, t_max, t, prim, b1, b2, n, any_hit, stream
        "bvh2_intersect_launch": [_P] * 9 + [_I] * 2 + [_P],
        # nodes, insts, rows, o, d, t_max, t, prim, b1, b2, inst, n,
        # tlas_root, any_hit, stream
        "two_level_launch": [_P] * 11 + [_I] * 3 + [_P],
    },
    "curves": {
        # nodes, wide, segs, o, d, t_max, t, seg, next_ray, n, any_hit,
        # stream
        "curves_intersect_launch": [_P] * 9 + [_I] * 2 + [_P],
    },
    "dma_probe": {
        # pages, x, out, n_pages, rows, page, variant, copy, reduce, blocks,
        # smem, stream
        "dma_var_launch": [_P] * 3 + [_I] * 8 + [_P],
        # pages, sched, x, out, n_pages, rows, B, P, pipelined, copy,
        # reduce, smem, stream
        "dma_sched_launch": [_P] * 4 + [_I] * 8 + [_P],
        # pages, sched, x, out, n_pages, rows, B, P, stage, copy, reduce,
        # smem, stream
        "dma_ladder_launch": [_P] * 4 + [_I] * 8 + [_P],
    },
}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


@spans.span("kernels.build")
def build(names=None) -> dict:
    """Compile the libraries of `names` (default: every source) that are
    not built yet, one nvcc process per source, all started together.
    Returns {name: (path, the compiler's output: ptxas registers and
    spills, empty when the library was already built)}."""
    names = list(SIGNATURES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    done, running = {}, {}
    try:
        for name in names:
            out = library_path(name)
            if out.exists():
                done[name] = (out, "")
                continue
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
            running[name] = (out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        for name, (out, tmp, proc) in running.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc failed ({proc.returncode}):\n"
                              f"{log}")
                continue
            os.replace(tmp, out)   # atomic: concurrent builders never see half
            done[name] = (out, log)
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for _out, tmp, proc in running.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return done


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    with spans.span("kernels.load", library=name):
        path, _log = build([name])[name]
        lib = ctypes.CDLL(str(path))
    for fn_name, argtypes in SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t from a launch entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{err}")
