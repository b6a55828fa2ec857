"""Build and load the CUDA kernels of csrc/.

All `.cu` files compile with nvcc into one shared library with a plain C
interface, loaded with ctypes (no PyTorch headers, so a build takes
seconds). The library is built at first use into pbrt_tpu_torch/_build/,
named by a hash of the sources and flags, so an edited source rebuilds and
an unchanged one is reused.

Flags: sm_90a (Hopper), -O3, and -fmad=false, so that every multiply and
add rounds on its own the way the plain PyTorch versions' separate ops do
(the triangle test's edge tolerance and the path's hit and Russian-roulette
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

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
SIGNATURES = {
    # tri, o, d, t_max, t, prim, b1, b2, n, n_tris, n_real, any_hit, stream
    "tri_intersect_launch": [_P] * 8 + [_I] * 4 + [_P],
    # cam, tri, attr, light, mat, seeds, sobol01, mi, lam, le, L, fw,
    # n, n_tris, n_real, n_mats, n_lights, n_dims, max_depth, rr_start,
    # B, log2_spp, ls_uniform, 9 filter constants, stream
    "megawave_launch": [_P] * 12 + [_I] * 11 + [_F] * 9 + [_P],
}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card")


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in _sources():
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libpbrt_tpu_torch_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, str]:
    """Compile the library if it is not built yet. Returns (path, the
    compiler's output: ptxas register and spill counts)."""
    out = library_path()
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *[str(f) for f in sorted(CSRC.glob("*.cu"))]]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)   # atomic: concurrent builders never see half
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    path, _log = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t from a launch entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{err}")
