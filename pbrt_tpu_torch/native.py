"""The host BVH builders in C++ (counterpart of pbrt_tpu/native/__init__.py):
the binned-SAH binary build, its collapse into 8-wide nodes (whole or from
a subtree root) and the subtree primitive ranges.

The sources are the port's copies of the JAX package's own
(csrc/host/bvh_builder.cpp and bvh8_collapse.cpp, held byte for byte to
pbrt_tpu/native/ by the tests), compiled with g++ at first use into
pbrt_tpu_torch/_build/ with the reference's flags, so both packages build
bit-identical trees. The library is named by a hash of the sources, the
flags and the host CPU's features (-march=native ties it to them). There
is no Python fallback: if g++ is missing or the build fails, the builder
raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from . import spans

PKG = Path(__file__).resolve().parent
BUILD_DIR = PKG / "_build"
NATIVE_DIR = PKG / "csrc" / "host"
SOURCES = ("bvh_builder.cpp", "bvh8_collapse.cpp")
# the reference's flags (pbrt_tpu/native/__init__.py): the same code
# generation, so a tie in the SAH costs breaks the same way in both builds
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]

_FP = ctypes.POINTER(ctypes.c_float)
_IP = ctypes.POINTER(ctypes.c_int)
_LP = ctypes.POINTER(ctypes.c_long)
SIGNATURES = {
    # lo, hi, n, max_leaf, nodes_out, order_out, n_nodes_out
    "build_bvh": [_FP, _FP, ctypes.c_int, ctypes.c_int, _FP, _IP, _IP],
    # nodes_bin, m, max_leaf, root, prim_base, out, cap, n_out, depth_out
    "collapse_bvh8": [_FP, ctypes.c_long, ctypes.c_int, ctypes.c_long,
                      ctypes.c_long, _FP, ctypes.c_long, _LP, _IP],
    # nodes_bin, m, start_out, count_out
    "bvh_subtree_ranges": [_FP, ctypes.c_long, _LP, _LP],
}


def _host_cpu() -> str:
    """The host CPU's feature flags: -march=native ties the library to
    them."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(_host_cpu().encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((NATIVE_DIR / name).read_bytes())
    return BUILD_DIR / f"libpbrt_native_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, str]:
    """Compile the library if it is not built yet. Returns (path, the
    compiler's output); raises if g++ is missing or fails."""
    out = library_path()
    if out.exists():
        return out, ""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the host BVH builder is compiled "
                           "from pbrt_tpu_torch/csrc/host/*.cpp at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [gxx, *GXX_FLAGS, "-o", tmp,
           *[str(NATIVE_DIR / name) for name in SOURCES]]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)   # atomic: concurrent builders never see half
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    with spans.span("native.load"):
        path, _log = build()
        lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = None if name == "bvh_subtree_ranges" else ctypes.c_int
    return lib


def build_bvh(prim_lo, prim_hi, max_leaf: int = 4):
    """Binned SAH build over primitive boxes (P, 3). Returns (nodes (M, 8)
    float32 in the depth-first layout of ops/bvh.py, order (P,) int32)."""
    lo = np.ascontiguousarray(prim_lo, np.float32)
    hi = np.ascontiguousarray(prim_hi, np.float32)
    n = lo.shape[0]
    if n == 0 or lo.shape != (n, 3) or hi.shape != (n, 3):
        raise ValueError("build_bvh: prim_lo and prim_hi must be (P > 0, 3)")
    nodes = np.zeros((2 * n + 2, 8), np.float32)
    order = np.zeros(n, np.int32)
    n_nodes = ctypes.c_int(0)
    rc = load_library().build_bvh(
        lo.ctypes.data_as(_FP), hi.ctypes.data_as(_FP), n, int(max_leaf),
        nodes.ctypes.data_as(_FP), order.ctypes.data_as(_IP),
        ctypes.byref(n_nodes))
    if rc != 0:
        raise RuntimeError(f"build_bvh failed with code {rc}")
    return nodes[:n_nodes.value].copy(), order


def collapse_bvh8(nodes_bin, max_leaf: int = 8, root: int = 0,
                  prim_base: int = 0):
    """Collapse a flattened binary BVH (M, 8) into 8-wide nodes from binary
    node `root`; leaf starts are given relative to `prim_base` (a
    subtree's first primitive, for chunk-local indices). Returns
    (node_data (n, 72) float32, depth)."""
    nb = np.ascontiguousarray(nodes_bin, np.float32)
    m = nb.shape[0]
    cap = m + 1     # a collapse never has more nodes than its input
    out = np.zeros((cap, 72), np.float32)
    n_out = ctypes.c_long(0)
    depth = ctypes.c_int(0)
    rc = load_library().collapse_bvh8(
        nb.ctypes.data_as(_FP), m, int(max_leaf), int(root), int(prim_base),
        out.ctypes.data_as(_FP), cap, ctypes.byref(n_out), ctypes.byref(depth))
    if rc != 0:
        raise RuntimeError(f"collapse_bvh8 failed with code {rc}")
    return out[:n_out.value].copy(), depth.value


def subtree_ranges(nodes_bin):
    """(start, count) int64 (M,): the first primitive and the primitive
    count of every node's subtree in a flattened binary BVH (M, 8)."""
    nb = np.ascontiguousarray(nodes_bin, np.float32)
    m = nb.shape[0]
    start = np.zeros(m, np.int64)
    count = np.zeros(m, np.int64)
    load_library().bvh_subtree_ranges(
        nb.ctypes.data_as(_FP), m, start.ctypes.data_as(_LP),
        count.ctypes.data_as(_LP))
    return start, count
