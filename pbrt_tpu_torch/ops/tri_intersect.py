"""Brute-force ray-triangle intersection (counterpart of
pbrt_tpu/ops/pallas_intersect.py).

Rays are tested against the whole triangle pool with Moeller-Trumbore and
a relative barycentric tolerance of 1e-6 * det, t > 1e-6, padding rows
masked by index. Closest hit: smallest t, ties to the lower pool index.
Any hit: the pool is scanned in groups of four (the reference kernel's
unroll), and the scan stops after the first group with a hit, returning
that group's closest hit — so both versions report the same triangle.

`tri_intersect` is the wrapper: CPU tensors run `tri_intersect_plain`;
CUDA tensors launch the kernel of csrc/tri_intersect.cu, or raise. The
kernel streams the pool through shared memory in tiles, so a pool of any
size launches.
The megakernel runs the same test from csrc/tri_intersect.cuh.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import spans
from . import LaunchCounter

GROUP = 4     # triangles per any-hit group; the pool is padded to it
T_MIN = 1e-6
REL_TOL = 1e-6


counter = LaunchCounter("tri")


def pad_triangles(tri_verts) -> np.ndarray:
    """(T, 9) [p0, p1, p2] -> (T'*16,) float32 rows [p0, e1, e2, pad] with
    the edges precomputed in float32 and T' = T rounded up to GROUP
    (reference pallas_intersect.pad_triangles)."""
    t = np.asarray(tri_verts, np.float32)
    n = -(-t.shape[0] // GROUP) * GROUP
    out = np.zeros((n, 16), np.float32)
    out[:t.shape[0], 0:3] = t[:, 0:3]
    out[:t.shape[0], 3:6] = t[:, 3:6] - t[:, 0:3]
    out[:t.shape[0], 6:9] = t[:, 6:9] - t[:, 0:3]
    return out.reshape(-1)


def tri_intersect_plain(tri, o, d, t_max, n_real: int, any_hit: bool):
    """Plain PyTorch version. tri (T*16,); o, d (N, 3); t_max (N,).
    Returns (t (N,) = t_max on a miss, prim (N,) int32 = -1 on a miss,
    b1 (N,), b2 (N,) = 0 on a miss)."""
    counter.plain += 1
    rows = tri.reshape(-1, 16)
    T = rows.shape[0]
    p0x, p0y, p0z = rows[:, 0], rows[:, 1], rows[:, 2]
    e1x, e1y, e1z = rows[:, 3], rows[:, 4], rows[:, 5]
    e2x, e2y, e2z = rows[:, 6], rows[:, 7], rows[:, 8]
    # (N, 1) ray columns against (T,) triangle rows
    o_x, o_y, o_z = (o[:, c:c + 1] for c in range(3))
    d_x, d_y, d_z = (d[:, c:c + 1] for c in range(3))
    pvx = d_y * e2z - d_z * e2y
    pvy = d_z * e2x - d_x * e2z
    pvz = d_x * e2y - d_y * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    sgn = torch.where(det < 0.0, -1.0, 1.0)
    det_a = det * sgn
    tx = o_x - p0x
    ty = o_y - p0y
    tz = o_z - p0z
    u_n = (tx * pvx + ty * pvy + tz * pvz) * sgn
    qvx = ty * e1z - tz * e1y
    qvy = tz * e1x - tx * e1z
    qvz = tx * e1y - ty * e1x
    v_n = (d_x * qvx + d_y * qvy + d_z * qvz) * sgn
    t_n = (e2x * qvx + e2y * qvy + e2z * qvz) * sgn
    tol = REL_TOL * det_a
    inv_det = 1.0 / torch.where(det_a == 0.0, 1.0, det_a)
    t = t_n * inv_det
    real = torch.arange(T, device=tri.device) < n_real
    valid = ((det_a > 1e-12) & (u_n >= -tol) & (v_n >= -tol)
             & (u_n + v_n <= det_a + tol) & (t > T_MIN)
             & (t < t_max[:, None]) & real)
    if any_hit:
        # keep only the first group of GROUP triangles that holds a hit
        g_hit = valid.reshape(-1, T // GROUP, GROUP).any(dim=-1)
        first = torch.argmax(g_hit.to(torch.int8), dim=1)
        group = torch.arange(T, device=tri.device) // GROUP
        valid = valid & (group[None, :] == first[:, None])
    t_masked = torch.where(valid, t, torch.inf)
    k = torch.argmin(t_masked, dim=1, keepdim=True)   # first minimum
    hit = valid.any(dim=1)
    prim = torch.where(hit, k[:, 0], -1).to(torch.int32)
    t_out = torch.where(hit, torch.gather(t, 1, k)[:, 0], t_max)
    b1 = torch.where(hit, torch.gather(u_n * inv_det, 1, k)[:, 0], 0.0)
    b2 = torch.where(hit, torch.gather(v_n * inv_det, 1, k)[:, 0], 0.0)
    return t_out, prim, b1, b2


def tri_intersect(tri, o, d, t_max, n_real: int, any_hit: bool = False):
    """Closest (or any) hit of N rays against the whole pool; see
    tri_intersect_plain for shapes and results."""
    N = o.shape[0]
    if not (o.shape == d.shape == (N, 3) and t_max.shape == (N,)):
        raise ValueError("tri_intersect: o, d must be (N, 3), t_max (N,)")
    if tri.numel() % (16 * GROUP) or n_real > tri.numel() // 16:
        raise ValueError("tri_intersect: pool must be pad_triangles rows")
    devices = {x.device.type for x in (tri, o, d, t_max)}
    if devices == {"cpu"}:
        with spans.span("tri.kernel"):
            return tri_intersect_plain(tri, o, d, t_max, n_real, any_hit)
    if devices != {"cuda"}:
        raise ValueError(f"tri_intersect: tensors on mixed devices {devices}")
    return _launch(tri, o, d, t_max, n_real, any_hit)


def _launch(tri, o, d, t_max, n_real, any_hit, out=None):
    """out: (t, prim, b1, b2) to write into (a timing loop's, allocated
    once); allocated here when None."""
    import ctypes
    from . import _build
    for x in (tri, o, d, t_max):
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError("tri_intersect: float32 contiguous tensors only")
    if tri.data_ptr() % 16:
        raise ValueError("tri_intersect: the pool must be 16-byte aligned")
    lib = _build.load_library("tri_intersect")
    N = o.shape[0]
    if out is None:
        t = torch.empty((N,), dtype=torch.float32, device=o.device)
        prim = torch.empty((N,), dtype=torch.int32, device=o.device)
        out = (t, prim, torch.empty_like(t), torch.empty_like(t))
    t, prim, b1, b2 = out
    if N == 0:
        return t, prim, b1, b2
    with torch.cuda.device(o.device), spans.span("tri.kernel"):
        err = lib.tri_intersect_launch(
            tri.data_ptr(), o.data_ptr(), d.data_ptr(), t_max.data_ptr(),
            t.data_ptr(), prim.data_ptr(), b1.data_ptr(), b2.data_ptr(),
            N, tri.numel() // 16, n_real, int(any_hit),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    _build.check(err, "tri_intersect")
    counter.launches += 1
    return t, prim, b1, b2
