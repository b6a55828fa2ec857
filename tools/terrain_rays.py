#!/usr/bin/env python3
"""The million-triangle terrain and its rays, in numpy only.

`make_terrain(n)` is a sine-displaced heightfield over [0, 10]^2 with
2 (n - 1)^2 triangles (n = 708: 999,698); `gen_rays(V, kind, N)` gives N
rays of one kind: "raster", a pinhole camera's pixel grid looking down at
the terrain; "camera", one eye towards random points of the ground plane;
"bounce", origins on the surface with cosine-distributed upward
directions. The same arrays as the JAX package's tools/exp_1m.py
(`make_terrain`, `gen_rays`), for the port's big-mesh traversal
(chip_smoke.py phase 24) without importing that package.

    python3 tools/terrain_rays.py [n]    # prints the triangle count
"""
import sys

import numpy as np


def make_terrain(n=708):
    """(V (n*n, 3) float32, F (2 (n-1)^2, 3) int32)."""
    xs = np.linspace(0, 10, n)
    X, Z = np.meshgrid(xs, xs, indexing="ij")
    Y = (0.6 * np.sin(1.7 * X) * np.cos(1.3 * Z)
         + 0.25 * np.sin(4.1 * X + 1.0) * np.sin(3.7 * Z)
         + 0.08 * np.sin(11.0 * X) * np.cos(9.0 * Z))
    V = np.stack([X, Y, Z], -1).reshape(-1, 3).astype(np.float32)
    idx = np.arange(n * n).reshape(n, n)
    a = idx[:-1, :-1].reshape(-1)
    b = idx[1:, :-1].reshape(-1)
    c = idx[1:, 1:].reshape(-1)
    d = idx[:-1, 1:].reshape(-1)
    F = np.concatenate([np.stack([a, b, c], -1),
                        np.stack([a, c, d], -1)]).astype(np.int32)
    return V, F


def gen_rays(V, kind, N, seed=5):
    """(o, d) (N, 3) float32 rays of `kind` ("raster", "camera" or
    "bounce") over the terrain's vertices V."""
    rng = np.random.default_rng(seed)
    if kind == "raster":
        w = int(np.sqrt(N))
        eye = np.asarray([5.0, 7.0, -4.0], np.float32)
        look = np.asarray([5.0, 0.0, 5.0], np.float32)
        fwd = look - eye
        fwd /= np.linalg.norm(fwd)
        right = np.cross(fwd, [0, 1, 0]).astype(np.float32)
        right /= np.linalg.norm(right)
        up = np.cross(right, fwd)
        ys, xs = np.meshgrid(np.arange(w), np.arange(w), indexing="ij")
        u = (xs.reshape(-1)[:N] + 0.5) / w - 0.5
        v = (ys.reshape(-1)[:N] + 0.5) / w - 0.5
        d = fwd[None] + 1.2 * u[:, None] * right[None] \
            + 1.2 * v[:, None] * up[None]
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        return np.broadcast_to(eye, (N, 3)).copy(), d.astype(np.float32)
    if kind == "camera":
        eye = np.asarray([5.0, 6.0, -3.0], np.float32)
        tx = rng.uniform(0, 10, N)
        tz = rng.uniform(0, 10, N)
        tgt = np.stack([tx, np.zeros(N), tz], -1).astype(np.float32)
        d = tgt - eye
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        return np.broadcast_to(eye, (N, 3)).copy(), d.astype(np.float32)
    if kind != "bounce":
        raise ValueError(f"gen_rays: unknown kind {kind!r}")
    ids = rng.integers(0, len(V), N)
    p = V[ids] + np.asarray([0, 1e-3, 0], np.float32)
    u = rng.random((N, 2)).astype(np.float32)
    r = np.sqrt(u[:, 0])
    ph = 2 * np.pi * u[:, 1]
    d = np.stack([r * np.cos(ph),
                  np.sqrt(np.maximum(1 - u[:, 0], 0)),
                  r * np.sin(ph)], -1).astype(np.float32)
    return p.astype(np.float32), d


def terrain_triangles(n=708):
    """The terrain as the BVH builders take it: (lo, hi (T, 3) boxes,
    tri_geo (T, 10) rows [p0, p1, p2, id])."""
    V, F = make_terrain(n)
    p0, p1, p2 = V[F[:, 0]], V[F[:, 1]], V[F[:, 2]]
    lo = np.minimum(np.minimum(p0, p1), p2)
    hi = np.maximum(np.maximum(p0, p1), p2)
    tri = np.concatenate(
        [p0, p1, p2, np.arange(len(F), dtype=np.float32)[:, None]], 1)
    return lo, hi, tri


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 708
    print(f"terrain n={n}: {len(make_terrain(n)[1])} triangles")
