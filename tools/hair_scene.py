#!/usr/bin/env python3
"""Generate the "hair" scene: a seeded fur patch of cubic Bezier curves.

    python3 tools/hair_scene.py N_STRANDS SEED WIDTH HEIGHT SPP OUT.pbrt

`hair_scene_text(n_strands, seed, width, height, spp)` returns the scene as
.pbrt text:

- n_strands strands, their roots uniform on [-1, 1]^2 at y = 0; each a
  drooping, curling polyline of 9 points, 0.5-0.9 long, turned into 8 C1
  cubic Bezier spans by the Catmull-Rom rule of pbrt's cyhair2pbrt
  (interior tangents (p[i+1] - p[i-1]) / 6, one-sided at the ends); each
  span one `Shape "curve"` line of type cylinder, as cyhair2pbrt writes it,
  its width lerped from 0.008 at the root to 0.002 at the tip;
- `Material "hair"` with the parser's defaults;
- a 6x6 diffuse ground quad at y = 0, a 2x2 area light quad overhead
  facing down, a constant uniform infinite light;
- a perspective camera, the zsobol sampler, `Integrator "path"` at max
  depth 5.

Only numpy: the tool imports neither torch nor the renderers, so both
packages parse the same text. A real cyhair model converted by
cyhair2pbrt can take the strands' place.
"""
from __future__ import annotations

import sys

import numpy as np

POINTS = 9              # per strand, so 8 Bezier spans
ROOT_WIDTH = 0.008
TIP_WIDTH = 0.002


def strand_points(n_strands: int, seed: int) -> np.ndarray:
    """(n, 9, 3) float64 polyline points of the seeded strands."""
    rng = np.random.default_rng(seed)
    roots = rng.uniform(-1.0, 1.0, (n_strands, 2))
    length = rng.uniform(0.5, 0.9, n_strands)
    theta0 = rng.uniform(0.05, 0.45, n_strands)    # lean from the vertical
    droop = rng.uniform(0.3, 1.1, n_strands)       # further lean to the tip
    phi0 = rng.uniform(0.0, 2.0 * np.pi, n_strands)
    curl = rng.uniform(-2.0, 2.0, n_strands)       # azimuth turn to the tip
    k = np.arange(POINTS - 1) / (POINTS - 2)
    theta = theta0[:, None] + droop[:, None] * k
    phi = phi0[:, None] + curl[:, None] * k
    step = (length / (POINTS - 1))[:, None, None]
    dirs = np.stack([np.sin(theta) * np.cos(phi), np.cos(theta),
                     np.sin(theta) * np.sin(phi)], axis=-1)
    pts = np.zeros((n_strands, POINTS, 3))
    pts[:, 0, 0] = roots[:, 0]
    pts[:, 0, 2] = roots[:, 1]
    pts[:, 1:] = pts[:, :1] + np.cumsum(step * dirs, axis=1)
    return pts


def catmull_rom_beziers(pts: np.ndarray) -> np.ndarray:
    """(n, P, 3) polylines (P >= 3) -> (n, P - 1, 4, 3) cubic Bezier spans,
    C1 across the joints: tangents (p[i+1] - p[i-1]) / 6 inside, one-sided
    differences at the two ends."""
    tan = np.empty_like(pts)
    tan[:, 1:-1] = (pts[:, 2:] - pts[:, :-2]) / 6.0
    tan[:, 0] = (-3 * pts[:, 0] + 4 * pts[:, 1] - pts[:, 2]) / 6.0
    tan[:, -1] = (3 * pts[:, -1] - 4 * pts[:, -2] + pts[:, -3]) / 6.0
    p0, p1 = pts[:, :-1], pts[:, 1:]
    return np.stack([p0, p0 + tan[:, :-1], p1 - tan[:, 1:], p1], axis=2)


def hair_scene_text(n_strands: int, seed: int, width: int, height: int,
                    spp: int) -> str:
    spans = catmull_rom_beziers(strand_points(n_strands, seed))
    n_spans = spans.shape[1]
    w = ROOT_WIDTH + (TIP_WIDTH - ROOT_WIDTH) * np.arange(n_spans + 1) \
        / n_spans
    head = f"""\
# GENERATED by tools/hair_scene.py ({n_strands} strands, seed {seed})
LookAt 0 1.5 3.2   0 0.3 0   0 1 0
Camera "perspective" "float fov" [40]
Film "rgb" "integer xresolution" [{width}] "integer yresolution" [{height}]
    "string filename" "hair.exr"
Sampler "zsobol" "integer pixelsamples" [{spp}]
Integrator "path" "integer maxdepth" [5]

WorldBegin
LightSource "infinite" "spectrum L" [ 360 0.25 830 0.25 ]
Material "diffuse" "rgb reflectance" [0.45 0.42 0.38]
Shape "trianglemesh" "integer indices" [ 0 1 2 0 2 3 ]
    "point3 P" [ -3 0 -3   -3 0 3   3 0 3   3 0 -3 ]
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [ 5 5 5 ]
  Shape "trianglemesh" "integer indices" [ 0 1 2 0 2 3 ]
      "point3 P" [ -1 2.5 -1   1 2.5 -1   1 2.5 1   -1 2.5 1 ]
AttributeEnd
Material "hair"
"""
    lines = [head]
    for strand in spans:
        for i, q in enumerate(strand):
            pts = " ".join(f"{v:f}" for v in q.reshape(-1))
            lines.append(f'Shape "curve" "string type" [ "cylinder" ] '
                         f'"point3 P" [ {pts} ] '
                         f'"float width0" [ {w[i]:f} ] '
                         f'"float width1" [ {w[i + 1]:f} ]\n')
    return "".join(lines)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 6:
        print(__doc__.strip().splitlines()[2], file=sys.stderr)
        return 1
    n, seed, width, height, spp = (int(a) for a in argv[:5])
    with open(argv[5], "w") as f:
        f.write(hair_scene_text(n, seed, width, height, spp))
    return 0


if __name__ == "__main__":
    sys.exit(main())
