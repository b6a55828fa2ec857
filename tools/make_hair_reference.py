#!/usr/bin/env python3
"""Render the "hair-ref" gate image with the JAX package on the CPU.

    python3 tools/make_hair_reference.py [OUT.exr]

The scene is tools/hair_scene.py's `hair_scene_text(512, seed=1, 128, 128,
spp=16)`: 4,096 curve spans, 32,768 sub-segments. It goes through the JAX
package's own entry points, `pbrt_tpu.scene.parser.parse_string` ->
`pbrt_tpu.integrators.render.render` (PathOptions(max_depth=5)), on the
CPU, where every curve query runs the XLA traversal
`ops/curves.bvh_intersect_curves`, the reference of the TPU curve kernel.
The image, written by default to tests/data/torch_hair_ref_128_16spp.exr,
is what chip_smoke.py holds the PyTorch port's render of the same scene
to (MRSE and mean ratio gates). This tool is no part of the port and may
import JAX.

On an 8-core x86 CPU it took 131 s: parse and build 3.3 s, render 128.0 s
with XLA's compiles.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from hair_scene import hair_scene_text  # noqa: E402

N_STRANDS, SEED, SIZE, SPP = 512, 1, 128, 16
OUT = ROOT / "tests" / "data" / f"torch_hair_ref_{SIZE}_{SPP}spp.exr"


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    out = Path(argv[0]) if argv else OUT
    import numpy as np
    from pbrt_tpu.integrators import render as rdr
    from pbrt_tpu.integrators.path import PathOptions
    from pbrt_tpu.scene import parser
    from pbrt_tpu.utils import image
    t0 = time.perf_counter()
    desc = parser.parse_string(hair_scene_text(N_STRANDS, SEED, SIZE, SIZE,
                                               SPP))
    t1 = time.perf_counter()
    img, _stats = rdr.render(desc.scene, desc.camera, spp=SPP,
                             sampler=desc.sampler,
                             opts=PathOptions(max_depth=5))
    img = np.asarray(img)
    t2 = time.perf_counter()
    if img.shape != (SIZE, SIZE, 3) or not np.isfinite(img).all():
        raise RuntimeError("hair reference render: bad image")
    image.write_exr(out, img)
    print(f"{out}: parse and build {t1 - t0:.1f} s, render {t2 - t1:.1f} s, "
          f"mean {float(img.mean()):.6g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
