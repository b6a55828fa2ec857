"""The benchmark's plain reference: a frozen copy of pbrt_tpu_torch's
Python modules (version 0.1.0), cut to what the benchmark's cells reach,
with every query sent to its plain PyTorch version on whatever device its
tensors live on.

What differs from the package it was copied from:

- `ops/tri_intersect.py`, `ops/bvh8.py` and `ops/megawave.py` run their
  plain versions for CUDA tensors too. The kernel launch functions beside
  them are never reached; their build module and the `.cu` sources are
  not copied.
- Only what the cells' scenes use, and the scenes queued for the next
  cells, is copied: triangle meshes (text and PLY), the diffuse,
  conductor and dielectric materials, area-triangle, uniform and image
  infinite lights, the uniform and power light samplers and the
  position-aware ones (`lightsampler_bvh.py`, the light-BVH walk; the
  exhaustive sampler in `lightsamplers.py`), image textures, the path
  integrator. Instances, curves, bilinear patches, quadrics, sphere
  lights, media and the volumetric integrator are left out, and the
  parser refuses them.
- The program's spans (`spans.py`) are not copied: the reference times
  nothing.
- `utils.DATA_DIR` points at the same shared data tables (`pbrt_tpu/data`,
  read by path, as the program reads them).
- The host BVH builder (`csrc/host/*.cpp`, compiled with g++ by
  `native.py` at first use) builds into this copy's own `_build/`: the
  reference needs a BVH over killeroo's 163,842 triangles, and a build in
  Python would take minutes a run.
- The kernel-only modules (`ops/_build.py`, `ops/dma_probe.py`,
  `ops/bvh8_pages.py`) and `convert.py` are left out.

The benchmark renders the same scene text with the same sampler seed
through this copy and through the program, and compares the images
(portbench/checks.py). It imports nothing of the program, and the program
nothing of it; it is frozen so that no later change to the program can
move its own yardstick. What it shares with the program, pbrt-v4's own
renders (portbench/goldens/) check.
"""

__version__ = "0.1.0"
