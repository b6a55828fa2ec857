"""pbrt_tpu_torch — the PyTorch + CUDA port of the pbrt_tpu path tracer.

The JAX package ``pbrt_tpu`` is the reference; this package mirrors its
module names (``samplers.py``, ``film.py``, ``ops/megawave.py``, ...) so
each module's counterpart is easy to find, and every module docstring names
it. Conventions:

- Plain PyTorch on explicit devices: every entry point that creates
  tensors takes a ``device`` argument; nothing picks a device on its own,
  and asking for ``cuda`` without a card raises (``device.py``).
- Host-side scene construction is numpy (float64 where the reference is);
  device state is tensors in small dataclasses.
- The TPU kernels become hand-written CUDA C++ for Hopper (``csrc/``), each
  beside a plain PyTorch version of the same function in its wrapper's
  module. A wrapper runs the plain version only for CPU tensors; for CUDA
  tensors it launches the kernel or raises.
- 32-bit unsigned integer math (hashes, Sobol', Owen scrambling, morton
  codes) runs in int64 tensors masked to 32 bits, because torch's uint32
  lacks shifts, adds and comparisons on the CPU.

This package imports no module of the JAX package (nor ``jax`` or
``flax``): it reads the shared data tables under ``pbrt_tpu/data`` by
path, and carries its own copies of the C++ BVH builders
(``csrc/host/``) and its own EXR codec (``utils/image.py``).
"""

__version__ = "0.1.0"
