"""Kernels and their plain PyTorch versions (counterpart of
pbrt_tpu/ops/). Each wrapper runs its plain version for CPU tensors and
its CUDA kernel for CUDA tensors; there is no fallback between the two."""


class LaunchCounter:
    """Plain counters of one wrapper: kernel launches, and runs of the plain
    version (a run shows a path went through the kernel or not)."""

    def __init__(self):
        self.launches = 0
        self.plain = 0
