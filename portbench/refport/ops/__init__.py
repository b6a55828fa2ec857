"""Kernels and their plain PyTorch versions (counterpart of
pbrt_tpu/ops/). Each wrapper runs its plain version for CPU tensors and
its CUDA kernel for CUDA tensors; there is no fallback between the two."""


class LaunchCounter:
    """Plain counters of one wrapper: kernel launches, and runs of the plain
    version (a run shows a path went through the kernel or not). work: what
    the last run of the plain version counted where its work depends on the
    data (node visits, triangle tests), for the kernel's bound."""

    def __init__(self):
        self.launches = 0
        self.plain = 0
        self.work = {}
