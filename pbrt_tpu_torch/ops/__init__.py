"""Kernels and their plain PyTorch versions (counterpart of
pbrt_tpu/ops/). Each wrapper runs its plain version for CPU tensors and
its CUDA kernel for CUDA tensors; there is no fallback between the two."""
from .. import spans


class LaunchCounter:
    """Counters of one wrapper, kept among the spans' counters as
    launches.<kernel> and plain.<kernel>: kernel launches, and runs of the
    plain version (a run shows a path went through the kernel or not).
    work: what the last run of the plain version counted where its work
    depends on the data (node visits, triangle tests), for the kernel's
    bound."""

    def __init__(self, kernel: str):
        self._launches = f"launches.{kernel}"
        self._plain = f"plain.{kernel}"
        spans.set_counter(self._launches, 0)
        spans.set_counter(self._plain, 0)
        self.work = {}

    @property
    def launches(self) -> int:
        return spans.counter(self._launches)

    @launches.setter
    def launches(self, value: int):
        spans.set_counter(self._launches, value)

    @property
    def plain(self) -> int:
        return spans.counter(self._plain)

    @plain.setter
    def plain(self, value: int):
        spans.set_counter(self._plain, value)
