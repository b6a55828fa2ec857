"""The yardstick of a kernel's roofline share: the published peaks, the
least time of a piece of work, and, in one module per kernel
(roofline/<kernel>.py), a frozen count of the work that kernel's launches
need, taken from the plain reference's own run over the same lanes.

A module per kernel holds KERNEL (the device function's name, as the
profiler's trace shows it) and counting() -> a context manager
that yields a Tally while the reference renders: the least seconds of
every launch the program made for the same image."""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import re

# NVIDIA H100 SXM data sheet, dense, at its full 700 W limit
PEAK_BYTES_PER_S = 3.35e12      # HBM3
PEAK_F32_PER_S = 67e12          # FP32 outside the tensor cores
# INT32: 64 lanes an SM against the FP32 pipe's 128 (Hopper white paper)
PEAK_INT32_PER_S = 33.5e12


def least_seconds(n_bytes, n_ops, n_int_ops=0) -> float:
    """The least time of the work on the card: its bytes, its f32
    operations or its INT32 operations (separate pipes) at their peak
    rates, whichever takes longest."""
    return max(n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_F32_PER_S,
               n_int_ops / PEAK_INT32_PER_S)


@dataclasses.dataclass
class Tally:
    launches: int = 0
    least_s: float = 0.0


@contextlib.contextmanager
def patched(module, name, after):
    """Call after(result, *args) behind every call of module.name."""
    fn = getattr(module, name)

    def counted(*a, **k):
        out = fn(*a, **k)
        after(out, *a)
        return out
    setattr(module, name, counted)
    try:
        yield
    finally:
        setattr(module, name, fn)


def kernel_module(kernel: str):
    return importlib.import_module(f"portbench.roofline.{kernel}")


def is_kernel(event_name: str, kernel: str) -> bool:
    """Whether a device event of the trace is a launch of `kernel`: its
    demangled name, without return type, namespaces, template arguments
    and parameters, is the function's name."""
    head = event_name.replace("(anonymous namespace)::", "")
    head = re.sub(r"^void\s+", "", head.split("(", 1)[0].strip())
    return head.split("<", 1)[0].rsplit("::", 1)[-1] == kernel


def share_pct(ctx, kernel: str):
    """100 x least time / device time of `kernel`'s launches in the traced
    image, or None where the trace holds none of them."""
    tally = ctx.rooflines.get(kernel) if ctx.rooflines else None
    if ctx.trace is None or tally is None or tally.launches == 0:
        return None
    name = kernel_module(kernel).KERNEL
    spans = [d for n, d in ctx.trace.kernel_durations if is_kernel(n, name)]
    if not spans:
        return None
    return 100.0 * tally.least_s / sum(spans)
