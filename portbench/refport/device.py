"""Explicit device handling.

The JAX package picks its backend globally (``jax.default_backend()``);
the port takes the device from the caller instead. Asking for ``cuda``
where there is no card raises: the port never carries on silently on the
CPU.
"""
from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    """Turn a device spec ("cpu", "cuda", "cuda:0", torch.device) into a
    torch.device, raising if it names CUDA and no card is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device!r}")
    if dev.type == "cuda" and dev.index is None:
        # "cuda" names torch's current card; make it comparable to the
        # device of a tensor allocated there
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for queued work on `device` (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
