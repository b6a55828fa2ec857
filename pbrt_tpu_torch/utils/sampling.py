"""Host-side sampling tables (counterpart of pbrt_tpu/utils/sampling.py):
the alias table behind the power light sampler."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class AliasTable:
    q: np.ndarray       # (n,) float32 acceptance thresholds
    alias: np.ndarray   # (n,) int32
    pmf: np.ndarray     # (n,) float32

    @staticmethod
    def build(weights) -> "AliasTable":
        """Vose's alias construction in float64, the reference's pop order."""
        w = np.asarray(weights, np.float64)
        n = len(w)
        total = w.sum()
        if total == 0:
            w = np.ones(n)
            total = n
        pmf = w / total
        scaled = pmf * n
        q = np.ones(n)
        alias = np.arange(n)
        small = [i for i in range(n) if scaled[i] < 1.0]
        large = [i for i in range(n) if scaled[i] >= 1.0]
        while small and large:
            s = small.pop()
            big = large.pop()
            q[s] = scaled[s]
            alias[s] = big
            scaled[big] = (scaled[big] + scaled[s]) - 1.0
            (small if scaled[big] < 1.0 else large).append(big)
        return AliasTable(q=q.astype(np.float32), alias=alias.astype(np.int32),
                          pmf=pmf.astype(np.float32))
