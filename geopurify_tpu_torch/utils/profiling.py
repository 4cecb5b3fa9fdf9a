"""Per-stage wall-clock timing.

Port of ``StageTimer`` of geopurify_tpu/utils/profiling.py (:20-61): named
stages accumulate seconds across steps; a stage given ``block_on`` (a
tensor or a device) synchronises its CUDA device before the clock stops,
as the JAX version blocks on its arrays.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Any, Dict, Iterator

import torch


# geopurify_tpu/utils/profiling.py:20
class StageTimer:
    """Accumulates wall time per named stage across steps."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, block_on: Any = None) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                dev = block_on.device if isinstance(block_on, torch.Tensor) else torch.device(block_on)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            self.observe(name, time.perf_counter() - t0)

    def observe(self, name: str, seconds: float) -> None:
        self.totals[name] += seconds
        self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"total_s": round(self.totals[k], 4), "count": self.counts[k],
                "mean_ms": round(1000 * self.totals[k] / max(self.counts[k], 1), 2)}
            for k in sorted(self.totals)
        }
