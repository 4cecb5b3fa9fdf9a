"""Per-stage wall-clock timing and device traces.

Port of geopurify_tpu/utils/profiling.py (:20-90): ``StageTimer``'s named
stages accumulate seconds across steps, with a summary, a printable report
and a JSONL record; a stage given ``block_on`` (a tensor or a device)
synchronises its CUDA device before the clock stops, as the JAX version
blocks on its arrays. ``trace(log_dir)`` records a ``torch.profiler``
trace (CPU and, on a card, CUDA activity) into ``log_dir`` for TensorBoard
or Perfetto, where JAX uses ``jax.profiler``; a no-op without a directory.
The JAX module's XLA cost accounting (``compiled_costs`` / ``mfu_table``)
serves its bench and is not ported.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from typing import Any, Dict, Iterator, Optional

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

    # geopurify_tpu/utils/profiling.py:55
    def report(self) -> str:
        lines = ["stage timing:"]
        for k, v in self.summary().items():
            lines.append(
                f"  {k:<28s} {v['total_s']:>9.2f}s total  {v['mean_ms']:>9.1f}ms/call  x{v['count']}"
            )
        return "\n".join(lines)

    # geopurify_tpu/utils/profiling.py:63
    def dump_jsonl(self, path: str, **extra) -> None:
        with open(path, "a") as f:
            f.write(json.dumps({"stages": self.summary(), **extra}) + "\n")


# geopurify_tpu/utils/profiling.py:68
@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """A ``torch.profiler`` trace of the block, written to ``log_dir`` as a
    Chrome / TensorBoard trace; no-op when ``log_dir`` is None or empty."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
