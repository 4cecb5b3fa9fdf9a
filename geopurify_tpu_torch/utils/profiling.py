"""Per-stage wall-clock timing, device traces, and work counts.

Port of geopurify_tpu/utils/profiling.py: ``StageTimer``'s named
stages accumulate seconds across steps, with a summary, a printable report
and a JSONL record; a stage given ``block_on`` (a tensor or a device)
synchronises its CUDA device before the clock stops, as the JAX version
blocks on its arrays. ``trace(log_dir)`` records a ``torch.profiler``
trace (CPU and, on a card, CUDA activity) into ``log_dir`` for TensorBoard
or Perfetto, where JAX uses ``jax.profiler``; a no-op without a directory.

``compiled_costs`` counts the operations and bytes of one call, where JAX
reads XLA's cost analysis of the compiled call: the registered FLOP
formulas of ``torch.utils.flop_counter`` (matmuls, convolutions,
attention) and the bytes of every operation's tensor inputs and outputs.
The hand-written kernels count their function's work through
``hand_kernel`` whichever route runs, so a count is the same on the CPU and
on the card. ``mfu_table`` sets achieved rates against the H100's peaks.
"""

from __future__ import annotations

import contextlib
import functools
import json
import logging
import time
from collections import defaultdict
from typing import Any, Dict, Iterator, Optional

import torch

log = logging.getLogger("geopurify.profiling")


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


# ---------------------------------------------------------------------------
# Per-stage achieved FLOP/s and bandwidth (geopurify_tpu/utils/profiling.py:83-137)
# ---------------------------------------------------------------------------

# One NVIDIA H100 SXM5 80GB HBM3 at its 700 W limit, from NVIDIA's data
# sheet: the dense bf16 tensor-core rate and the HBM3 rate (the figures of
# chip_smoke.py's kernel bounds). A card set to a lower power limit runs
# below them.
H100_PEAK_TFLOPS_BF16 = 989.0
H100_PEAK_HBM_GBPS = 3350.0

# operations that only allocate: they move no bytes
_ALLOCATIONS = ("empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided")


@functools.lru_cache(maxsize=None)
def _note(message: str) -> None:
    log.warning(message)


def _moves_no_bytes(func) -> bool:
    """A view or alias (its result shares its input's storage), or an
    allocation."""
    name = func._overloadpacket.__name__
    if name == "_unsafe_view" or name in _ALLOCATIONS:
        return True
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


@functools.lru_cache(maxsize=None)
def _counter_class():
    """The dispatch mode that counts, built on first use (raises
    ImportError where this torch has no operation counter)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves
    from torch.utils.flop_counter import flop_registry

    class _WorkCounter(TorchDispatchMode):
        """Sums, over the aten operations dispatched while it is on, the
        FLOPs of those with a registered formula and the bytes of every
        tensor each reads and writes (views count 0); nothing while a hand
        kernel's wrapper runs, which counts its own work."""

        def __init__(self):
            super().__init__()
            self.flops = 0.0
            self.bytes = 0.0
            self.hand = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if self.hand:
                return func(*args, **kwargs)
            formula = flop_registry.get(func._overloadpacket)
            if formula is None and func is not torch.ops.prim.device.default:
                # a composite operation (linear, conv2d, matmul, einsum: not
                # taken apart before this mode under inference_mode) counts
                # as the operations it is made of, as FlopCounterMode does
                with self:
                    out = func.decompose(*args, **kwargs)
                if out is not NotImplemented:
                    return out
            out = func(*args, **kwargs)
            if formula is not None:
                self.flops += formula(*args, **kwargs, out_val=out)
            if not _moves_no_bytes(func):
                self.bytes += sum(t.numel() * t.element_size()
                                  for t in tree_leaves((args, kwargs, out))
                                  if isinstance(t, torch.Tensor))
            return out

    return _WorkCounter


@contextlib.contextmanager
def hand_kernel(flops: float, bytes_: float) -> Iterator[None]:
    """Around a hand-written kernel's wrapper: adds the kernel's work (its
    operations, each input read once and each output written once) to every
    active ``compiled_costs`` counter, and hides from them the operations
    the wrapper dispatches meanwhile (the plain version's on the CPU, the
    launch's padding and copies on the card)."""
    counters = []
    if torch._C._len_torch_dispatch_stack():
        from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

        cls = _counter_class()
        counters = [m for m in _get_current_dispatch_mode_stack() if isinstance(m, cls)]
    for c in counters:
        c.flops += flops
        c.bytes += bytes_
        c.hand += 1
    try:
        yield
    finally:
        for c in counters:
            c.hand -= 1


# geopurify_tpu/utils/profiling.py:92
def compiled_costs(fn, *args, **kwargs) -> Optional[Dict[str, float]]:
    """(flops, bytes) of one call ``fn(*args, **kwargs)``, which runs once.

    flops: ``torch.utils.flop_counter``'s formulas (mm, bmm, addmm,
    baddbmm, convolution, attention; 2 per multiply-add, padded taps
    included); bytes: each aten operation's tensor inputs and outputs, the
    traffic of one kernel per operation, as XLA's "bytes accessed" counts
    an unfused HLO. The hand kernels count their kernel's work
    (``hand_kernel``). Returns None, logging why once, where this torch has
    no operation counter; an error of ``fn`` raises."""
    try:
        counter = _counter_class()()
    except ImportError as e:
        _note(f"compiled_costs: no operation counter in torch {torch.__version__}: {e!r}")
        return None
    with counter:
        fn(*args, **kwargs)
    return {"flops": float(counter.flops), "bytes": float(counter.bytes)}


# geopurify_tpu/utils/profiling.py:112
def mfu_table(
    rows,                       # [(stage, wall_s, costs_or_None, n_calls)]
    peak_tflops: float = H100_PEAK_TFLOPS_BF16,
    peak_gbps: float = H100_PEAK_HBM_GBPS,
) -> str:
    """Render per-stage achieved TFLOP/s and GB/s vs the card's peaks.

    ``costs`` is one call's {flops, bytes} (``compiled_costs``); multiplied
    by n_calls and divided by the measured wall. The bytes are the traffic
    of one kernel per aten operation: a kernel that keeps data in cache or
    registers moves less, so treat the bandwidth column as an estimate."""
    lines = [
        f"{'stage':18s} {'wall_s':>8s} {'TFLOP/s':>9s} {'%peak':>6s} "
        f"{'GB/s':>8s} {'%BW':>6s}"
    ]
    for stage, wall, costs, n in rows:
        if costs is None or wall <= 0:
            lines.append(f"{stage:18s} {wall:8.3f} {'n/a':>9s} {'':>6s} {'':>8s}")
            continue
        tflops = costs["flops"] * n / wall / 1e12
        gbps = costs["bytes"] * n / wall / 1e9
        lines.append(
            f"{stage:18s} {wall:8.3f} {tflops:9.2f} {100*tflops/peak_tflops:5.1f}% "
            f"{gbps:8.1f} {100*gbps/peak_gbps:5.1f}%"
        )
    return "\n".join(lines)
