"""Spans and counters, per-stage timing, and work counts.

One recorder of spans and counters serves the port. ``span(name)`` times
a block: its name, its path from the root (``scene/pool_classify/graph``),
its parent, the item it belongs to (the scene or step that a root span
opened with ``item=True`` numbers), the host clock at both ends
(``time.perf_counter_ns``) and, on a card, a CUDA event recorded on the
current stream at both ends, taken from a pool: no synchronize, no host
read. ``count(name, n)`` adds to a counter of the current item. The hot
paths make each of their device-to-host reads through ``host_read(x)``,
``nonzero(x)`` or ``masked(x, mask)``, which count ``host_syncs``.

``recording(device)`` is the one switch: inside it, spans and counters go
to ``RECORDER`` (``evaluate_scene(profile=True)`` opens it for its scene,
the Stage-1 trainer for its steps). When the outermost block exits, or
when ``Recorder.items`` is read, the recorder synchronizes once, resolves
the closed spans' device intervals (``elapsed_time`` against its reference
event) and folds each finished item into a summary kept in a bounded
history; closed spans and counters of no item are dropped then. Off,
``span`` returns one shared null context and ``count`` returns at once: a
global load and a branch, no event, no allocation.

Port of geopurify_tpu/utils/profiling.py: ``StageTimer``'s named
stages accumulate seconds across steps, with a summary, a printable report
and a JSONL record. Here each stage is a span of the timer's own recorder:
a stage given ``block_on`` (a tensor or a device) on a card takes its
span's device interval, where the JAX version blocks on its arrays, and
the intervals are resolved when a summary is taken.

The hand kernels' wrappers register here (``counts_launches``): each
one's ``launches`` attribute counts its launches, and ``launch_counts``
reads them all.

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
from collections import defaultdict, deque
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch

log = logging.getLogger("geopurify.profiling")

# the wrappers of the hand kernels, by name (``counts_launches``)
_LAUNCH_COUNTED: Dict[str, Callable] = {}

HISTORY = 1024      # finished items a recorder keeps, newest last


def counts_launches(fn: Callable) -> Callable:
    """Registers a hand kernel's wrapper, whose ``launches`` attribute (set
    to 0 here) the wrapper adds one to at each launch."""
    fn.launches = 0
    _LAUNCH_COUNTED[fn.__name__] = fn
    return fn


def launch_counts() -> Dict[str, int]:
    """Each registered wrapper's launches so far, by name."""
    return {name: fn.launches for name, fn in _LAUNCH_COUNTED.items()}


class Span:
    """One timed block of a ``Recorder``; its own context manager. ``t0`` /
    ``t1``: host ns; ``d0`` / ``d1``: device seconds after the recorder's
    reference, set when the recorder resolves (the host clock's on the
    CPU)."""

    __slots__ = ("rec", "name", "path", "parent", "item", "is_item", "sync",
                 "t0", "t1", "e0", "e1", "d0", "d1")

    def __init__(self, rec: "Recorder", name: str, is_item: bool, sync: bool):
        self.rec, self.name, self.is_item, self.sync = rec, name, is_item, sync
        self.t1 = self.d0 = self.d1 = None

    def __enter__(self) -> "Span":
        rec = self.rec
        parent = rec.stack[-1] if rec.stack else None
        self.parent = parent
        self.path = self.name if parent is None else f"{parent.path}/{self.name}"
        if self.is_item:
            self.item = rec.n_items
            rec.n_items += 1
        else:
            self.item = None if parent is None else parent.item
        rec.stack.append(self)
        rec.spans.append(self)
        self.e0 = rec._event()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        rec = self.rec
        self.e1 = rec._event()
        if self.sync and self.e1 is not None:
            torch.cuda.synchronize(rec.device)
        self.t1 = time.perf_counter_ns()
        rec.stack.pop()

    @property
    def host_s(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    @property
    def device_s(self) -> float:
        return self.d1 - self.d0


class Recorder:
    """Spans and per-item counters on one device (``cuda`` where there is
    a card and none is given, else ``cpu``); finished items are folded
    into ``history`` (``items``)."""

    def __init__(self, device=None):
        self.device = None if device is None else torch.device(device)
        self.history: deque = deque(maxlen=HISTORY)
        self._free: List[Any] = []      # resolved CUDA events, reused
        self.clear()

    def clear(self) -> None:
        """Forgets every span, counter and finished item."""
        self.spans: List[Span] = []
        self.stack: List[Span] = []
        self.counters: Dict[Tuple[Optional[int], str], int] = defaultdict(int)
        self.n_items = 0
        self.history.clear()
        self._ref: Optional[Tuple[int, Any]] = None    # (host ns, CUDA event)

    def span(self, name: str, item: bool = False, sync: bool = False) -> Span:
        """A span of this recorder; ``item`` numbers a new item (a root:
        the scene, the step), ``sync`` synchronizes the device before the
        host clock stops."""
        return Span(self, name, item, sync)

    def count(self, name: str, n: int = 1) -> None:
        item = self.stack[-1].item if self.stack else None
        self.counters[(item, name)] += n

    def _event(self):
        if self.device is None:
            self.device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
        cuda = self.device.type == "cuda"
        if self._ref is None:
            self._ref = (time.perf_counter_ns(), self._record() if cuda else None)
        return self._record() if cuda else None

    def _record(self):
        e = self._free.pop() if self._free else torch.cuda.Event(enable_timing=True)
        e.record(torch.cuda.current_stream(self.device))
        return e

    def resolve(self) -> None:
        """Device times of every closed span not yet resolved: one
        synchronize, then ``elapsed_time`` against the reference event;
        the spans' events go back to the pool."""
        todo = [s for s in self.spans if s.d1 is None and s.t1 is not None]
        if not todo:
            return
        ref_ns, ref = self._ref
        if ref is not None:
            torch.cuda.synchronize(self.device)
        for s in todo:
            if ref is None:
                s.d0, s.d1 = (s.t0 - ref_ns) * 1e-9, (s.t1 - ref_ns) * 1e-9
            else:
                s.d0 = ref.elapsed_time(s.e0) * 1e-3
                s.d1 = ref.elapsed_time(s.e1) * 1e-3
                self._free += (s.e0, s.e1)
            s.e0 = s.e1 = None

    def drain(self) -> List[Span]:
        """The closed spans, resolved and taken out of the recorder."""
        self.resolve()
        done = [s for s in self.spans if s.t1 is not None]
        self.spans = [s for s in self.spans if s.t1 is None]
        return done

    def fold(self) -> None:
        """Resolves the closed spans, moves each finished item into
        ``history`` as its summary (``items``), and drops the closed spans
        and the counters of no item."""
        self.resolve()
        out = {s.item: {"root": s.name, "spans": {}, "counts": {}}
               for s in self.spans if s.is_item and s.t1 is not None}
        rest = []
        for s in self.spans:
            it = out.get(s.item)
            if it is not None:
                acc = it["spans"].setdefault(s.path, {"host_s": 0.0, "device_s": 0.0, "n": 0})
                acc["host_s"] += s.host_s
                acc["device_s"] += s.device_s
                acc["n"] += 1
            elif s.t1 is None or s.item is not None:
                rest.append(s)
        for key in [k for k in self.counters if k[0] is None or k[0] in out]:
            n = self.counters.pop(key)
            if key[0] is not None:
                out[key[0]]["counts"][key[1]] = n
        self.spans = rest
        self.history.extend(out.values())
        if not rest and self._ref is not None:
            if self._ref[1] is not None:
                self._free.append(self._ref[1])
            self._ref = None

    def items(self, root: str) -> List[Dict[str, dict]]:
        """The finished items whose root span is named ``root``, oldest
        first (at most ``HISTORY``): ``spans``, each path's host and device
        seconds summed over its occurrences in the item and their number;
        ``counts``, the item's counters."""
        self.fold()
        return [it for it in self.history if it["root"] == root]

    def take(self, root: str) -> List[Dict[str, dict]]:
        """``items(root)``, taken out of the history."""
        got = self.items(root)
        kept = [it for it in self.history if it["root"] != root]
        self.history.clear()
        self.history.extend(kept)
        return got


RECORDER = Recorder()
_NULL = contextlib.nullcontext()
_depth = 0      # open ``recording`` blocks


@contextlib.contextmanager
def recording(device=None) -> Iterator[Recorder]:
    """Records spans and counters into ``RECORDER`` for the block (blocks
    nest); ``device`` is the recorder's while it holds no span. The
    outermost block folds the recorder when it exits (``Recorder.fold``),
    or forgets its spans and counters where the block raised."""
    global _depth
    if device is not None and not RECORDER.spans:
        RECORDER.device = torch.device(device)
    _depth += 1
    ok = False
    try:
        yield RECORDER
        ok = True
    finally:
        _depth -= 1
        if not _depth:
            if ok:
                RECORDER.fold()
            else:
                RECORDER.spans, RECORDER.stack, RECORDER._ref = [], [], None
                RECORDER.counters.clear()


def span(name: str, item: bool = False, sync: bool = False):
    """A span of ``RECORDER`` (``Recorder.span``) while recording is on,
    else the shared null context (entered, it gives None)."""
    if not _depth:
        return _NULL
    return Span(RECORDER, name, item, sync)


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the current item's counter ``name`` while recording."""
    if _depth:
        RECORDER.count(name, n)


@contextlib.contextmanager
def stage_span(name: str, seconds: Optional[dict], device) -> Iterator[None]:
    """``span(name)``; given a dict ``seconds``, the span is recorded
    (recording on for it, on ``device``), the device is synchronized before
    its host clock stops, and its host seconds go to ``seconds[name]``: the
    stage spans of ``evaluate_scene(profile=True)``."""
    if seconds is None:
        with span(name):
            yield
        return
    with recording(device), span(name, sync=True) as s:
        yield
    seconds[name] = s.host_s


def host_read(x: torch.Tensor) -> torch.Tensor:
    """``x.cpu()``: the device's queue drains first. Counts one
    ``host_syncs`` while recording."""
    if _depth:
        RECORDER.count("host_syncs")
    return x.cpu()


def nonzero(x: torch.Tensor, as_tuple: bool = False):
    """``torch.nonzero(x, as_tuple=as_tuple)``, whose size is read back
    from the device. Counts one ``host_syncs`` while recording."""
    if _depth:
        RECORDER.count("host_syncs")
    return torch.nonzero(x, as_tuple=as_tuple)


def masked(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``x[mask]`` for a boolean ``mask``, whose size is read back from the
    device. Counts one ``host_syncs`` while recording."""
    if _depth:
        RECORDER.count("host_syncs")
    return x[mask]


def mean_ms(items: List[Dict[str, dict]]) -> Dict[str, float]:
    """Each span path's device milliseconds an item, mean over ``items``
    (``Recorder.items``)."""
    tot: Dict[str, float] = defaultdict(float)
    for it in items:
        for path, v in it["spans"].items():
            tot[path] += v["device_s"]
    return {p: round(1e3 * t / len(items), 2) for p, t in sorted(tot.items())}


# geopurify_tpu/utils/profiling.py:20
class StageTimer:
    """Accumulates time per named stage across steps. Each stage is a span
    of the timer's own recorder on the device of ``block_on`` (a tensor or
    a device; the host without one): on a card, the stage's time is its
    span's device interval, taken without a synchronize and resolved when
    a summary is taken."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._recorders: Dict[torch.device, Recorder] = {}

    @contextlib.contextmanager
    def stage(self, name: str, block_on: Any = None) -> Iterator[None]:
        if isinstance(block_on, torch.Tensor):
            dev = block_on.device
        else:
            dev = torch.device("cpu" if block_on is None else block_on)
        rec = self._recorders.get(dev)
        if rec is None:
            rec = self._recorders[dev] = Recorder(dev)
        with rec.span(name):
            yield

    def observe(self, name: str, seconds: float) -> None:
        self.totals[name] += seconds
        self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        for rec in self._recorders.values():
            for s in rec.drain():
                self.observe(s.name, s.device_s)
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
