"""The traced window: ``torch.profiler`` over the first items of a
``--trace 1`` run, reduced to what the per-layer readers and the result's
``device`` and ``breakdown`` keys take.

The profiler records the device's activity only: recording every host
operation as well tripled a scene's wall time (3.1 s of device work took
11.1 s), which would read as idle device time. The window is marked on the
device itself: a spin kernel of a few hundred cycles (``torch.cuda._sleep``)
is launched on an idle device when the window opens and after the last
traced item has been synchronised.

- ``busy_s``: the union of every device interval (kernels, copies, sets)
  between the two marks, so that overlapping streams count once;
- ``window_s``: from the first mark's start to the last mark's end;
- ``kernels``: device seconds and count by name;
- ``device_ops``: the ten names with the most device time;
- ``idle_gaps``: the ten longest stretches of the window with nothing on
  the device, each named by the device operation that ended just before it
  (``after <name>``), or ``window start``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

MARK = "spin_kernel"
MARK_CYCLES = 500
NAME_CHARS = 96


def merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of ``intervals`` as sorted disjoint (start, end) pairs."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals, lo: float, hi: float):
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def gaps(busy: List[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi) that the sorted disjoint ``busy`` leaves."""
    out, t = [], lo
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def name_gap(gap: Tuple[float, float], device: List[Tuple[str, float, float]]) -> str:
    """``after <the device op that ended last before the gap>``."""
    before = [(e, n) for n, s, e in device if e <= gap[0] + 1e-9]
    return f"after {max(before)[1]}" if before else "window start"


def reduce(device: List[Tuple[str, float, float]], window: Tuple[float, float]
           ) -> Dict[str, object]:
    """``device``: (name, start_s, end_s) of every device op but the marks;
    ``window``: (start_s, end_s)."""
    lo, hi = window
    dev = [(n, s, e) for n, s, e in device if e > lo and s < hi]
    busy = merge(clip([(s, e) for _, s, e in dev], lo, hi))
    by_name: Dict[str, List[float]] = {}
    for n, s, e in dev:
        acc = by_name.setdefault(n, [0.0, 0])
        acc[0] += min(e, hi) - max(s, lo)
        acc[1] += 1
    ops = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    idle = sorted(gaps(busy, lo, hi), key=lambda g: -(g[1] - g[0]))[:10]
    return {
        "window_s": hi - lo,
        "busy_s": sum(e - s for s, e in busy),
        "kernels": {n: {"seconds": v[0], "count": v[1]} for n, v in by_name.items()},
        "device_ops": [[n[:NAME_CHARS], v[0]] for n, v in ops],
        "idle_gaps": [[name_gap(g, dev)[:NAME_CHARS], g[1] - g[0]] for g in idle],
    }


class Window:
    """``start()`` before the traced items, ``stop()`` after them,
    ``result()`` once the run's window has closed. Inactive (every call a
    no-op, ``result()`` None) unless ``active`` and on a card."""

    def __init__(self, active: bool):
        import torch

        self.active = active and torch.cuda.is_available()
        self.prof = None
        self.done = False
        self.counts = (0, 0)

    def _mark(self) -> None:
        import torch

        torch.cuda.synchronize()
        torch.cuda._sleep(MARK_CYCLES)
        torch.cuda.synchronize()

    def start(self) -> None:
        if not self.active:
            return
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self._mark()

    def stop(self) -> None:
        if self.prof is None or self.done:
            return
        self._mark()
        self.prof.__exit__(None, None, None)
        self.done = True

    def result(self) -> Optional[Dict[str, object]]:
        if self.prof is None:
            return None
        from torch.autograd import DeviceType

        device, marks = [], []
        for ev in self.prof.events():
            if ev.device_type != DeviceType.CUDA:
                continue
            s, e = ev.time_range.start * 1e-6, ev.time_range.end * 1e-6
            (marks if MARK in ev.name else device).append((ev.name, s, e))
        self.counts = (len(device), len(marks))
        if len(marks) < 2:
            return None
        return reduce(device, (min(s for _, s, _ in marks), max(e for _, _, e in marks)))
