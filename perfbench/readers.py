"""What the per-layer readers of ``metrics/`` share: the steady items of a
traced run (those after the profiled ones, where there are any) and the
device time of a kernel family."""

from __future__ import annotations

from typing import Optional

from perfbench.peaks import BF16_FLOPS, bound_s


def steady(rec: dict, key: str) -> list:
    """The entries of ``rec[key]`` after the profiled items, else all."""
    items = rec.get(key) or []
    rest = items[rec.get("trace_items", 0):]
    return rest or items


def stage_mean(rec: dict, stage: str) -> Optional[float]:
    """Mean seconds a scene of one of ``evaluate_scene``'s stage spans."""
    if rec["cell"]["stage"] != 2:
        return None
    vals = [s[stage] for s in steady(rec, "stage_seconds") if stage in s]
    return sum(vals) / len(vals) if vals else None


def split_mean(rec: dict, part: str) -> Optional[float]:
    if rec["cell"]["stage"] != 1:
        return None
    vals = [s[part] for s in steady(rec, "split")]
    return sum(vals) / len(vals) if vals else None


def mfu_pct(rec: dict, stage: int) -> Optional[float]:
    """The counted work of an item over its mean wall time, against the
    bf16 peak, in %."""
    flops = rec["work"].get("flops_per_item")
    secs = steady(rec, "item_seconds")
    if rec["cell"]["stage"] != stage or not flops or not secs:
        return None
    return 100.0 * flops / (sum(secs) / len(secs)) / BF16_FLOPS


def idle_pct(rec: dict, stage: int) -> Optional[float]:
    t = rec.get("trace")
    if rec["cell"]["stage"] != stage or not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def roofline_pct(rec: dict, stage: int, parts: dict) -> Optional[float]:
    """``parts``: kernel-name substring -> the work file's key of its
    (flops, bytes) a launch. The launches' least time at peak over their
    device time, in %."""
    t = rec.get("trace")
    if rec["cell"]["stage"] != stage or not t:
        return None
    least = secs = 0.0
    for sub, key in parts.items():
        w = rec["work"].get(key)
        hits = [v for n, v in t["kernels"].items() if sub in n]
        if not w or not hits:
            return None
        least += sum(v["count"] for v in hits) * bound_s(w["flops"], w["bytes"])
        secs += sum(v["seconds"] for v in hits)
    return 100.0 * least / secs if secs > 0 else None
