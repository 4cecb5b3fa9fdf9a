"""What the span and counter readers of ``metrics/`` share: the items that
the program's own recorder (``geopurify_tpu_torch.utils.profiling``'s
``RECORDER``) kept during a traced run, read after the run in the same
process.

An item is what the cell's kind repeats, and its root span names it:
``scene`` for Stage 2, whose traced run labels every scene with
``evaluate_scene(profile=True)`` (which records the scene and folds it into
the recorder's history when it ends), ``step`` for Stage 1, whose traced
window runs under ``profiling.recording`` (folded once, after the last
step). A reader takes the last recorded items, as many as the run's steady
ones (``steady`` over ``stage_seconds`` or ``split``). A span's seconds are
its device interval (CUDA events at both ends), summed over its
occurrences in an item. A program without the recorder, and a run of
another kind than the reader's root, give None.
"""

from __future__ import annotations

from typing import List, Optional

from perfbench.readers import steady

# the stage -> the root span of its items and its records' steady key
KINDS = {1: ("step", "split"), 2: ("scene", "stage_seconds")}


def items(rec: dict, root: str) -> Optional[List[dict]]:
    """The recorded steady items of a traced run whose items' root span is
    ``root``, else None."""
    kind = KINDS.get(rec["cell"]["stage"])
    if kind is None or kind[0] != root:
        return None
    from geopurify_tpu_torch.utils import profiling

    recorder = getattr(profiling, "RECORDER", None)
    if recorder is None:
        return None
    got = recorder.items(root)
    k = len(steady(rec, kind[1]))
    if k and len(got) > k:
        got = got[-k:]
    return got or None


def span_s(rec: dict, path: str) -> Optional[float]:
    """Mean device seconds an item of the spans at ``path`` (its first
    part the items' root)."""
    its = items(rec, path.split("/")[0])
    if not its or not any(path in it["spans"] for it in its):
        return None
    return sum(it["spans"][path]["device_s"] if path in it["spans"] else 0.0
               for it in its) / len(its)


def count_mean(rec: dict, root: str, name: str) -> Optional[float]:
    """Mean count an item (of root span ``root``) of the counter ``name``."""
    its = items(rec, root)
    return sum(it["counts"].get(name, 0) for it in its) / len(its) if its else None


def count_pct(rec: dict, root: str, part: str, whole: str) -> Optional[float]:
    """100 x the counter ``part`` over the counter ``whole``, summed over
    the items of root span ``root``."""
    its = items(rec, root)
    if not its:
        return None
    den = sum(it["counts"].get(whole, 0) for it in its)
    return 100.0 * sum(it["counts"].get(part, 0) for it in its) / den if den else None
