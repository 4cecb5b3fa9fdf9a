"""What the span and counter readers of ``metrics/`` share: the scenes that
the program's own recorder (``geopurify_tpu_torch.utils.profiling``'s
``RECORDER``) kept during a traced Stage-2 run, read after the run in the
same process.

A Stage-2 traced run labels every scene with ``evaluate_scene(profile=True)``,
which records the scene (the root span ``scene``) and folds it into the
recorder's history when it ends. A reader takes the last recorded scenes,
as many as the run's steady ones. A span's seconds are its device interval
(CUDA events at both ends), summed over its occurrences in a scene. A
program without the recorder, and a run of another stage, give None.
"""

from __future__ import annotations

from typing import List, Optional

from perfbench.readers import steady


def items(rec: dict) -> Optional[List[dict]]:
    """The recorded steady scenes of a traced Stage-2 run, else None."""
    if rec["cell"]["stage"] != 2:
        return None
    from geopurify_tpu_torch.utils import profiling

    recorder = getattr(profiling, "RECORDER", None)
    if recorder is None:
        return None
    got = recorder.items("scene")
    k = len(steady(rec, "stage_seconds"))
    if k and len(got) > k:
        got = got[-k:]
    return got or None


def span_s(rec: dict, path: str) -> Optional[float]:
    """Mean device seconds a scene of the spans at ``path``."""
    its = items(rec)
    if not its or not any(path in it["spans"] for it in its):
        return None
    return sum(it["spans"][path]["device_s"] if path in it["spans"] else 0.0
               for it in its) / len(its)


def count_mean(rec: dict, name: str) -> Optional[float]:
    """Mean count a scene of the counter ``name``."""
    its = items(rec)
    return sum(it["counts"].get(name, 0) for it in its) / len(its) if its else None


def count_pct(rec: dict, part: str, whole: str) -> Optional[float]:
    """100 x the counter ``part`` over the counter ``whole``, summed over
    the scenes."""
    its = items(rec)
    if not its:
        return None
    den = sum(it["counts"].get(whole, 0) for it in its)
    return 100.0 * sum(it["counts"].get(part, 0) for it in its) / den if den else None
