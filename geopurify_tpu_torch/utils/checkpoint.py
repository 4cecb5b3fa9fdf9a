"""Checkpoint save / restore of the Stage-1 training state.

Port of the save / restore half of geopurify_tpu/utils/checkpoint.py
(:34-84) over ``torch.save`` / ``torch.load`` (orbax is not a dependency
of the port; the format is the port's own). A checkpoint directory holds
``step_<n>.pt`` files, written atomically, newest ``keep`` kept.
"""

from __future__ import annotations

import logging
import os
import re
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch

log = logging.getLogger("geopurify.checkpoint")
_NAME = re.compile(r"step_(\d+)\.pt$")


def _steps(path: Path):
    return sorted(int(m.group(1)) for f in path.glob("step_*.pt")
                  if (m := _NAME.search(f.name)))


# geopurify_tpu/utils/checkpoint.py:34
def save_checkpoint(path: str, state: Dict[str, Any], step: int, keep: int = 3) -> None:
    d = Path(path).absolute()
    d.mkdir(parents=True, exist_ok=True)
    tmp = d / f".step_{step}.pt.{os.getpid()}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, d / f"step_{step}.pt")
    for old in _steps(d)[:-keep]:
        (d / f"step_{old}.pt").unlink(missing_ok=True)


# geopurify_tpu/utils/checkpoint.py:45
def save_checkpoint_with_retry(path: str, state: Dict[str, Any], step: int,
                               keep: int = 3, attempts: int = 3, sleep_s: float = 30.0,
                               _save=None) -> int:
    """``save_checkpoint`` with the reference's 3-attempt retry: a failed
    attempt is logged and retried after ``sleep_s``. Returns the attempts
    used; raises the last error once they are exhausted. ``_save`` is the
    failure-injection seam of the tests."""
    save = _save or save_checkpoint
    last = None
    for attempt in range(1, attempts + 1):
        try:
            save(path, state, step, keep=keep)
            return attempt
        except Exception as e:  # noqa: BLE001 — the reference's broad catch
            last = e
            log.warning("checkpoint save attempt %d/%d failed: %s", attempt, attempts, e)
            if attempt < attempts:
                time.sleep(sleep_s)
    raise last


# geopurify_tpu/utils/checkpoint.py:75
def restore_checkpoint(path: str, step: Optional[int] = None
                       ) -> Tuple[Optional[Dict[str, Any]], Optional[int]]:
    """(state, step) of ``step`` (default: the newest) in the directory
    ``path``, or (None, None) when it holds none. Tensors load on the CPU."""
    d = Path(path).absolute()
    steps = _steps(d) if d.is_dir() else []
    if step is None:
        if not steps:
            return None, None
        step = steps[-1]
    state = torch.load(d / f"step_{step}.pt", map_location="cpu", weights_only=True)
    return state, step
