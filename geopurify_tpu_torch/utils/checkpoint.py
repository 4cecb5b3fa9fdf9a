"""Checkpoint save / restore of the Stage-1 training state, and the
converter of released student checkpoints.

Port of geopurify_tpu/utils/checkpoint.py. Save / restore (:34-84) run over
``torch.save`` / ``torch.load`` (orbax is not a dependency of the port; the
format is the port's own): a checkpoint directory holds ``step_<n>.pt``
files, written atomically, newest ``keep`` kept. ``convert_student_checkpoint``
(:91-171) maps the reference's MinkowskiEngine student state dict straight
to the port's ``AffinityPredictor`` state dict.
"""

from __future__ import annotations

import itertools
import logging
import os
import re
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
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


# geopurify_tpu/utils/checkpoint.py:91
def _me_offset_permutation() -> np.ndarray:
    """perm[j] = our-order index of ME's j-th kernel offset: the JAX
    package's order, shared as it is (ours enumerates (dx, dy, dz) with dx
    slowest, ops/sparse_conv.kernel_offsets_3d; MinkowskiEngine enumerates
    with the first axis fastest)."""
    r = (-1, 0, 1)
    ours = {off: i for i, off in enumerate(itertools.product(r, r, r))}
    me_order = [(dx, dy, dz) for dz in r for dy in r for dx in r]
    return np.array([ours[o] for o in me_order])


# geopurify_tpu/utils/checkpoint.py:104
def convert_student_checkpoint(state_dict: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """State dict of ``models.student.AffinityPredictor`` from a torch
    (MinkowskiEngine) AffinityPredictor state dict. Torch names:
    ``input_layer.0.kernel`` / ``input_layer.1.{weight,bias,running_mean,
    running_var}`` (or under ``.bn``), ``res_blocks.{i}.conv{1,2}.kernel``,
    ``res_blocks.{i}.norm{1,2}.*``, ``output_layer.kernel`` (+ biases where
    present). 3^3 kernels [27, Cin, Cout] take the JAX package's tap
    permutation; the 1^3 output kernel [Cin, Cout] becomes the port's
    [Cout, Cin] weight."""
    sd = {k: np.asarray(v) for k, v in state_dict.items()}
    perm = _me_offset_permutation()
    out: Dict[str, torch.Tensor] = {}

    def put(name, arr):
        out[name] = torch.from_numpy(np.array(arr, dtype=np.float32))

    def conv3(src: str, dst: str):
        k = sd[f"{src}.kernel"]
        put(f"{dst}.kernel", k[perm])
        put(f"{dst}.bias", sd.get(f"{src}.bias", np.zeros((k.shape[-1],), np.float32)))

    def bn(src: str, dst: str):
        # ME.MinkowskiBatchNorm wraps torch BatchNorm1d under `.bn`
        pre = f"{src}.bn" if f"{src}.bn.weight" in sd else src
        put(f"{dst}.weight", sd[f"{pre}.weight"])
        put(f"{dst}.bias", sd[f"{pre}.bias"])
        put(f"{dst}.mean", sd[f"{pre}.running_mean"])
        put(f"{dst}.var", sd[f"{pre}.running_var"])

    conv3("input_layer.0", "input_conv")
    bn("input_layer.1", "input_norm")
    i = 0
    while f"res_blocks.{i}.conv1.kernel" in sd:
        conv3(f"res_blocks.{i}.conv1", f"res{i}.conv1")
        bn(f"res_blocks.{i}.norm1", f"res{i}.norm1")
        conv3(f"res_blocks.{i}.conv2", f"res{i}.conv2")
        bn(f"res_blocks.{i}.norm2", f"res{i}.norm2")
        i += 1
    k = sd["output_layer.kernel"]
    k = k if k.ndim == 2 else k[0]
    put("output_conv.weight", k.T)
    put("output_conv.bias", sd.get("output_layer.bias", np.zeros(k.shape[-1], np.float32)))
    return out


# geopurify_tpu/utils/checkpoint.py:174
def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A torch checkpoint's state dict as numpy arrays, loaded on the CPU
    (unpickled in full, as the released files need: load only files you
    trust)."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "model_state_dict" in obj:
        obj = obj["model_state_dict"]
    if isinstance(obj, dict) and "model" in obj and isinstance(obj["model"], dict):
        obj = obj["model"]
    return {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v) for k, v in obj.items()}
