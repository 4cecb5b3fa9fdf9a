"""Carry the JAX package's parameters across to the port's modules.

Input: the Flax variable trees of geopurify_tpu, as nested mappings of
numpy-convertible arrays (no JAX import here). Output: torch state dicts
for the port's modules, whose parameter names mirror the Flax names:

- Dense ``kernel`` [in, out] -> ``weight`` [out, in];
- Conv ``kernel`` HWIO -> ``weight`` OIHW (depthwise [k, k, 1, C] ->
  [C, 1, k, k]);
- sparse-conv ``kernel`` [27, Cin, Cout] stays as it is;
- LayerNorm / GroupNorm / BatchNorm ``scale`` -> ``weight``;
- FocalNet's ``nn.scan`` stages stack their blocks on a leading depth axis
  under ``layers{i}_blocks/block`` (geopurify_tpu/models/focalnet.py:286-305):
  they unstack to ``layers{i}_blocks.{d}``.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, Iterator, Tuple

import numpy as np
import torch


def _leaves(tree, prefix=()) -> Iterator[Tuple[tuple, np.ndarray]]:
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _leaves(val, prefix + (str(key),))
        else:
            yield prefix + (str(key),), np.asarray(val)


def _leaf(name: str, arr: np.ndarray) -> Tuple[str, np.ndarray]:
    if name == "kernel":
        if arr.ndim == 2:
            return "weight", arr.T
        if arr.ndim == 4:
            return "weight", arr.transpose(3, 2, 0, 1)
        return "kernel", arr
    if name == "scale":
        return "weight", arr
    return name, arr


def _state_dict(tree) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for path, arr in _leaves(tree):
        mods = list(path[:-1])
        i = mods.index("block") if "block" in mods else -1
        if i > 0 and mods[i - 1].endswith("_blocks"):
            for d in range(arr.shape[0]):
                name, a = _leaf(path[-1], arr[d])
                key = ".".join(mods[:i] + [str(d)] + mods[i + 1:] + [name])
                out[key] = torch.from_numpy(np.array(a))
            continue
        name, arr = _leaf(path[-1], arr)
        out[".".join(mods + [name])] = torch.from_numpy(np.array(arr))
    return out


def xdecoder_from_jax(variables) -> Dict[str, torch.Tensor]:
    """State dict for ``models.xdecoder.XDecoderSegModel`` from the JAX
    ``XDecoderSegModel`` variables (``{"params": ...}`` or the bare params)."""
    params = variables["params"] if "params" in variables else variables
    return _state_dict(params)


def student_from_jax(variables) -> Dict[str, torch.Tensor]:
    """State dict for ``models.student.AffinityPredictor`` from the JAX
    student variables: ``params`` and ``batch_stats`` (running mean/var)."""
    sd = _state_dict(variables["params"])
    sd.update(_state_dict(variables["batch_stats"]))
    return sd
