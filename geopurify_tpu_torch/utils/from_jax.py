"""Carry the JAX package's parameters across to the port's modules.

Input: the Flax variable trees of geopurify_tpu, as nested mappings of
numpy-convertible arrays (no JAX import here). Output: torch state dicts
for the port's modules, whose parameter names mirror the Flax names:

- Dense ``kernel`` [in, out] -> ``weight`` [out, in];
- Conv ``kernel`` HWIO -> ``weight`` OIHW (depthwise [k, k, 1, C] ->
  [C, 1, k, k]);
- sparse-conv ``kernel`` [27, Cin, Cout] stays as it is;
- LayerNorm / GroupNorm / BatchNorm ``scale`` -> ``weight``;
- FocalNet's and Sonata's ``nn.scan`` stages stack their blocks on a
  leading depth axis under ``layers{i}_blocks/block`` / ``stage{s}_blocks/
  block`` (geopurify_tpu/models/focalnet.py:286-305, sonata.py:274-284):
  they unstack to ``..._blocks.{d}``;
- the ViT neck's ConvTranspose ``kernel`` [k, k, in, out] (a correlation
  over the stride-dilated input) -> torch's ConvTranspose2d ``weight`` [in,
  out, k, k], spatially flipped;
- raw parameters (Sonata's ``cpe_kernel`` / ``stem_kernel_w``, the text
  tower's ``positional_embedding``, ``lang_proj``, ``logit_scale``, an
  Embed's ``embedding``; the X-Decoder's caption slots, the ViT's
  ``pos_embed`` / ``rel_pos_*`` tables, the deformable decoder's
  ``level_embed``; the SEEM heads' ``mask_spatial_embed{i}``,
  ``spatial_embed``, ``spatial_featured``, ``pn_indicator``,
  ``level_embed``, ``query_feat``, ``query_embed``, ``class_embed``) keep
  their name and layout.
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch


def _leaves(tree, prefix=()) -> Iterator[Tuple[tuple, np.ndarray]]:
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _leaves(val, prefix + (str(key),))
        else:
            yield prefix + (str(key),), np.asarray(val)


# the transposed convs of models/vit_backbone.SimpleFPN
_CONV_TRANSPOSE = re.compile(r"(^|\.)neck\.d(4_up[12]|8_up)$")


def _leaf(name: str, arr: np.ndarray, transpose_conv: bool = False) -> Tuple[str, np.ndarray]:
    if name == "kernel":
        if transpose_conv:
            return "weight", arr[::-1, ::-1].transpose(2, 3, 0, 1)
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
        name, arr = _leaf(path[-1], arr, bool(_CONV_TRANSPOSE.search(".".join(mods))))
        out[".".join(mods + [name])] = torch.from_numpy(np.array(arr))
    return out


def params_from_jax(variables) -> Dict[str, torch.Tensor]:
    """State dict of a port module whose JAX variables hold parameters only
    (``{"params": ...}`` or the bare params): ``models.xdecoder.
    XDecoderSegModel`` (every backbone and pixel decoder, the caption
    slots), ``models.sonata.SonataTeacher`` and
    ``models.lang.LanguageEncoder``."""
    return _state_dict(variables["params"] if "params" in variables else variables)


xdecoder_from_jax = sonata_from_jax = lang_from_jax = params_from_jax


def sonata_to_jax(state_dict) -> Dict[str, Any]:
    """The inverse of ``params_from_jax`` for ``models.sonata.SonataTeacher``:
    its state dict as the Flax-layout tree of numpy arrays that the JAX
    teacher and ``parity/sonata_oracle.sonata_forward_naive`` read. Dense
    ``weight`` [out, in] -> ``kernel`` [in, out]; a norm's ``weight`` ->
    ``scale``; the sparse convs' [27, Cin, Cout] kernels as they are;
    ``stage{s}_blocks.{d}`` stacked on a leading depth axis under
    ``stage{s}_blocks/block``."""
    tree: Dict[str, Any] = {}
    stacked: Dict[tuple, Dict[int, np.ndarray]] = {}
    for key, val in state_dict.items():
        *mods, leaf = key.split(".")
        a = val.detach().cpu().numpy() if isinstance(val, torch.Tensor) else np.asarray(val)
        if leaf == "weight":
            if a.ndim not in (1, 2):
                raise ValueError(f"{key}: a Sonata weight is a Dense or a norm one, "
                                 f"not of shape {a.shape}")
            leaf, a = ("scale", a) if a.ndim == 1 else ("kernel", a.T)
        a = np.ascontiguousarray(a)
        i = next((i for i, m in enumerate(mods[:-1])
                  if m.endswith("_blocks") and mods[i + 1].isdigit()), None)
        if i is not None:
            stacked.setdefault((*mods[:i + 1], "block", *mods[i + 2:], leaf),
                               {})[int(mods[i + 1])] = a
            continue
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = a
    for path, by_depth in stacked.items():
        node = tree
        for m in path[:-1]:
            node = node.setdefault(m, {})
        node[path[-1]] = np.stack([by_depth[d] for d in sorted(by_depth)])
    return tree


def student_from_jax(variables) -> Dict[str, torch.Tensor]:
    """State dict for ``models.student.AffinityPredictor`` from the JAX
    student variables: ``params`` and ``batch_stats`` (running mean/var)."""
    sd = _state_dict(variables["params"])
    sd.update(_state_dict(variables["batch_stats"]))
    return sd


# the SEEM parameter groups Flax creates only for the prompt kinds passed at
# ``.init`` (geopurify_tpu/models/seem.py:106-107); the port builds them all
_SEEM_GROUPS = (
    ("the spatial prompts' (pn_indicator, mask_spatial_embed{i})",
     re.compile(r"^(pn_indicator|mask_spatial_embed\d+)$")),
    ("the spatial memories' (spatial_embed, spatial_featured)",
     re.compile(r"^spatial_(embed|featured)$")),
)


def seem_from_jax(variables, head: Optional[torch.nn.Module] = None) -> Dict[str, torch.Tensor]:
    """State dict of ``models.seem.SEEMHead`` / ``SEEMHeadV1`` /
    ``SEEMHeadDemo`` from the JAX head's variables. Every port head has the
    spatial prompts' parameters, and v0 / v1 the spatial memories too;
    Flax makes them only when ``.init`` saw spatial prompts. A tree without
    the prompts' group (or, given the port ``head``, without any of its
    parameters) raises ``KeyError`` naming the group: init the JAX head
    with every prompt kind."""
    sd = params_from_jax(variables)
    want = set(head.state_dict()) if head is not None else {"pn_indicator", "mask_spatial_embed0"}
    missing = sorted(want - set(sd))
    if missing:
        groups = [name for name, pat in _SEEM_GROUPS if any(pat.match(k) for k in missing)]
        raise KeyError(f"the JAX SEEM tree lacks {' and '.join(groups) or 'some'} parameters "
                       f"{missing}: Flax creates them only for the prompt kinds passed at "
                       ".init; init the JAX head with every prompt kind")
    return sd


def train2d_from_jax(params, head: Optional[torch.nn.Module] = None) -> Dict[str, torch.Tensor]:
    """State dict of ``run.train2d.Train2DParams`` from a JAX
    ``Train2DState.params`` tree (or a gradient tree of its shape), for each
    task's tree: ``{model, no_object}``, ``{model, lang}``, ``{model, lang,
    no_object}`` or ``{backbone, pixdec, head}``. ``model`` / ``lang`` /
    ``backbone`` / ``pixdec`` go through ``params_from_jax``, ``head``
    through ``seem_from_jax`` (given the port ``head``, every parameter it
    has must be there), ``no_object`` stays as it is."""
    sd: Dict[str, torch.Tensor] = {}
    for name, tree in params.items():
        if name == "no_object":
            sd[name] = torch.from_numpy(np.array(tree))
            continue
        sub = seem_from_jax(tree, head) if name == "head" else params_from_jax(tree)
        sd.update({f"{name}.{k}": v for k, v in sub.items()})
    return sd
