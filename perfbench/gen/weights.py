"""Seeded weights and class prompts, drawn by the benchmark on the device.

A frozen copy of the port's ``utils/seeding.py`` recipes, drawn in one
large call a module instead of leaf by leaf:

- the X-Decoder's matrices N(0, 1 / fan-in) (every parameter of two or
  more dimensions, fan-in the product of all but the first), zero biases,
  FocalNet's layer scales 1e-4 (its published LayerScale init), every other
  vector (norm scales) 1 (``seed_lecun``, but for the layer scales, which
  it sets to 1: then the bf16 backbone differs from f32 by 22-42% at
  res4-res5, against 0.5-0.6% at 1e-4);
- the student's conv kernels He-normal (fan-in taps x Cin, or Cin for the
  1^3 projection), biases 0, BatchNorm as built: scale 1, shift 0, running
  mean 0 and variance 1 (``seed_student``);
- the class prompts: the embeddings of the queries that win the most points
  of the first view (one a class), less their mean and normalized, and a
  random background row (``query_prompts``, centred): random prompts all
  pick one class, and the seeded queries' embeddings share one direction,
  which leaves each point's class logits nearly level unless the prompts
  are centred.

The state dicts are keyed by the program's own parameter names (the
reference's modules carry the same names), so the same tensors load into
both sides. ``sub_seed`` derives each draw's seed from ``--seed``.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import numpy as np
import torch


LAYER_SCALE = 1e-4


def sub_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed of ``seed`` and ``tags`` (any whole numbers)."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), *[int(t) for t in tags]])
    return int(ss.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


def _flat_normal(shapes, seed: int, device) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(seed)
    total = sum(math.prod(s) for s in shapes)
    return torch.randn((total,), generator=g, device=device)


def draw_xdecoder(named_shapes: Iterable[Tuple[str, tuple]], seed: int, device
                  ) -> Dict[str, torch.Tensor]:
    """``seed_lecun``'s recipe for the parameters ``named_shapes``."""
    named_shapes = list(named_shapes)
    mats = [s for _, s in named_shapes if len(s) >= 2]
    flat = _flat_normal(mats, seed, device)
    out, off = {}, 0
    for name, s in named_shapes:
        if len(s) >= 2:
            n = math.prod(s)
            out[name] = flat[off: off + n].view(s).mul_(1.0 / math.sqrt(math.prod(s[1:])))
            off += n
        elif name.endswith("bias"):
            out[name] = torch.zeros(s, device=device)
        elif name.rsplit(".", 1)[-1] in ("gamma_1", "gamma_2"):
            out[name] = torch.full(s, LAYER_SCALE, device=device)
        else:
            out[name] = torch.ones(s, device=device)
    return out


def draw_student(named_shapes: Iterable[Tuple[str, tuple]], seed: int, device
                 ) -> Dict[str, torch.Tensor]:
    """``seed_student``'s recipe for the student's parameters and buffers."""
    named_shapes = list(named_shapes)

    def fan_in(name, s):
        if name.endswith("kernel"):
            return s[0] * s[1]
        if name.endswith("output_conv.weight"):
            return s[1]
        return None

    drawn = [s for n, s in named_shapes if fan_in(n, s)]
    flat = _flat_normal(drawn, seed, device)
    out, off = {}, 0
    for name, s in named_shapes:
        f = fan_in(name, s)
        if f:
            n = math.prod(s)
            out[name] = flat[off: off + n].view(s).mul_(math.sqrt(2.0 / f))
            off += n
        elif name.endswith("bias") or name.endswith("mean"):
            out[name] = torch.zeros(s, device=device)
        else:                       # BatchNorm scale, running variance
            out[name] = torch.ones(s, device=device)
    return out


def unit_rows(n: int, dim: int, seed: int, device) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(seed)
    t = torch.randn((n, dim), generator=g, device=device)
    return t / t.norm(dim=-1, keepdim=True)


def prompts_from_lift(winner: torch.Tensor, embed_table: torch.Tensor, n_cls: int,
                      seed: int) -> torch.Tensor:
    """The rows of ``embed_table`` [Q + 1, C] (L2-normed, zero last row) of
    the ``n_cls`` queries that win the most of ``winner`` [Pv] (values in
    [0, Q]), less their mean, normalized; then a random background row."""
    Q = embed_table.shape[0] - 1
    top = torch.bincount(winner.long(), minlength=Q + 1)[:Q].topk(n_cls).indices
    rows = embed_table[top]
    rows = rows - rows.mean(dim=0, keepdim=True)
    rows = rows / rows.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    bg = unit_rows(1, embed_table.shape[1], seed, embed_table.device)
    return torch.cat([rows, bg])
