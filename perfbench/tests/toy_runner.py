"""A runner of a toy kind, for the tests: a cell of a new kind brought as one
file, reusing Stage 1's set-up, window and comparison through the seams of
``stage1.run``. Its teacher is a linear map of each point's six geometric
features, drawn from the seed and computed inside the timed call ahead of
the train step; the plain reference draws the map again and computes it on
its own side, and ``teacher_gap`` holds the program's teacher features of
the set-up steps against it."""

from __future__ import annotations

import torch

from perfbench import stage1
from perfbench.gen.weights import sub_seed

TEACHER_TAG = 11      # the map's seed under the run's
GEOM = 6              # geometric channels of a scene (``gen/scene.py``)


def draw_map(cell: dict, seed: int, device) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, TEACHER_TAG))
    return torch.randn((GEOM, cell["traffic"]["teacher_dim"]), generator=g, device=device)


def inputs(cell: dict, seed: int, device) -> tuple:
    """Stage 1's scenes and lifted features; no teacher features (the
    teacher makes them)."""
    scenes, f2d, _ = stage1.inputs(cell, seed, device)
    return scenes, f2d, [None] * len(scenes)


def reference(cell, seed, scenes, f2d, ft, kept, lowp=None) -> tuple:
    """The reference's teacher features (in bf16 where ``lowp`` is given)
    and, against the program's ``kept``, ``teacher_gap``: the largest
    |f - f_ref| / |f_ref| over the set-up steps."""
    dtype = torch.bfloat16 if lowp else torch.float32
    w = draw_map(cell, seed, scenes[0]["points"].device).to(dtype)
    feats = [(s["geom_feats"].to(dtype) @ w).float() for s in scenes]
    if kept is None:
        return feats, {}
    gap = max(float((k.float() - feats[t % len(feats)].cpu()).norm()
                    / feats[t % len(feats)].norm().clamp(min=1e-30))
              for t, k in enumerate(kept))
    return feats, {"teacher_gap": gap}


def work(cell: dict) -> dict:
    """Stage 1's step and the teacher's map."""
    out = stage1.work(cell)
    out["parts"]["teacher"] = 2.0 * cell["traffic"]["scene"]["points"] * GEOM \
        * cell["traffic"]["teacher_dim"]
    out["flops_per_item"] = sum(out["parts"].values())
    return out


def control(cell: dict, seed: int, device, lowp=None) -> dict:
    return stage1.control(cell, seed, device, lowp, inputs=inputs, reference=reference)


def run(cell, seed, seconds, trace, device, say, teach=None, **hooks) -> dict:
    """``teach(w, geom_feats)`` replaces the teacher's call where a test
    plants a fault."""
    program = {"w": draw_map(cell, seed, device)}
    teach = teach or (lambda w, geom: geom @ w)

    def ahead(t, batch, f2d, ft):
        return teach(program["w"], batch.geom_feats)

    def judged(*args, **kw):
        program.clear()          # the program's teacher is freed
        return reference(*args, **kw)

    return stage1.run(cell, seed, seconds, trace, device, say, inputs=inputs, ahead=ahead,
                      reference=judged, **hooks)
