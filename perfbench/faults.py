"""Faults planted under a cell's timed path, to show that ``correct`` comes
out false on each that the cell can have, and to read the training cells'
numbers under each (their upper readings). Each is a hook of the stage
runners (``evaluate=`` for Stage 2, ``step_fn=`` for Stage 1) or, for the
half batch of Stage 1, a wrapper around the program's sampler.
"""

from __future__ import annotations

import contextlib

import torch


def half_views(pipe, batch, profile):
    """Stage 2: half of the scene's views left out of the lift."""
    return pipe.evaluate_scene(batch, n_valid_views=batch.images.shape[0] // 2 + 1,
                               profile=profile)


def altered_answer(pipe, batch, profile):
    """Stage 2: a quarter of the points' logits rolled by one class."""
    out = pipe.evaluate_scene(batch, n_valid_views=batch.images.shape[0], profile=profile)
    logits = out["logits"].clone()
    logits[::4] = logits[::4].roll(1, dims=-1)
    return dict(out, logits=logits, pred=torch.argmax(logits, dim=-1))


def unchanged_state(step, state, scene, f2d, ft, pairs=None):
    """Stage 1: a step that returns its state unchanged."""
    saved = {k: v.detach().clone() for k, v in state.student.state_dict().items()}
    loss = step(state, scene, f2d, ft, pairs=pairs)
    state.student.load_state_dict(saved)
    return loss


def altered_loss(step, state, scene, f2d, ft, pairs=None):
    """Stage 1: the step's loss altered where it is produced."""
    return step(state, scene, f2d, ft, pairs=pairs) * 1.01


@contextlib.contextmanager
def half_batch():
    """Stage 1: half of the anchors left out, the mean over the rest."""
    from geopurify_tpu_torch.models import pipeline

    real = pipeline.sample_contrastive_pairs_hybrid

    def half(*a, **kw):
        pairs = real(*a, **kw)
        valid = pairs.anchor_valid.clone()
        valid[valid.shape[0] // 2:] = False
        return pairs._replace(anchor_valid=valid)

    pipeline.sample_contrastive_pairs_hybrid = half
    try:
        yield
    finally:
        pipeline.sample_contrastive_pairs_hybrid = real


# name -> (stage, hooks of run_cell, context)
FAULTS = {
    "half_views": (2, {"evaluate": half_views}, contextlib.nullcontext),
    "altered_answer": (2, {"evaluate": altered_answer}, contextlib.nullcontext),
    "unchanged_state": (1, {"step_fn": unchanged_state}, contextlib.nullcontext),
    "altered_loss": (1, {"step_fn": altered_loss}, contextlib.nullcontext),
    "half_batch": (1, {}, half_batch),
}
