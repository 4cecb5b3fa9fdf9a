"""Seconds a scene in the lift layer: cross-view fusion and the unseen
fill (``evaluate_scene(profile=True)``'s ``fuse_fill`` span)."""

from perfbench.readers import stage_mean

UNIT = "s"


def read(rec):
    return stage_mean(rec, "fuse_fill")
