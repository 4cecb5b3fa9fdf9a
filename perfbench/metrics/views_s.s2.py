"""Seconds a scene in the views layer: the X-Decoder forward and the
index-valued lift of every view (``evaluate_scene(profile=True)``'s
``views`` span, the steady scenes of the traced run)."""

from perfbench.readers import stage_mean

UNIT = "s"


def read(rec):
    return stage_mean(rec, "views")
