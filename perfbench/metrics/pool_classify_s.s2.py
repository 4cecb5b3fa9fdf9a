"""Seconds a scene in pool and classify: voxel means, the student, the kNN
graph, the smoothing rounds and the logits (``evaluate_scene(profile=True)``'s
``pool_classify`` span)."""

from perfbench.readers import stage_mean

UNIT = "s"


def read(rec):
    return stage_mean(rec, "pool_classify")
