"""Seconds a scene building the affinity graph: the grid kNN-96 (its host reads
included) and the sharpened softmax weights: the device interval of the
program's ``scene/pool_classify/graph`` spans (CUDA events at both ends),
summed over a scene, mean over the steady scenes of the traced run."""

from perfbench.spans import span_s

UNIT = "s"


def read(rec):
    return span_s(rec, "scene/pool_classify/graph")
