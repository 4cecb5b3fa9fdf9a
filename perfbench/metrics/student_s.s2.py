"""Seconds a scene in the student: the voxel means, the neighbour (and z-stack)
tables and the sparse-conv forward: the device interval of the program's
``scene/pool_classify/student`` spans (CUDA events at both ends), summed
over a scene, mean over the steady scenes of the traced run."""

from perfbench.spans import span_s

UNIT = "s"


def read(rec):
    return span_s(rec, "scene/pool_classify/student")
