"""Seconds a scene in the X-Decoder's 9-round query head: the device interval
of the program's ``scene/views/head`` spans (CUDA events at both ends),
summed over a scene, mean over the steady scenes of the traced run."""

from perfbench.spans import span_s

UNIT = "s"


def read(rec):
    return span_s(rec, "scene/views/head")
