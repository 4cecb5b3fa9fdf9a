"""Seconds a scene in the X-Decoder's backbone (the input's normalisation and
padding, FocalNet-L with its depthwise focal convs): the device interval of
the program's ``scene/views/backbone`` spans (CUDA events at both ends),
summed over a scene, mean over the steady scenes of the traced run."""

from perfbench.spans import span_s

UNIT = "s"


def read(rec):
    return span_s(rec, "scene/views/backbone")
