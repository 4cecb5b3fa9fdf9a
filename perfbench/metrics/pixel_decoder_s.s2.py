"""Seconds a scene in the X-Decoder's FPN pixel decoder and its 6-layer
encoder: the device interval of the program's ``scene/views/pixel_decoder``
spans (CUDA events at both ends), summed over a scene, mean over the steady
scenes of the traced run."""

from perfbench.spans import span_s

UNIT = "s"


def read(rec):
    return span_s(rec, "scene/views/pixel_decoder")
