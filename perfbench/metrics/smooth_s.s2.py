"""Seconds a scene smoothing: the Hilbert order, the banded operator, its
``n_dropped`` read, the 19 rounds through K1 and the un-permute: the device
interval of the program's ``scene/pool_classify/smooth`` spans (CUDA events
at both ends), summed over a scene, mean over the steady scenes of the
traced run."""

from perfbench.spans import span_s

UNIT = "s"


def read(rec):
    return span_s(rec, "scene/pool_classify/smooth")
