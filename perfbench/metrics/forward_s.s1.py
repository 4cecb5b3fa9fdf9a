"""Seconds a step in the student's forward given the step's pairs: the voxel
means of the lifted and geometric features, the neighbour table, the
sparse-conv student in train mode and the gathers of the anchors',
positives' and negatives' embeddings: the device interval of the program's
``step/forward`` span (CUDA events at both ends), mean over the steady
steps of the traced run."""

from perfbench.spans import span_s

UNIT = "s"


def read(rec):
    return span_s(rec, "step/forward")
