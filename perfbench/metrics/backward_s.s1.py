"""Seconds a step in the backward pass: autograd through K2's backward, the
gathers and the student's convolutions: the device interval of the
program's ``step/backward`` span (CUDA events at both ends), mean over the
steady steps of the traced run."""

from perfbench.spans import span_s

UNIT = "s"


def read(rec):
    return span_s(rec, "step/backward")
