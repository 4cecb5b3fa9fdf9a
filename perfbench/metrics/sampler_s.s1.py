"""Seconds a step in the contrastive sampler (anchors, their spatial kNN,
positives and negatives), called by the harness and synchronised."""

from perfbench.readers import split_mean

UNIT = "s"


def read(rec):
    return split_mean(rec, "sampler")
