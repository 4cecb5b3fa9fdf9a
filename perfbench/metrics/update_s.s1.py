"""Seconds a step in the train step given its pairs: student forward and
backward, the K2 loss, AdamW."""

from perfbench.readers import split_mean

UNIT = "s"


def read(rec):
    return split_mean(rec, "update")
