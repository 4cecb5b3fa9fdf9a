"""The share of the graph's grid kNN-96 queries that failed their certificate
and fell back to the exact search over the full row (the program's
``knn_self.failed`` over ``knn_self.queries`` counters, summed over the
steady scenes of the traced run)."""

from perfbench.spans import count_pct

UNIT = "%"


def read(rec):
    return count_pct(rec, "scene", "knn_self.failed", "knn_self.queries")
