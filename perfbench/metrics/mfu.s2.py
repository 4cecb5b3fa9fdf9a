"""The whole scene's share of the bf16 peak: the counted operations of a
scene (``work/<cell>.json``) over its mean wall time."""

from perfbench.readers import mfu_pct

UNIT = "%"


def read(rec):
    return mfu_pct(rec, 2)
