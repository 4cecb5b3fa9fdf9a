"""Kernel K2 (``csrc/infonce.cu``, forward and backward) against its
roofline: the launches' least time from A, NEG and E (``work/<cell>.json``)
over their device time in the trace."""

from perfbench.readers import roofline_pct

UNIT = "%"


def read(rec):
    return roofline_pct(rec, 1, {"infonce_fwd": "k2_fwd", "infonce_bwd": "k2_bwd"})
