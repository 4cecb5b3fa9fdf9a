"""Kernel K1 (``csrc/band_matmul.cu``, both routes) against its roofline:
the launches' least time at the bf16 peak and HBM rate, from the cell's M,
band and C (``work/<cell>.json``), over their device time in the trace."""

from perfbench.readers import roofline_pct

UNIT = "%"


def read(rec):
    return roofline_pct(rec, 2, {"band_matmul": "k1"})
