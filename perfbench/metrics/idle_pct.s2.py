"""The share of the traced window with nothing on the device (kernels,
copies and sets merged across streams)."""

from perfbench.readers import idle_pct

UNIT = "%"


def read(rec):
    return idle_pct(rec, 2)
