"""The share of the traced window with nothing on the device."""

from perfbench.readers import idle_pct

UNIT = "%"


def read(rec):
    return idle_pct(rec, 1)
