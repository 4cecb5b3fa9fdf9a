"""Device-to-host synchronisations a scene, mean over the steady scenes of the
traced run: the program's ``host_syncs`` counter, one for each call of
``profiling.host_read``, ``profiling.nonzero`` or ``profiling.masked``,
through which the scene's path makes its reads of device values and of the
sizes of data-dependent results (each waits for the device's queue to
drain)."""

from perfbench.spans import count_mean

UNIT = "syncs/scene"


def read(rec):
    return count_mean(rec, "scene", "host_syncs")
