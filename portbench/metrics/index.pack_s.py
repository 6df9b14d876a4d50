"""Seconds of reading and packing the eBWT file(s) on the host
(the span ``index.pack`` inside the pipeline's ``index`` phase) per
sample, from
the ``stats["seconds"]`` the pipeline returns, over the window's samples;
None where the program has no such span."""

from portbench.readers import phase_mean


def read(run):
    return phase_mean(run, "index.pack")
