"""Seconds of the index upload and the ``index`` phase's closing
synchronise (the span ``index.upload``) per sample, from
the ``stats["seconds"]`` the pipeline returns, over the window's samples;
None where the program has no such span."""

from portbench.readers import phase_mean


def read(run):
    return phase_mean(run, "index.upload")
