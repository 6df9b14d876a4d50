"""Seconds of the calling walks through their last device-to-host copy
(the span ``call_emit.walks``) per sample, from
the ``stats["seconds"]`` the pipeline returns, over the window's samples;
None where the program has no such span."""

from portbench.readers import phase_mean


def read(run):
    return phase_mean(run, "call_emit.walks")
