"""Seconds of the emission's alignments of left contexts (the span
``call_emit.align``, inside ``call_emit.write``) per sample, from
the ``stats["seconds"]`` the pipeline returns, over the window's samples;
None where the program has no such span."""

from portbench.readers import phase_mean


def read(run):
    return phase_mean(run, "call_emit.align")
