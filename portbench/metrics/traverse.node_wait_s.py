"""Seconds the host waited on the device inside the node steps (the
span ``node_phase.wait``, summed over the steps) per sample, from
the ``stats["seconds"]`` the pipeline returns, over the window's samples;
None where the program has no such span."""

from portbench.readers import phase_mean


def read(run):
    return phase_mean(run, "node_phase.wait")
