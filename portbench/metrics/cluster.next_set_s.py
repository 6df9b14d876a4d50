"""Device seconds of the anchor table's build in the cluster phase (the
span ``cluster.next_set``, timed by CUDA events around the next-set
kernel) per sample, from the ``stats["seconds"]`` the pipeline returns,
over the window's samples; None where the program has no such span."""

from portbench.readers import phase_mean


def read(run):
    return phase_mean(run, "cluster.next_set")
