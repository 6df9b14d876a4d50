"""Seconds of the pipeline's ``leaf_phase`` phase per sample, from the
``stats["seconds"]`` the pipeline returns, over the window's samples."""

from portbench.readers import phase_mean


def read(run):
    return phase_mean(run, "leaf_phase")
