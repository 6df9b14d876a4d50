"""Seconds of the pipeline's ``index`` phase per sample, from the
``stats["seconds"]`` the pipeline returns, over the window's samples."""

from portbench.readers import phase_mean


def read(run):
    return phase_mean(run, "index")
