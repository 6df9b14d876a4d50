"""Seconds of mode 3's DA-side worker, which reads the document array
and packs and uploads the DA = 1 side's index beside phases 1-3 (the
span ``index.da_side``) per sample, from
the ``stats["seconds"]`` the pipeline returns, over the window's samples;
None where the program has no such span."""

from portbench.readers import phase_mean


def read(run):
    return phase_mean(run, "index.da_side")
