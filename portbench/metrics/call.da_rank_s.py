"""Device seconds of the document array's rank in calling, modes 2 and 3
(the span ``call_emit.da_rank``, timed by CUDA events) per sample, from
the ``stats["seconds"]`` the pipeline returns, over the window's samples;
None where the program has no such span."""

from portbench.readers import phase_mean


def read(run):
    return phase_mean(run, "call_emit.da_rank")
