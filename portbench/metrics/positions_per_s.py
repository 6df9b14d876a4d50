"""BWT positions of the samples the window completed (modes 2 and 3:
n1 + n2), over the seconds from its start to the end of its last sample."""


def read(run):
    w = run["window"]
    return w["positions"] / w["seconds"] if w["samples"] else None
