"""Launches of the rank kernel per sample (``ops/rank_cuda.py``'s
``LAUNCHES["rank_decode"]``), over the window's samples."""


def read(run):
    s = run["samples"]
    return sum(x["launches"] for x in s) / len(s) if s else None
