"""Reduction of a ``torch.profiler`` Chrome trace to the device's busy time,
its idle gaps and its time by operation.

The interval arithmetic follows ``ebwt2indel_torch/tools/tracetop.py`` at
commit 53c2062 (device events are the kernels, copies and sets of the GPU
tracks; phases are ``record_function`` marks), with one change: busy time
is the length of the union of the device intervals, never the sum of their
durations, so work that overlaps (mode 3's DA-side worker) counts once.

The window is the span of the ``SAMPLE`` marks the harness puts around each
traced sample. An idle gap is named by what the host was doing in it: the
innermost (the shortest) of the program's spans (every ``record_function``
mark but ``SAMPLE``: ``index``, ``index.pack``, ``node_phase.wait``, ...)
that holds the gap's middle, as ``tracetop.py`` names it, else
``OUTSIDE``.
"""

from __future__ import annotations

import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SAMPLE = "portbench.sample"
OUTSIDE = "(no span)"
TOP = 10


def load_events(path: str) -> list:
    with open(path) as f:
        data = json.load(f)
    return data.get("traceEvents", []) if isinstance(data, dict) else data


def union(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out: list[list[float]] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(lo, hi) for lo, hi in out]


def gaps(busy: list[tuple[float, float]], lo: float,
         hi: float) -> list[tuple[float, float]]:
    """The parts of [lo, hi] that no interval of ``busy`` (sorted, disjoint)
    covers."""
    out, at = [], lo
    for a, b in busy:
        if a > at:
            out.append((at, min(a, hi)))
        at = max(at, b)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(a, b) for a, b in out if b > a]


def innermost(spans: list, times: list) -> list:
    """For each of ``times``, the shortest of ``spans`` ((start, end,
    name)) that holds it, or None: one sweep over both in time order
    (``tracetop.py``'s)."""
    spans = sorted(spans)
    out: list = [None] * len(times)
    active, i = [], 0
    for k in sorted(range(len(times)), key=times.__getitem__):
        t = times[k]
        while i < len(spans) and spans[i][0] <= t:
            active.append(spans[i])
            i += 1
        active = [s for s in active if s[1] >= t]
        if active:
            out[k] = min(active, key=lambda s: s[1] - s[0])
    return out


def summarize(events: list, kernels: tuple[str, ...] = ()) -> dict | None:
    """Times in seconds over the traced window: ``window_s``, ``busy_s``
    (the union of device intervals inside it), ``device_ops`` and
    ``idle_gaps`` (the breakdown's lists), ``idle_by_span`` and
    ``kernel_s`` (summed device time of events whose name holds each of
    ``kernels``). None when the trace has no sample mark."""
    spans = [e for e in events if e.get("ph") == "X"]
    marks = [e for e in spans if e.get("cat") == "user_annotation"]
    samples = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
               for e in marks if e.get("name") == SAMPLE]
    if not samples:
        return None
    lo = min(a for a, _ in samples)
    hi = max(b for _, b in samples)

    per_op: dict[str, float] = defaultdict(float)
    kernel_us = {k: 0.0 for k in kernels}
    device = []
    for e in spans:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a = float(e["ts"])
        b = a + float(e.get("dur", 0))
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        name = e.get("name", "?")
        per_op[name] += b - a
        for k in kernels:
            if k in name:
                kernel_us[k] += b - a
        device.append((a, b))
    busy = union(device)

    program_spans = [
        (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"])
        for e in marks if e.get("name") != SAMPLE]
    idle = gaps(busy, lo, hi)
    held = innermost(program_spans, [(a + b) / 2 for a, b in idle])
    named = []
    idle_by_span: dict[str, float] = defaultdict(float)
    for (a, b), span in zip(idle, held):
        name = span[2] if span else OUTSIDE
        named.append((name, (b - a) / 1e6))
        idle_by_span[name] += (b - a) / 1e6

    ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "window_s": (hi - lo) / 1e6,
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "samples": len(samples),
        "device_events": len(device),
        "device_ops": [[name, us / 1e6] for name, us in ops],
        "idle_gaps": [[name, s] for name, s in
                      sorted(named, key=lambda x: -x[1])[:TOP]],
        "idle_by_span": dict(idle_by_span),
        "kernel_s": {k: us / 1e6 for k, us in kernel_us.items()},
    }
