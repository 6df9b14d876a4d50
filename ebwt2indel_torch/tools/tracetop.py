"""Summarize a ``torch.profiler`` Chrome trace of the port: the top kernels
by summed device time, device time by span, the device's idle gaps named
by span, and a check that the host's and the device's clocks agree
(counterpart of the repo-root ``tools/tracetop.py``, which reads
``jax.profiler`` traces).

    python -m ebwt2indel_torch.tools.tracetop TRACE [TOP_N]

TRACE is a ``*.pt.trace.json`` (or ``.json.gz``) that ``EBWT_PROFILE=<dir>``
writes (``utils/profile.py``), or that directory, whose newest trace is
read. Device events are the kernels, copies and sets of the GPU tracks;
a trace without any (a CPU run) falls back to every host event, as the JAX
package's copy does.

A span is any host annotation (``record_function``) in the trace: the
program's spans (``index``, ``index.pack``, ``node_phase.wait``, ...;
``utils/profile.py``) are its only ones. A device event is placed at the
start of the runtime call that launched it (the same ``correlation`` id),
or at its own start where the trace links none, and counts in every span
that holds that point. Busy time is the length of the union of the counted
events' intervals, never the sum of their durations, so work that overlaps
counts once; a span's ``busy_ms`` is that union over its own events, its
``span_ms`` its length. The window runs from the first span's start to the
last span's end (the device events' where there is no span); an idle gap
is a stretch of it that no device event covers, named by the innermost
span (the shortest) that holds its middle.

The clock check counts the device events that start before the span that
holds their launch starts, and those that start before their launch call
itself: on one clock both are 0, since a launch precedes its work.
"""

from __future__ import annotations

import argparse
import bisect
import gzip
import json
import os
import sys
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
ANNOTATION_CATS = ("gpu_user_annotation", "user_annotation")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
OUTSIDE = "(no span)"


def newest_trace(path: str) -> str:
    """``path`` itself, or the newest trace file in the directory
    ``path``."""
    if not os.path.isdir(path):
        return path
    found = [os.path.join(path, f) for f in os.listdir(path)
             if f.endswith((".json", ".json.gz"))]
    if not found:
        raise FileNotFoundError(f"no trace (*.json, *.json.gz) in {path}")
    return max(found, key=os.path.getmtime)


def load_events(path: str) -> list:
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rt") as f:
        data = json.load(f)
    return data.get("traceEvents", []) if isinstance(data, dict) else data


def union_length(intervals) -> float:
    """The length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for lo, hi in sorted(intervals):
        if hi > end:
            total += hi - max(lo, end)
            end = hi
    return total


def idle_gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, at = [], lo
    for a, b in sorted(intervals):
        if a > at:
            out.append((at, min(a, hi)))
        at = max(at, b)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(a, b) for a, b in out if b > a]


def innermost(spans: list, times: list) -> list:
    """For each of ``times``, the shortest of ``spans`` ((start, end, name))
    that holds it, or None: one sweep over both in time order."""
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


def summarize(events: list, top_n: int = 25) -> dict:
    """``kernels``: [(name, total_ms, count)] of the top_n names by summed
    duration; ``device``: whether the counted events are device events;
    ``busy_ms``: the union of their intervals; ``window_ms`` and
    ``idle_ms``; ``linked``: how many are placed by their launch;
    ``phases``: {span name: {"busy_ms", "span_ms", "count"}};
    ``gaps``: [(span name, ms)] of the top_n longest idle gaps;
    ``idle_by_span``: {span name: ms}; ``clock``: the check's counts
    (``linked``, ``before_span``, ``before_launch``) and the largest leads
    before the span, ``lead_ms``, and before the launch,
    ``launch_lead_ms``."""
    xs = [e for e in events if e.get("ph") == "X"]
    timed = [e for e in xs if e.get("cat") in DEVICE_CATS]
    device = bool(timed)
    if not device:
        timed = [e for e in xs if e.get("cat") not in ANNOTATION_CATS]
    tot, cnt = defaultdict(float), defaultdict(int)
    for e in timed:
        tot[e.get("name", "?")] += float(e.get("dur", 0.0))
        cnt[e.get("name", "?")] += 1
    kernels = [(name, us / 1e3, cnt[name]) for name, us in
               sorted(tot.items(), key=lambda kv: -kv[1])[:top_n]]
    ivals = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
             for e in timed]

    spans = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
              e["name"]) for e in xs if e.get("cat") == "user_annotation"]
    launched = {e["args"]["correlation"]: float(e["ts"]) for e in xs
                if e.get("cat") in LAUNCH_CATS and
                "correlation" in e.get("args", {})} if device else {}
    corr = [e.get("args", {}).get("correlation") for e in timed]
    placed = sorted((launched.get(c, a), (a, b))
                    for c, (a, b) in zip(corr, ivals))
    at = [t for t, _ in placed]
    phases: dict = {}
    for lo, hi, name in spans:
        p = phases.setdefault(name, {"busy_ms": 0.0, "span_ms": 0.0,
                                     "count": 0})
        inside = placed[bisect.bisect_left(at, lo):
                        bisect.bisect_right(at, hi)]
        p["busy_ms"] += union_length(iv for _, iv in inside) / 1e3
        p["span_ms"] += (hi - lo) / 1e3
        p["count"] += 1

    if spans:
        w_lo, w_hi = min(s[0] for s in spans), max(s[1] for s in spans)
    elif ivals:
        w_lo, w_hi = min(a for a, _ in ivals), max(b for _, b in ivals)
    else:
        w_lo = w_hi = 0.0
    clipped = [(max(a, w_lo), min(b, w_hi)) for a, b in ivals]
    busy_window = union_length((a, b) for a, b in clipped if b > a)
    gaps, idle_by_span = [], defaultdict(float)
    clock = {"linked": 0, "before_span": 0, "before_launch": 0,
             "lead_ms": 0.0, "launch_lead_ms": 0.0}
    if device:
        found = idle_gaps(clipped, w_lo, w_hi)
        held = innermost(spans, [(a + b) / 2 for a, b in found])
        for (a, b), s in zip(found, held):
            name = s[2] if s else OUTSIDE
            gaps.append((name, (b - a) / 1e3))
            idle_by_span[name] += (b - a) / 1e3
        gaps.sort(key=lambda g: -g[1])
        pairs = [(launched[c], a) for c, (a, _) in zip(corr, ivals)
                 if c in launched]
        held = innermost(spans, [t for t, _ in pairs])
        clock["linked"] = len(pairs)
        for (t, a), s in zip(pairs, held):
            if a < t:
                clock["before_launch"] += 1
                clock["launch_lead_ms"] = max(clock["launch_lead_ms"],
                                              (t - a) / 1e3)
            if s is not None and a < s[0]:
                clock["before_span"] += 1
                clock["lead_ms"] = max(clock["lead_ms"], (s[0] - a) / 1e3)
    return {"kernels": kernels, "phases": phases, "device": device,
            "busy_ms": union_length(ivals) / 1e3,
            "window_ms": (w_hi - w_lo) / 1e3,
            "idle_ms": ((w_hi - w_lo) - busy_window) / 1e3 if device
            else 0.0,
            "linked": sum(c in launched for c in corr),
            "gaps": gaps[:top_n], "idle_by_span": dict(idle_by_span),
            "clock": clock}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace", help="a trace file, or EBWT_PROFILE's directory")
    ap.add_argument("top_n", nargs="?", type=int, default=25)
    args = ap.parse_args(argv)
    path = newest_trace(args.trace)
    r = summarize(load_events(path), args.top_n)
    what = "device" if r["device"] else "host (no device track)"
    print(f"{path}: {what} events")
    print(f"{'total_ms':>10}  {'count':>7}  {'avg_us':>8}  name")
    for name, ms, n in r["kernels"]:
        print(f"{ms:10.3f}  {n:7d}  {ms * 1e3 / n:8.1f}  {name[:110]}")
    print(f"[union of {what} event time: {r['busy_ms']:.3f} ms; "
          f"{r['linked']} events placed in spans by their launch]")
    print(f"{'busy_ms':>10}  {'span_ms':>10}  span")
    for name, p in sorted(r["phases"].items()):
        print(f"{p['busy_ms']:10.3f}  {p['span_ms']:10.3f}  {name}"
              + (f" (x{p['count']})" if p["count"] > 1 else ""))
    if not r["device"]:
        return 0
    print(f"[device idle {r['idle_ms']:.3f} ms of a {r['window_ms']:.3f} ms "
          "window]")
    print(f"{'idle_ms':>10}  span holding the idle gap")
    for name, ms in sorted(r["idle_by_span"].items(), key=lambda kv: -kv[1]):
        print(f"{ms:10.3f}  {name}")
    print(f"{'gap_ms':>10}  longest idle gaps")
    for name, ms in r["gaps"]:
        print(f"{ms:10.3f}  {name}")
    c = r["clock"]
    print(f"[clock] of {c['linked']} device events linked to a launch, "
          f"{c['before_span']} start before the span holding their launch "
          f"(largest lead {c['lead_ms']:.3f} ms) and {c['before_launch']} "
          f"before the launch call (largest lead "
          f"{c['launch_lead_ms']:.3f} ms)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
