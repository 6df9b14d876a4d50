"""Summarize a ``torch.profiler`` Chrome trace of the port: the top kernels
by summed device time, and device time by phase (counterpart of the
repo-root ``tools/tracetop.py``, which reads ``jax.profiler`` traces).

    python -m ebwt2indel_torch.tools.tracetop TRACE [TOP_N]

TRACE is a ``*.pt.trace.json`` (or ``.json.gz``) that ``EBWT_PROFILE=<dir>``
writes (``utils/profile.py``), or that directory, whose newest trace is
read. Device events are the kernels, copies and sets of the GPU tracks;
a trace without any (a CPU run) falls back to every event, as the JAX
package's copy does, and then nested host events count again inside their
callers. A phase is a ``record_function`` mark (``index``, ``leaf_phase``,
``node_phase``, ``cluster``, ``call_emit``), read from its host
annotation. A device event counts in the phase during which the host
launched it, at the start of the runtime call with the same
``correlation`` id, or at its own start where the trace links none. Each
phase of a run ends with a device synchronise, so its
events are its own. (Device starts are not compared with host spans: in
the mode-3 and mode-2 traces of one ``chip_smoke.py`` run, PyTorch 2.11 on
an NVIDIA H100 80GB HBM3 at 700.00 W placed the cluster phase's 341 ms
scan inside the node phase's host span, and its GPU user annotations left
out ``index``.) A phase's ``busy_ms`` sums its counted events (device time
on a device trace), its ``span_ms`` is its own length, the phase's wall.
"""

from __future__ import annotations

import argparse
import bisect
import gzip
import itertools
import json
import os
import sys
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
ANNOTATION_CATS = ("gpu_user_annotation", "user_annotation")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


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


def summarize(events: list, top_n: int = 25) -> dict:
    """``kernels``: [(name, total_ms, count)] of the top_n names by summed
    duration; ``phases``: {name: {"busy_ms", "span_ms", "count"}};
    ``busy_ms``: the summed duration of every counted event; ``device``:
    whether those are device events; ``linked``: how many of them are
    placed by their launch."""
    spans = [e for e in events if e.get("ph") == "X"]
    timed = [e for e in spans if e.get("cat") in DEVICE_CATS]
    device = bool(timed)
    if not device:
        timed = [e for e in spans if e.get("cat") not in ANNOTATION_CATS]
    tot, cnt = defaultdict(float), defaultdict(int)
    for e in timed:
        tot[e.get("name", "?")] += float(e.get("dur", 0.0))
        cnt[e.get("name", "?")] += 1
    kernels = [(name, us / 1e3, cnt[name]) for name, us in
               sorted(tot.items(), key=lambda kv: -kv[1])[:top_n]]

    marks = [e for e in spans if e.get("cat") == "user_annotation"]
    launched = {e["args"]["correlation"]: float(e["ts"]) for e in spans
                if e.get("cat") in LAUNCH_CATS and
                "correlation" in e.get("args", {})} if device else {}
    corr = [e.get("args", {}).get("correlation") for e in timed]
    starts = sorted((launched.get(c, float(e["ts"])),
                     float(e.get("dur", 0.0))) for c, e in zip(corr, timed))
    ts = [t for t, _ in starts]
    cum = list(itertools.accumulate((d for _, d in starts), initial=0.0))
    phases: dict = {}
    for m in marks:
        lo = float(m["ts"])
        hi = lo + float(m.get("dur", 0.0))
        p = phases.setdefault(m["name"], {"busy_ms": 0.0, "span_ms": 0.0,
                                          "count": 0})
        inside = cum[bisect.bisect_left(ts, hi)] - \
            cum[bisect.bisect_left(ts, lo)]
        p["busy_ms"] += inside / 1e3
        p["span_ms"] += (hi - lo) / 1e3
        p["count"] += 1
    return {"kernels": kernels, "phases": phases, "device": device,
            "busy_ms": sum(tot.values()) / 1e3,
            "linked": sum(c in launched for c in corr)}


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
    print(f"[sum of {what} event time: {r['busy_ms']:.3f} ms; "
          f"{r['linked']} events placed in phases by their launch]")
    print(f"{'busy_ms':>10}  {'span_ms':>10}  phase")
    for name, p in r["phases"].items():
        print(f"{p['busy_ms']:10.3f}  {p['span_ms']:10.3f}  {name}"
              + (f" (x{p['count']})" if p["count"] > 1 else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
