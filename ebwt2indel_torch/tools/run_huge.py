#!/usr/bin/env python3
"""Mode 1 of the port at scale: a cold and a warm run in one process, and a
report with the keys of the JAX package's ``REPORT_*.json`` plus the device
it ran on (the port's copy of the repo-root ``tools/run_huge.py``).

    python -m ebwt2indel_torch.tools.run_huge IN.ebwt OUT.snp [REPORT.json]
        [--skip-ref] [--device cuda|cpu]

The first run pays the kernel build and the warm-up, the second is the
steady-state number. The report adds the device, the second run's seconds
by phase (``phase_seconds``) and, on a card, the peak device memory of the
two runs (``peak_bytes``, ``torch.cuda.max_memory_allocated``; null on the
CPU). Where ``.ref_build/ebwt2InDel`` exists (the compiled
reference), it then runs ``-1 IN -o OUT.snp.ref`` and byte-compares, which
fills ``parity``, ``ref_seconds`` and ``vs_baseline``. Without it, or with
``--skip-ref``, those stay null. Exit code 1 means the outputs differ.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
REF_BIN = os.path.join(REPO, ".ref_build", "ebwt2InDel")


def _same_bytes(a: str, b: str) -> bool:
    """Chunked compare: a .snp at this scale is gigabytes."""
    if os.path.getsize(a) != os.path.getsize(b):
        return False
    with open(a, "rb") as fa, open(b, "rb") as fb:
        while True:
            x, y = fa.read(1 << 24), fb.read(1 << 24)
            if x != y:
                return False
            if not x:
                return True


def _device_line(dev) -> dict:
    import torch

    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": torch.cuda.device_count()}
    return {"platform": "cpu", "kind": "cpu", "count": 1}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("report", nargs="?")
    ap.add_argument("--skip-ref", action="store_true",
                    help="do not run the reference binary")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from .. import device as device_mod
    from ..models import pipeline
    from ..utils.config import Config

    dev = device_mod.resolve(args.device)
    n = os.path.getsize(args.input)
    cfg = Config(input1=args.input, output=args.output)
    state = {
        "metric": "mode1 end-to-end BWT positions/sec/chip",
        "value": None, "unit": "pos/s", "positions": n,
        "warm_seconds": None, "cold_seconds": None, "ref_seconds": None,
        "parity": None, "vs_baseline": None, "device": _device_line(dev),
        "phase_seconds": None, "peak_bytes": None,
    }

    def emit():
        best = state["warm_seconds"] or state["cold_seconds"]
        if best:
            state["value"] = n / best
        if state["parity"] and best:
            state["vs_baseline"] = state["ref_seconds"] / best
        if args.report:
            with open(args.report, "w") as f:
                json.dump(state, f)
                f.write("\n")

    if dev.type == "cuda":
        import torch

        torch.cuda.reset_peak_memory_stats(dev)
    for key in ("cold_seconds", "warm_seconds"):
        t0 = time.perf_counter()
        st = pipeline.run_one_dataset(cfg, device=dev)
        state[key] = time.perf_counter() - t0
        state["phase_seconds"] = st["seconds"]
        if dev.type == "cuda":
            state["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        print(f"[run_huge] {key.split('_')[0]} end-to-end {state[key]:.3f} s "
              f"({n / state[key] / 1e6:.3f} Mpos/s)", flush=True)
        emit()

    if args.skip_ref or not os.path.isfile(REF_BIN):
        print("[run_huge] reference leg skipped: "
              + ("--skip-ref" if args.skip_ref else f"no {REF_BIN}"))
        return 0
    ref_out = args.output + ".ref"
    t0 = time.perf_counter()
    subprocess.run([REF_BIN, "-1", args.input, "-o", ref_out], check=True,
                   stdout=subprocess.DEVNULL)
    state["ref_seconds"] = time.perf_counter() - t0
    state["parity"] = _same_bytes(args.output, ref_out)
    print(f"[run_huge] reference {state['ref_seconds']:.3f} s; parity "
          f"{'BYTE-IDENTICAL' if state['parity'] else 'MISMATCH'}",
          flush=True)
    emit()
    return 0 if state["parity"] else 1


if __name__ == "__main__":
    sys.exit(main())
