"""The control of the comparison that decides ``correct``: the plain
reference put in the program's place with one guarantee of the
configurations broken (clusters not split at LCP minima), judged by the
harness's own comparison against the sound reference.

    python3 portbench/control.py --workload <name> --seeds <n> [<n> ...]

prints, per seed, the numbers the harness compares (``samples_wrong`` and
``records_wrong`` of one sample), which must exceed their limit of 0. The
benchmark's runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench import gen, harness, manifest  # noqa: E402
from portbench.reference import calls  # noqa: E402


def readings(cell: manifest.Cell, seed: int, device,
             recipe_overrides: dict | None = None) -> dict:
    """The compared numbers of the control on one seed of ``cell``."""
    recipe = {**cell.config, **(recipe_overrides or {})}
    reads1, reads2 = gen.make_reads(recipe, seed, device)
    argv = [a.format(**{k: k for k in cell.inputs}, out="out")
            for a in cell.traffic["argv"]]
    p = calls.Params.from_argv(argv)
    mode = int(cell.traffic["mode"])
    want = calls.snp_bytes(reads1, reads2, mode, p)
    got = calls.snp_bytes(reads1, reads2, mode, p, split_at_minima=False)
    wrong = harness.records_wrong(got, want)
    return {"samples_wrong": int(wrong > 0), "records_wrong": wrong,
            "records": len(harness.records(want))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("[control] needs a CUDA device", file=sys.stderr)
        return 2
    cell = manifest.cell(ROOT, args.workload)
    for seed in args.seeds:
        t = time.perf_counter()
        r = readings(cell, seed, "cuda")
        r.update(workload=args.workload, seed=seed,
                 seconds=time.perf_counter() - t)
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
