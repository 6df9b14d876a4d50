"""Run one cell of the benchmark of ``ebwt2indel_torch`` once:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The last line on standard output is the
result's JSON object; the numbers that decide ``correct`` are the last
lines on standard error. It exits with 2, printing no result, without as
many CUDA devices as the cell asks for or without the program beside it,
and with 3 if JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from portbench import harness, manifest

    harness.prepare_environment(ROOT)
    cell = manifest.cell(ROOT, args.workload)
    if not (ROOT / "ebwt2indel_torch" / "__init__.py").is_file():
        print("[portbench] the program ebwt2indel_torch is not in this "
              "checkout", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"[portbench] {args.workload} needs {cell.chips} CUDA "
              f"device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}", file=sys.stderr)
        return 2
    return harness.run(cell, args.seed, args.seconds, bool(args.trace),
                       "cuda", T0)


if __name__ == "__main__":
    sys.exit(main())
