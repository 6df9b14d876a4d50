"""filter_snp — keep .snp records with coverage in [m, M] (M=0: no max).
The port's copy of ``ebwt2indel_tpu/tools/filter_snp.py``.

Behavioral equivalent of the reference tool (filter_snp.cpp:16-81): records
are (header, sequence) line pairs by line parity; coverage is parsed from the
4th '_'-separated header token as the 2nd ':'-token; output goes to stdout.
Filters individual records, not pairs.
"""

from __future__ import annotations

import sys


def _atoi(s: str) -> int:
    """C atoi: leading int prefix, 0 on failure."""
    s = s.strip()
    out = ""
    for i, ch in enumerate(s):
        if ch.isdigit() or (i == 0 and ch in "+-"):
            out += ch
        else:
            break
    try:
        return int(out)
    except ValueError:
        return 0


def parse_cov(header: str) -> int:
    parts = header.split("_")
    if len(parts) < 4:
        return 0
    tok = parts[3]  # "cov:<value>"
    sub = tok.split(":")
    return _atoi(sub[1]) if len(sub) >= 2 else 0


def filter_stream(lines, m: int, M: int, out):
    header = ""
    cov = 0
    for idx, line in enumerate(lines):
        line = line.rstrip("\n")
        if idx % 2 == 0:
            header = line
            cov = parse_cov(line)
        else:
            if cov >= m and (M == 0 or cov <= M):
                out.write(header + "\n" + line + "\n")
            header = ""
            cov = 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) not in (2, 3):
        print("filter_snp calls.snp m [M]\n\nInput: a .snp file. Keep only "
              "reads with at least coverage m and at most M. Output to "
              "stdout.")
        return 0
    m = _atoi(argv[1])
    M = _atoi(argv[2]) if len(argv) == 3 else 0
    with open(argv[0]) as f:
        filter_stream(f, m, M, sys.stdout)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
