"""sort_vcf — header-preserving sort of a VCF by (chrom, pos). The port's
copy of ``ebwt2indel_tpu/tools/sort_vcf.py``.

Equivalent of the reference one-liner (sort_vcf.sh: awk | sort -k1,1 -k2,2n).
Reads a VCF on stdin or as argv[1], writes to stdout.
"""

from __future__ import annotations

import sys

from .filter_snp import _atoi


def sort_vcf_lines(lines):
    header = []
    body = []
    for line in lines:
        line = line.rstrip("\n")
        if line.startswith("#"):
            header.append(line)
        else:
            body.append(line)
    body.sort(key=lambda ln: (ln.split("\t")[0],
                              _atoi(ln.split("\t")[1])
                              if len(ln.split("\t")) > 1 else 0))
    return header + body


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    src = open(argv[0]) if argv else sys.stdin
    for line in sort_vcf_lines(src):
        print(line)
    if argv:
        src.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
