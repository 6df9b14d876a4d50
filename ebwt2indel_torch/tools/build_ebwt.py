"""build_ebwt — construct .ebwt (and optionally merged .ebwt + DA) files from
read fastas. The port's copy of ``ebwt2indel_tpu/tools/build_ebwt.py``.

The reference delegates BWT construction to external tools (BCR_LCP_GSA etc.,
README.md:38); this CLI makes the framework self-contained.

Usage:
  ebwt2indel-torch-build-ebwt reads.fasta out.ebwt
  ebwt2indel-torch-build-ebwt reads1.fasta reads2.fasta out.ebwt out.da   # merged
"""

from __future__ import annotations

import sys

from . import ebwt


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) == 2:
        reads = ebwt.read_fasta(argv[0])
        with open(argv[1], "w") as f:
            f.write(ebwt.ebwt_of_reads(reads))
        print(f"wrote eBWT of {len(reads)} reads to {argv[1]}")
        return 0
    if len(argv) == 4:
        r1 = ebwt.read_fasta(argv[0])
        r2 = ebwt.read_fasta(argv[1])
        bwt, da = ebwt.ebwt_and_da_of_two(r1, r2)
        with open(argv[2], "w") as f:
            f.write(bwt)
        with open(argv[3], "w") as f:
            f.write(da)
        print(f"wrote merged eBWT ({len(r1)}+{len(r2)} reads) to {argv[2]} "
              f"and DA to {argv[3]}")
        return 0
    print(__doc__)
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
