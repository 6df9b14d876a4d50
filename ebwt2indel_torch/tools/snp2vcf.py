"""snp2vcf — align .snp calls against a reference genome and emit a VCF.
The port's copy of ``ebwt2indel_tpu/tools/snp2vcf.py``.

Pipeline driver equivalent of the reference shell script (snp2vcf.sh):
seqtk fasta->fastq conversion, bwa index + bwa mem alignment, then sam2vcf.
The fasta->fastq step (seqtk seq -F 'h') is implemented natively; bwa is
invoked if present on PATH (external aligners are out of framework scope,
exactly as in the reference pipeline).
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

from . import sam2vcf


def snp_to_fastq(snp_path: str, fastq_path: str, qual: str = "h") -> None:
    """seqtk seq -F 'h' equivalent: 2-line fasta records -> 4-line fastq with
    constant quality."""
    with open(snp_path) as f, open(fastq_path, "w") as out:
        header = None
        for line in f:
            line = line.rstrip("\n")
            if line.startswith(">"):
                header = line[1:]
            elif header is not None:
                out.write(f"@{header}\n{line}\n+\n{qual * len(line)}\n")
                header = None


def run(calls: str, ref: str, out_vcf: str, log=print) -> int:
    log(f"input calls: {calls}")
    log(f"input reference: {ref}")
    log(f"output: {out_vcf}")
    bwa = shutil.which("bwa")
    if bwa is None:
        log("Error: bwa not found on PATH (required for alignment, as in the "
            "reference snp2vcf.sh pipeline)")
        return 1
    fastq = out_vcf + ".fastq"
    sam = out_vcf + ".sam"
    snp_to_fastq(calls, fastq)
    if not os.path.isfile(ref + ".bwt"):
        subprocess.run([bwa, "index", ref], check=True)
    subprocess.run([bwa, "mem", ref, fastq, "-o", sam], check=True)
    os.remove(fastq)
    sam2vcf.convert(ref, sam, out_vcf, log=log)
    os.remove(sam)
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 3:
        print("usage: snp2vcf calls.snp ref.fasta output.vcf")
        return 1
    return run(argv[0], argv[1], argv[2])


if __name__ == "__main__":
    raise SystemExit(main())
