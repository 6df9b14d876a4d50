"""snp_vs_vcf — alignment-free validation of a KisSNP2 .snp file against a
ground-truth VCF plus reference fasta. The port's copy of
``ebwt2indel_tpu/tools/snp_vs_vcf.py``.

Behavioral equivalent of the reference scorer (snp_vs_vcf.cpp; note the
reference repo does not even build this target, CMakeLists.txt:24-27). For
every VCF SNP it builds forward and reverse-complement context records
(cpp:237-281), marks non-isolated SNPs closer than k (cpp:302-318), sorts by
right context, and prefix-matches every mismatch column of every read pair
whose header starts with '>SNP' — the KisSNP2/ebwt2snp-v1 header, not the
'>cluster:' header ebwt2InDel emits (cpp:371).
"""

from __future__ import annotations

import bisect
import dataclasses
import getopt
import sys

from .filter_snp import _atoi
from .sam2vcf import load_fasta

K_NONIS_DEF = 31
RLENGTH_DEF = 100

_COMP = {"A": "T", "C": "G", "G": "C", "T": "A"}


def _rc_char(c: str) -> str:
    return _COMP.get(c, c)


def _rc(s: str) -> str:
    return "".join(_rc_char(c) for c in reversed(s))


def _rev(s: str) -> str:
    return s[::-1]


@dataclasses.dataclass
class Call:
    right_context: str
    left_context: str
    REF: str
    ALT: str
    ID: int
    isolated: bool
    pos: int = 0


def load_vcf_calls(vcf_path: str, ref: dict[str, str], rlength: int,
                   log=print):
    calls: list[Call] = []
    n_snps = 0
    ID = 0
    with open(vcf_path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line or line[0] == "#":
                continue
            parts = line.split()
            if len(parts) < 5:
                continue
            chrom, pos_s, _id, REF, ALT = parts[:5]
            pos = _atoi(pos_s) - 1  # vcf is 1-based
            if REF in "ACGT" and len(REF) == 1 and ALT in "ACGT" and \
                    len(ALT) == 1:
                contig = ref.get(chrom, "")
                if contig:
                    n_snps += 1
                    if pos >= len(contig):
                        log(f"WARNING: position {pos} larger than chromosome "
                            f"{chrom}'s length {len(contig)}")
                    if pos >= rlength and pos + rlength < len(contig):
                        right = contig[pos + 1 : pos + 1 + rlength]
                        left = _rev(contig[pos - rlength : pos])
                        calls.append(Call(right, left, REF, ALT, ID, True, pos))
                        left2 = _rev(_rc(contig[pos + 1 : pos + 1 + rlength]))
                        right2 = _rc(contig[pos - rlength : pos])
                        calls.append(Call(right2, left2, _rc_char(REF),
                                          _rc_char(ALT), ID, True, pos))
                    ID += 1
                else:
                    log(f"WARNING: chromosome {chrom} not found. ")
    if not calls:
        log("WARNING: no variants found. Check that chromosome names are the "
            "same in the fasta and vcf files. ")
    # non-isolated marking (cpp:302-318)
    nonisolated = 0
    i = 2
    while len(calls) > 1 and i < len(calls) - 2:
        if i % 2 == 0:
            iso = (calls[i].pos - calls[i - 2].pos >= load_vcf_calls.k_nonis
                   and calls[i + 2].pos - calls[i].pos >=
                   load_vcf_calls.k_nonis)
            calls[i].isolated = iso
            calls[i + 1].isolated = iso
            if not iso:
                nonisolated += 1
        i += 1
    calls.sort(key=lambda c: c.right_context)
    return calls, n_snps, nonisolated


load_vcf_calls.k_nonis = K_NONIS_DEF  # bound at runtime by main()


def _match_contexts(calls_vcf, keys, right, left, REF, ALT, assigned) -> bool:
    found = False
    idx = bisect.bisect_left(keys, right)
    while idx < len(calls_vcf) and \
            calls_vcf[idx].right_context.startswith(right):
        cv = calls_vcf[idx]
        if ((cv.ALT == ALT and cv.REF == REF) or
                (cv.ALT == REF and cv.REF == ALT)) and \
                cv.left_context.startswith(left):
            found = True
            assigned[idx] = 1
        idx += 1
    return found


def validate(calls_path: str, calls_vcf: list[Call], n_snps: int, N: int,
             log=print) -> dict:
    keys = [c.right_context for c in calls_vcf]
    assigned = [0] * len(calls_vcf)
    FP = 0
    n_calls = 0

    with open(calls_path) as f:
        lines = [ln.rstrip("\n") for ln in f]
    i = 0
    while i < len(lines):
        h1 = lines[i]
        first = h1.split("|")[0]
        if first[:4] == ">SNP":
            if i + 3 >= len(lines):
                break
            DNA1 = lines[i + 1]
            DNA2 = lines[i + 3]
            if len(DNA1) != len(DNA2):
                log("Error: malformed SNP file. Two reads with different "
                    "length in a SNP:")
                log(h1 + "\n" + DNA1 + "\n" + lines[i + 2] + "\n" + DNA2)
                raise SystemExit(1)
            # scan all SNP columns right-to-left (ipos counts from the right)
            for ipos in range(len(DNA1)):
                a = DNA1[len(DNA1) - ipos - 1]
                b = DNA2[len(DNA2) - ipos - 1]
                if a != b:
                    n_calls += 1
                    r1 = DNA1[len(DNA1) - ipos:]
                    r2 = DNA2[len(DNA2) - ipos:]
                    l1 = _rev(DNA1[: len(DNA1) - ipos - 1])
                    l2 = _rev(DNA2[: len(DNA2) - ipos - 1])
                    found = _match_contexts(calls_vcf, keys, r1, l1, a, b,
                                            assigned)
                    if not found:
                        found = _match_contexts(calls_vcf, keys, r2, l2, a, b,
                                                assigned)
                    if not found:
                        FP += 1
            i += 4
        else:
            i += 4

    found_ids = {calls_vcf[i].ID for i in range(len(calls_vcf))
                 if assigned[i]}
    found_nonisolated = {calls_vcf[i].ID for i in range(len(calls_vcf))
                         if assigned[i] and not calls_vcf[i].isolated}
    TP = len(found_ids)
    FN = n_snps - TP
    TN = (N - n_calls) - FN
    return dict(TP=TP, TN=TN, FP=FP, FN=FN, n_calls=n_calls,
                found_nonisolated=len(found_nonisolated))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    usage = (
        "snp_vs_vcf [options]\n"
        "Options:\n"
        "-h          Print this help\n"
        "-v <arg>    VCF file with the ground-truth SNPs (REQUIRED)\n"
        "-c <arg>    Calls in KisSNP2 format (REQUIRED)\n"
        "-f <arg>    Reference fasta file of first sample (REQUIRED)\n"
        f"-k <arg>    Value to define non-isolated SNPs (default: "
        f"{K_NONIS_DEF})\n"
        f"-l <arg>    Max read length (default: {RLENGTH_DEF})"
    )
    if len(argv) < 3:
        print(usage)
        return 0
    try:
        opts, _ = getopt.getopt(argv, "hv:c:f:l:k:")
    except getopt.GetoptError:
        print(usage)
        return 1
    vcf_path = calls_path = ref_path = ""
    rlength = k_nonis = 0
    for flag, val in opts:
        if flag == "-h":
            print(usage)
            return 0
        elif flag == "-v":
            vcf_path = val
        elif flag == "-c":
            calls_path = val
        elif flag == "-f":
            ref_path = val
        elif flag == "-l":
            rlength = _atoi(val)
        elif flag == "-k":
            k_nonis = _atoi(val)
    rlength = rlength or RLENGTH_DEF
    k_nonis = k_nonis or K_NONIS_DEF
    if not vcf_path or not calls_path or not ref_path:
        print(usage)
        return 1

    ref, contigs = load_fasta(ref_path)
    N = sum(len(ref[c]) for c in contigs)
    print("Contig\tlength")
    for c in contigs:
        print(f"{c}\t{len(ref[c])}")
    load_vcf_calls.k_nonis = k_nonis
    calls_vcf, n_snps, nonisolated = load_vcf_calls(vcf_path, ref, rlength)
    s = validate(calls_path, calls_vcf, n_snps, N)
    print(f"\nNon-isolated SNPs detected: {s['found_nonisolated']}/"
          f"{nonisolated}\n")
    print(f"TP = {s['TP']}")
    print(f"TN = {s['TN']}")
    print(f"FP = {s['FP']}")
    print(f"FN = {s['FN']}")
    tp, tn, fp, fn = s["TP"], s["TN"], s["FP"], s["FN"]

    def pct(a, b):
        return 100.0 * a / b if b else float("nan")

    print(f"sensitivity = TP/(TP+FN) = {pct(tp, tp + fn)}%")
    print(f"specificity = TN/(TN+FP) = {pct(tn, tn + fp)}%")
    print(f"precision   = TP/(TP+FP) = {pct(tp, tp + fp)}%")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
