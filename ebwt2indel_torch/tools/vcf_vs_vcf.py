"""vcf_vs_vcf — sensitivity/precision of a VCF against a ground-truth VCF.
The port's copy of ``ebwt2indel_tpu/tools/vcf_vs_vcf.py``.

Behavioral equivalent of the reference scorer (vcf_vs_vcf.cpp): multi-ALT rows
split on ','; an entry is an indel iff len(REF)>1 or len(ALT)>1 (cpp:120);
SNP matches are exact (chr,pos) ignoring alleles (cpp:72-77) — and note they
match *any* ground-truth entry at that position, indel or not; indel matches
flag every ground-truth indel within +/- indel_window (default 10) of the
called position (cpp:202-220). Reports TP/FP/FN and derived rates split by
SNP/INDEL/TOT (cpp:268-288).
"""

from __future__ import annotations

import bisect
import dataclasses
import getopt
import sys

from .filter_snp import _atoi

INDEL_WINDOW_DEF = 10


@dataclasses.dataclass
class VcfEntry:
    chr: str
    pos: int
    REF: str
    ALT: str
    indel: bool
    flag: bool = False

    def key(self):
        # comparator of vcf_vs_vcf.cpp:47-70: (chr, pos, REF+ALT)
        return (self.chr, self.pos, self.REF + self.ALT)


def read_vcf(path: str) -> list[VcfEntry]:
    out: list[VcfEntry] = []
    with open(path) as f:
        for line in f:
            if not line or line[0] == "#":
                continue
            fields = line.rstrip("\n").split("\t")
            fields += [""] * (5 - len(fields))
            chrom, pos_s, _id, ref, alt = fields[:5]
            pos = _atoi(pos_s)
            for a in alt.split(","):
                out.append(
                    VcfEntry(chrom, pos, ref, a,
                             indel=(len(ref) > 1 or len(a) > 1))
                )
    return out


def score(vcf1: list[VcfEntry], vcf2: list[VcfEntry],
          indel_window: int) -> dict:
    vcf1.sort(key=VcfEntry.key)
    vcf2.sort(key=VcfEntry.key)
    keys2 = [e.key() for e in vcf2]
    # index of first entry at (chr,pos) — what std::find on the sorted vector
    # returns for the ==-by-(chr,pos) comparison
    for v in vcf1:
        if v.indel:
            lo_pos = v.pos - indel_window if v.pos >= indel_window else 0
            i = bisect.bisect_left(keys2, (v.chr, lo_pos, v.REF + v.ALT))
            while i < len(vcf2) and vcf2[i].chr == v.chr and \
                    vcf2[i].pos <= v.pos + indel_window:
                if vcf2[i].indel:
                    v.flag = True
                    vcf2[i].flag = True
                i += 1
        else:
            i = bisect.bisect_left(keys2, (v.chr, v.pos, ""))
            if i < len(vcf2) and vcf2[i].chr == v.chr and vcf2[i].pos == v.pos:
                v.flag = True
                vcf2[i].flag = True

    TP_s = sum(1 for v in vcf1 if not v.indel and v.flag)
    FP_s = sum(1 for v in vcf1 if not v.indel and not v.flag)
    TP_i = sum(1 for v in vcf1 if v.indel and v.flag)
    FP_i = sum(1 for v in vcf1 if v.indel and not v.flag)
    FN_s = sum(1 for v in vcf2 if not v.indel and not v.flag)
    FN_i = sum(1 for v in vcf2 if v.indel and not v.flag)
    return dict(TP_s=TP_s, FP_s=FP_s, FN_s=FN_s,
                TP_i=TP_i, FP_i=FP_i, FN_i=FN_i)


def _pct(a: float, b: float) -> float:
    return 100.0 * a / b if b else float("nan")


def report(s: dict, log=print) -> None:
    log(f"TP (SNP) = {s['TP_s']}")
    log(f"FP (SNP) = {s['FP_s']}")
    log(f"FN (SNP) = {s['FN_s']}\n")
    log(f"TP (INDEL) = {s['TP_i']}")
    log(f"FP (INDEL) = {s['FP_i']}")
    log(f"FN (INDEL) = {s['FN_i']}\n")
    log(f"TP (TOT) = {s['TP_i'] + s['TP_s']}")
    log(f"FP (TOT) = {s['FP_i'] + s['FP_s']}")
    log(f"FN (TOT) = {s['FN_i'] + s['FN_s']}\n")
    log(f"sensitivity SNP = TP/(TP+FN) = "
        f"{_pct(s['TP_s'], s['TP_s'] + s['FN_s'])}%")
    log(f"precision   SNP = TP/(TP+FP) = "
        f"{_pct(s['TP_s'], s['TP_s'] + s['FP_s'])}%\n")
    log(f"sensitivity INDEL = TP/(TP+FN) = "
        f"{_pct(s['TP_i'], s['TP_i'] + s['FN_i'])}%")
    log(f"precision   INDEL = TP/(TP+FP) = "
        f"{_pct(s['TP_i'], s['TP_i'] + s['FP_i'])}%\n")
    ts, ti = s["TP_s"] + s["TP_i"], s["FN_s"] + s["FN_i"]
    log(f"sensitivity TOT = TP/(TP+FN) = {_pct(ts, ts + ti)}%")
    log(f"precision   TOT = TP/(TP+FP) = "
        f"{_pct(ts, ts + s['FP_s'] + s['FP_i'])}%\n")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    usage = (
        "vcf_vs_vcf [OPTIONS]\n\n"
        "Compute sensitivity and specificity of the calls specified with -1 "
        "against those specified with -2.\n"
        "Options:\n"
        "-h          Print this help.\n"
        "-1 <arg>    Input VCF file to be validated. REQUIRED\n"
        "-2 <arg>    Ground truth VCF. REQUIRED\n"
        f"-d <arg>    Indel window tolerance. Consider a true match if 2 "
        f"indels are within <arg> bases (default = {INDEL_WINDOW_DEF})"
    )
    if not argv:
        print(usage)
        return 0
    try:
        opts, _ = getopt.getopt(argv, "d:1:2:h")
    except getopt.GetoptError:
        print(usage)
        return 1
    p1 = p2 = ""
    window = 0
    for flag, val in opts:
        if flag == "-h":
            print(usage)
            return 0
        elif flag == "-d":
            window = _atoi(val)
        elif flag == "-1":
            p1 = val
        elif flag == "-2":
            p2 = val
    window = window or INDEL_WINDOW_DEF
    if not p1 or not p2:
        print(usage)
        return 1
    s = score(read_vcf(p1), read_vcf(p2), window)
    report(s)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
