"""sam2vcf — convert BWA-MEM alignments of .snp calls into VCF 4.1 rows.
The port's copy of ``ebwt2indel_tpu/tools/sam2vcf.py``.

Behavioral equivalent of the reference tool (sam2vcf.cpp). Only CIGARs of
shape [wS] xM [y(I|D) [zM]] are interpreted (parse_cigar, sam2vcf.cpp:57-122);
the NM tag is taken from the 12th tab field (cpp:283-312); rows are emitted
for alignments with 0 < NM <= max_mism (default 5). All rows carry QUAL=100,
PASS, GT 1|1 (cpp:338-347).
"""

from __future__ import annotations

import getopt
import sys

from .filter_snp import _atoi


def parse_cigar(cigar: str):
    """Returns (S, M1, DI, M2, type) — type is 'M', 'I' or 'D', or '' if the
    cigar does not match the supported shapes (sam2vcf.cpp:57-122)."""
    S = M1 = DI = M2 = 0
    ty = ""
    types: list[str] = []
    lens: list[int] = []
    L = 0
    for ch in cigar:
        if "0" <= ch <= "9":
            L = L * 10 + (ord(ch) - ord("0"))
        else:
            types.append(ch)
            lens.append(L)
            L = 0
    if not types:
        return S, M1, DI, M2, ty
    k = 0
    if types[k] == "S":
        S = lens[k]
        k += 1
    if k < len(types) and types[k] == "M":
        M1 = lens[k]
        k += 1
        ty = "M"
    else:
        return S, M1, DI, M2, ty
    if len(types) > k:
        if types[k] in ("D", "I"):
            DI = lens[k]
            ty = types[k]
            k += 1
        else:
            return S, M1, DI, M2, ty
        if len(types) > k and types[k] == "M":
            M2 = lens[k]
    return S, M1, DI, M2, ty


def load_fasta(path: str):
    """Reference contigs, uppercased; contig name is the full header line
    after '>' (sam2vcf.cpp:195-213)."""
    ref: dict[str, str] = {}
    contigs: list[str] = []
    contig = ""
    parts: dict[str, list[str]] = {}
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith(">"):
                contig = line[1:]
                contigs.append(contig)
                parts[contig] = []
            elif contig:
                parts[contig].append(line.upper())
    for c in contigs:
        ref[c] = "".join(parts[c])
    return ref, contigs


def convert(input_fasta: str, input_sam: str, output: str,
            max_mism: int = 5, sample: str = "SAMPLE", log=print) -> dict:
    ref, contigs = load_fasta(input_fasta)
    log("Contig\tlength")
    for c in contigs:
        log(f"{c}\t{len(ref[c])}")

    tot_events = good_events = used_events = 0
    with open(output, "w") as out, open(input_sam) as sam:
        out.write("##fileformat=VCFv4.1\n")
        for c in contigs:
            out.write(f"##contig=<ID={c}>\n")
        out.write('##FILTER=<ID=PASS,Description="All filters passed">\n')
        out.write('##INFO=<ID=VT,Number=1,Type=String,'
                  'Description="Variant type">\n')
        out.write('##FORMAT=<ID=GT,Number=1,Type=String,'
                  'Description="Genotype">\n')
        out.write(f"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                  f"{sample}\n")

        ID = "."
        for line in sam:
            line = line.rstrip("\n")
            if not line or line[0] in "@[":
                continue
            tot_events += 1
            fields = line.split("\t")
            fields += [""] * (12 - len(fields))
            chrom = fields[2]
            pos_int = _atoi(fields[3])
            cigar = fields[5]
            seq = fields[9]
            NM = fields[11]
            nm_parts = NM.split(":")
            n_mism = _atoi(nm_parts[2]) if len(nm_parts) >= 3 else 0

            if not (0 < n_mism <= max_mism and len(ref.get(chrom, "")) > 0):
                continue
            good_events += 1
            S, M1, DI, M2, ty = parse_cigar(cigar)
            k = S
            if M1 <= 0:
                continue
            used_events += 1
            R = ref[chrom]

            def row(pos, REF, ALT, vt):
                out.write(f"{chrom}\t{pos}\t{ID}\t{REF}\t{ALT}\t100\tPASS\t"
                          f"VT={vt}\tGT\t1|1\n")

            for j in range(M1):
                if R[pos_int + j - 1] != seq[k]:
                    row(pos_int + j, R[pos_int + j - 1], seq[k], "SNP")
                k += 1
            if DI > 0:
                if ty == "I":
                    REF = R[pos_int + M1 - 2 : pos_int + M1 - 1]
                    ALT = seq[k - 1 : k + DI]
                    k += DI
                    row(pos_int + (M1 - 1), REF, ALT, "INDEL")
                elif ty == "D":
                    REF = R[pos_int + M1 - 2 : pos_int + M1 - 1 + DI]
                    ALT = seq[k - 1 : k]
                    row(pos_int + (M1 - 1), REF, ALT, "INDEL")
            if M2 > 0:
                start = pos_int + M1 + (DI if ty == "D" else 0) - 1
                for j in range(M2):
                    if R[start + j] != seq[k]:
                        row(start + j + 1, R[start + j], seq[k], "SNP")
                    k += 1

    log("Done.")
    log(f"Alignments used to generate VCF entries/alignments with 0 < errors "
        f"<= max_diff: {used_events}/{good_events}")
    return {"tot": tot_events, "good": good_events, "used": used_events}


def help_text() -> str:
    return ("sam2vcf [OPTIONS]\n\n"
            "Turns all mismatches/indels seen in a sam file into VCF entries.\n"
            "Options:\n"
            "-h          Print this help.\n"
            "-f <arg>    Reference fasta file. REQUIRED.\n"
            "-s <arg>    Input SAM file. REQUIRED\n"
            "-v <arg>    Output vcf file. REQUIRED.\n"
            "-m <arg>    Maximum number of differences, i.e. mismatches + "
            "indels (default:5)\n"
            '-S <arg>    Sample name (default:"SAMPLE")')


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(help_text())
        return 0
    try:
        opts, _ = getopt.getopt(argv, "hs:f:v:m:S:")
    except getopt.GetoptError:
        print(help_text())
        return 1
    fasta = sam = vcf = ""
    max_mism = 5
    sample = "SAMPLE"
    for flag, val in opts:
        if flag == "-h":
            print(help_text())
            return 0
        elif flag == "-f":
            fasta = val
        elif flag == "-s":
            sam = val
        elif flag == "-v":
            vcf = val
        elif flag == "-m":
            max_mism = _atoi(val)
        elif flag == "-S":
            sample = val
    if not fasta or not sam or not vcf:
        print(help_text())
        return 1
    convert(fasta, sam, vcf, max_mism, sample)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
