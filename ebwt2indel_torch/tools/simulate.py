"""Dataset simulation for evaluation and tests (a copy of the JAX package's
``tools/simulate.py``, so the port builds its datasets alone).

The reference's evaluation protocol (datasets/simulate.pdf p.1) simulates
reads from a genome with variants planted on a second haplotype and
sequencing errors, and scores calls against the truth written as a VCF.
The draw sequence is the JAX package's, so a seed gives the same reads in
both packages.
"""

from __future__ import annotations

import dataclasses

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


@dataclasses.dataclass
class Truth:
    """Planted variants, 1-based positions (VCF convention)."""

    snps: list[tuple[int, str, str]]  # (pos, REF, ALT)
    indels: list[tuple[int, str, str]]


def random_genome(rng: np.random.Generator, length: int) -> str:
    return rng.choice(BASES, size=length).tobytes().decode("ascii")


def plant_variants(
    rng: np.random.Generator,
    genome: str,
    snp_rate: float = 0.002,
    indel_rate: float = 0.0002,
    max_indel: int = 5,
) -> tuple[str, Truth]:
    """An alternate haplotype with isolated SNPs/indels (spaced >= 60 bp)
    and the truth set."""
    g = np.frombuffer(genome.encode(), dtype=np.uint8).copy()
    n = len(g)
    n_events = int(n * (snp_rate + indel_rate))
    positions = np.sort(
        rng.choice(np.arange(60, n - 60), size=min(n_events, (n - 120) // 60),
                   replace=False)
    )
    keep = np.concatenate([[True], np.diff(positions) >= 60])
    positions = positions[keep]

    snps: list[tuple[int, str, str]] = []
    indels: list[tuple[int, str, str]] = []
    out: list[bytes] = []
    prev = 0
    p_indel = indel_rate / (snp_rate + indel_rate)
    for pos in positions:
        pos = int(pos)
        if rng.random() < p_indel:
            ln = int(rng.integers(1, max_indel + 1))
            if rng.random() < 0.5 and pos + ln + 1 < n:
                # deletion in alt: REF = anchor + deleted, ALT = anchor
                out.append(g[prev:pos].tobytes())
                ref = genome[pos - 1 : pos + ln]
                indels.append((pos, ref, ref[0]))
                prev = pos + ln
            else:
                # insertion in alt
                ins = rng.choice(BASES, size=ln).tobytes().decode()
                out.append(g[prev:pos].tobytes())
                out.append(ins.encode())
                anchor = genome[pos - 1]
                indels.append((pos, anchor, anchor + ins))
                prev = pos
        else:
            ref_b = genome[pos]
            alt = ref_b
            while alt == ref_b:
                alt = chr(int(rng.choice(BASES)))
            out.append(g[prev:pos].tobytes())
            out.append(alt.encode())
            snps.append((pos + 1, ref_b, alt))
            prev = pos + 1
    out.append(g[prev:].tobytes())
    return b"".join(out).decode("ascii"), Truth(snps=snps, indels=indels)


def sample_reads(
    rng: np.random.Generator,
    genome: str,
    coverage: float,
    read_len: int,
    error_rate: float = 0.001,
    revcomp: bool = False,
) -> list[str]:
    """Uniform read sampling with substitution errors; optionally add reverse
    complements."""
    n = len(genome)
    n_reads = int(n * coverage / read_len)
    g = np.frombuffer(genome.encode(), dtype=np.uint8)
    starts = rng.integers(0, n - read_len + 1, size=n_reads)
    reads = []
    for s in starts:
        r = g[s : s + read_len].copy()
        errs = np.flatnonzero(rng.random(read_len) < error_rate)
        for e in errs:
            cur = r[e]
            choices = BASES[BASES != cur]
            r[e] = rng.choice(choices)
        seq = r.tobytes().decode("ascii")
        if revcomp and rng.random() < 0.5:
            comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
            seq = "".join(comp[ch] for ch in reversed(seq))
        reads.append(seq)
    return reads


def write_vcf(path: str, truth: Truth, chrom: str = "chr1",
              sample: str = "SAMPLE") -> None:
    """The truth set as a VCF 4.1 file, rows sorted by position."""
    rows = [(p, r, a, "SNP") for (p, r, a) in truth.snps] + [
        (p, r, a, "INDEL") for (p, r, a) in truth.indels
    ]
    rows.sort()
    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.1\n")
        f.write(f"##contig=<ID={chrom}>\n")
        f.write('##FILTER=<ID=PASS,Description="All filters passed">\n')
        f.write('##INFO=<ID=VT,Number=1,Type=String,Description="Variant type">\n')
        f.write('##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n')
        f.write(
            f"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t{sample}\n"
        )
        for p, r, a, vt in rows:
            f.write(
                f"{chrom}\t{p}\t.\t{r}\t{a}\t100\tPASS\tVT={vt}\tGT\t1|0\n"
            )


def main(argv=None) -> int:
    """CLI: generate a simulated dataset (genome, alt haplotype, reads,
    truth VCF, eBWTs) following the reference's evaluation protocol shape
    (datasets/simulate.pdf).

    usage: ebwt2indel-torch-simulate outdir [genome_len] [coverage]
           [read_len] [seed]
    """
    import os
    import sys

    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(main.__doc__)
        return 1
    outdir = argv[0]
    genome_len = int(argv[1]) if len(argv) > 1 else 1_000_000
    coverage = float(argv[2]) if len(argv) > 2 else 25.0
    read_len = int(argv[3]) if len(argv) > 3 else 100
    seed = int(argv[4]) if len(argv) > 4 else 0

    from . import ebwt

    os.makedirs(outdir, exist_ok=True)
    rng = np.random.default_rng(seed)
    genome = random_genome(rng, genome_len)
    hap2, truth = plant_variants(rng, genome)
    with open(os.path.join(outdir, "ref.fasta"), "w") as f:
        f.write(">chr1\n" + genome + "\n")
    write_vcf(os.path.join(outdir, "truth.vcf"), truth)

    reads1 = sample_reads(rng, genome, coverage / 2, read_len)
    reads2 = sample_reads(rng, hap2, coverage / 2, read_len)
    ebwt.write_fasta_reads(os.path.join(outdir, "reads1.fasta"), reads1)
    ebwt.write_fasta_reads(os.path.join(outdir, "reads2.fasta"), reads2)

    with open(os.path.join(outdir, "reads.ebwt"), "w") as f:
        f.write(ebwt.ebwt_of_reads(reads1 + reads2))
    bwt, da = ebwt.ebwt_and_da_of_two(reads1, reads2)
    with open(os.path.join(outdir, "merged.ebwt"), "w") as f:
        f.write(bwt)
    with open(os.path.join(outdir, "merged.da"), "w") as f:
        f.write(da)
    print(f"wrote dataset to {outdir}: {len(reads1)}+{len(reads2)} reads, "
          f"{len(truth.snps)} SNPs, {len(truth.indels)} indels")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
