"""Dataset simulation for evaluation and tests (a copy of the JAX package's
``tools/simulate.py`` generators, so the port builds its datasets alone).

The reference's evaluation protocol (datasets/simulate.pdf p.1) simulates
reads from a genome with variants planted on a second haplotype and
sequencing errors. The draw sequence is the JAX package's, so a seed gives
the same reads in both packages.
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
