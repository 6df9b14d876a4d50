#!/usr/bin/env python3
"""Generate a large mode-1 eBWT dataset (the port's copy of the repo-root
``tools/genhuge.py``, so the port builds its scale inputs alone).

Two haplotypes at half coverage each with 0.1% substitution errors, as
``bench.py``'s E. coli recipe, but with the reads drawn as one matrix: the
per-read loop of ``simulate.sample_reads`` is fine at 1.1M reads and not at
10M or more. The reads are drawn in chunks of ``CHUNK_READS`` to bound the
host's peak memory; the random stream is drawn in the same order as the
repo-root tool's, so one seed gives the same bytes.

    python -m ebwt2indel_torch.tools.genhuge GENOME_LEN OUT.ebwt [COVERAGE] [READ_LEN]

Positions written: about GENOME_LEN * COVERAGE * (READ_LEN + 1) / READ_LEN.
The 1.05G-position input of the mode-1 scale cell is
``GENOME_LEN = 41_600_000``, coverage 25, reads of 100 (1,050,398,182
positions).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

from . import ebwt, simulate

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
CHUNK_READS = 1 << 20  # ~100 MB of uniforms per chunk at read length 100
SEED = 0xB16B16
SNP_RATE = 0.001
INDEL_RATE = 0.0002


def vector_reads(rng, genome_u8: np.ndarray, coverage: float, read_len: int,
                 error_rate: float = 0.001) -> np.ndarray:
    """(n_reads, read_len) ASCII read matrix with substitution errors: all
    start positions first, then the error uniforms row by row, chunk by
    chunk, then one batch of substitution offsets."""
    n = len(genome_u8)
    n_reads = int(n * coverage / read_len)
    starts = rng.integers(0, n - read_len + 1, size=n_reads)
    reads = np.empty((n_reads, read_len), dtype=np.uint8)
    offs = np.arange(read_len)
    err_chunks = []
    for lo in range(0, n_reads, CHUNK_READS):
        hi = min(lo + CHUNK_READS, n_reads)
        reads[lo:hi] = genome_u8[starts[lo:hi, None] + offs]
        e = np.argwhere(rng.random((hi - lo, read_len)) < error_rate)
        e[:, 0] += lo
        err_chunks.append(e)
    err = np.concatenate(err_chunks) if err_chunks else \
        np.zeros((0, 2), np.int64)
    if len(err):
        code = np.zeros(256, dtype=np.uint8)
        code[BASES] = np.arange(4)
        cur = code[reads[err[:, 0], err[:, 1]]]
        new = (cur + rng.integers(1, 4, size=len(err))) % 4
        reads[err[:, 0], err[:, 1]] = BASES[new]
    return reads


def ebwt_of_read_matrix(text: np.ndarray) -> np.ndarray:
    """eBWT bytes of a (n_reads, read_len + 1) ASCII matrix whose last
    column is the '#' terminator: the suffix order of
    ``tools/ebwt.ebwt_of_reads`` (terminators distinct by read index and
    below all bases), from one suffix array of the whole matrix."""
    n_reads, row = text.shape
    read_len = row - 1
    raw = text.reshape(-1)
    n = len(raw)

    codes = np.empty(n + 1, dtype=np.int32)
    lut = np.zeros(256, dtype=np.int32)
    for i, b in enumerate(BASES):
        lut[b] = n_reads + 1 + i
    codes[:n] = lut[raw]
    term_pos = np.arange(n_reads, dtype=np.int64) * (read_len + 1) + read_len
    codes[term_pos] = np.arange(1, n_reads + 1, dtype=np.int32)
    codes[n] = 0

    sa = ebwt.suffix_array_sentinel(codes)
    del codes
    if sa[0] != n:
        raise RuntimeError("suffix array does not start at the sentinel")
    sa = sa[1:]
    np.subtract(sa, 1, out=sa)
    sa[sa < 0] = n - 1
    return raw[sa]


def build(genome_len: int, out: str, coverage: float = 25.0,
          read_len: int = 100, seed: int = SEED, log=print) -> int:
    """Write the eBWT of the recipe to ``out``; returns its positions."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    genome = simulate.random_genome(rng, genome_len)
    hap2, _ = simulate.plant_variants(rng, genome, snp_rate=SNP_RATE,
                                      indel_rate=INDEL_RATE)
    g1 = np.frombuffer(genome.encode(), dtype=np.uint8)
    g2 = np.frombuffer(hap2.encode(), dtype=np.uint8)
    del genome, hap2
    r1 = vector_reads(rng, g1, coverage / 2, read_len)
    r2 = vector_reads(rng, g2, coverage / 2, read_len)
    del g1, g2
    # terminator-joined text: each read followed by '#'
    text = np.empty((len(r1) + len(r2), read_len + 1), dtype=np.uint8)
    text[: len(r1), :read_len] = r1
    text[len(r1):, :read_len] = r2
    del r1, r2
    text[:, read_len] = ord("#")
    log(f"[genhuge] {text.shape[0]} reads, {text.size} positions in "
        f"{time.perf_counter() - t0:.1f} s; suffix array ...")
    bwt = ebwt_of_read_matrix(text)
    del text
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    bwt.tofile(out + ".tmp")
    os.replace(out + ".tmp", out)
    log(f"[genhuge] wrote {out}: {len(bwt)} positions in "
        f"{time.perf_counter() - t0:.1f} s")
    return len(bwt)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    build(int(argv[0]), argv[1],
          float(argv[2]) if len(argv) > 2 else 25.0,
          int(argv[3]) if len(argv) > 3 else 100)
    return 0


if __name__ == "__main__":
    sys.exit(main())
