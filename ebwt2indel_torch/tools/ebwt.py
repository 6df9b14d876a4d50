"""eBWT construction for read collections (a copy of the JAX package's
``tools/ebwt.py`` builder, so the port builds its datasets alone).

The multi-string BWT of a read set comes from a suffix array of the
terminator-joined concatenation, terminators distinct and smallest: the
native linear-time SA-IS (``native/saca.cpp``) where it builds, else numpy
prefix doubling. Also the FASTA reader and writer of the read sets.
"""

from __future__ import annotations

import numpy as np

from ..ops import native


def suffix_array_sentinel(codes: np.ndarray) -> np.ndarray:
    """Suffix array of an int sequence whose last element is the unique
    smallest (0)."""
    codes = np.ascontiguousarray(codes, dtype=np.int32)
    try:
        return native.sais(codes, int(codes.max()) + 1)
    except native.NativeUnavailable:
        return suffix_array(codes.astype(np.int64))


def suffix_array(codes: np.ndarray) -> np.ndarray:
    """Prefix-doubling suffix array; codes must be small non-negative ints."""
    n = len(codes)
    rank = codes.astype(np.int64)
    k = 1
    idx = np.arange(n, dtype=np.int64)
    while True:
        shifted = idx + k
        key2 = np.where(shifted < n, rank[np.minimum(shifted, n - 1)], -1)
        order = np.lexsort((key2, rank))
        neq = (rank[order[1:]] != rank[order[:-1]]) | (
            key2[order[1:]] != key2[order[:-1]]
        )
        new_rank = np.empty(n, dtype=np.int64)
        new_rank[order] = np.concatenate([[0], np.cumsum(neq)])
        rank = new_rank
        if rank[order[-1]] == n - 1:
            return order
        k *= 2


def _ebwt_sa(raw: np.ndarray, term: int) -> np.ndarray:
    """Suffix array of the terminator-joined text with terminators distinct
    (ordered by position) and smaller than the bases."""
    n = len(raw)
    is_term = raw == term
    n_term = int(is_term.sum())
    codes = np.zeros(n + 1, dtype=np.int32)
    codes[:n][is_term] = np.arange(1, n_term + 1, dtype=np.int32)
    for b, c in ((ord("A"), 1), (ord("C"), 2), (ord("G"), 3), (ord("T"), 4)):
        codes[:n][raw == b] = n_term + c
    # codes[n] = 0: unique smallest sentinel for SA-IS
    sa = suffix_array_sentinel(codes)
    if sa[0] != n:
        raise RuntimeError("suffix array does not start at the sentinel")
    return sa[1:]


def ebwt_of_reads(reads: list[str], term: str = "#") -> str:
    """ASCII eBWT of a read multiset (each read terminator-suffixed); the
    terminator compares smaller than A<C<G<T (dna_bwt.hpp:47-61)."""
    text = term.join(reads) + term
    raw = np.frombuffer(text.encode("ascii"), dtype=np.uint8)
    sa = _ebwt_sa(raw, ord(term))
    prev = (sa - 1) % len(raw)
    return raw[prev].tobytes().decode("ascii")


def ebwt_and_da_of_two(reads1: list[str], reads2: list[str],
                       term: str = "#") -> tuple[str, str]:
    """Merged eBWT of two collections plus the document array ('0'/'1' per
    position, '1' for the second collection). Terminators order by
    position, so on equal strings collection-1 suffixes precede
    collection-2 suffixes (the merge convention of update_DA,
    ebwt2InDel.cpp:394-449)."""
    t1 = term.join(reads1) + term
    text = t1 + term.join(reads2) + term
    raw = np.frombuffer(text.encode("ascii"), dtype=np.uint8)
    sa = _ebwt_sa(raw, ord(term))
    prev = (sa - 1) % len(raw)
    bwt = raw[prev].tobytes().decode("ascii")
    da = ((sa >= len(t1)).astype(np.uint8) + ord("0")).tobytes()
    return bwt, da.decode("ascii")


def write_fasta_reads(path: str, reads: list[str]) -> None:
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">read_{i}\n{r}\n")


def read_fasta(path: str) -> list[str]:
    """The sequences of a FASTA file, uppercased, multi-line records
    joined."""
    reads: list[str] = []
    cur: list[str] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if cur:
                    reads.append("".join(cur))
                    cur = []
            else:
                cur.append(line.upper())
    if cur:
        reads.append("".join(cur))
    return reads
