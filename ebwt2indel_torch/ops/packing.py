"""Host-side packing of a BWT (or any {A,C,G,T,TERM} string) into the rank
block layout that the CUDA rank kernel reads.

Layout (reference: internal/dna_string.hpp:19-41, 320-369, 554-585):

* block = 128 characters = one 64-byte row of 16 uint32 words:
    - words  0.. 3 : bitplane 0 (LSB of the 3-bit code), LSB-first per word
    - words  4.. 7 : bitplane 1
    - words  8..11 : bitplane 2 (the TERM flag plane)
    - words 12..15 : ABSOLUTE counts of A,C,G,T *before* the block.
* One rank query = one 64-byte row read + popcounts, the reference's
  "1 cache miss per parallel_rank" (dna_string.hpp:13-17, 140-152).

Block counters are 32-bit, so one run is capped below 2^32 characters.

Mode 3 also reads a document array (``read_da_file``) and packs it into the
rank-1 bitvector layout of ``ops/bits.py`` (``pack_bitvector``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils import dna

BLOCK = 128  # characters per block
WPB = 4  # 32-bit words per plane per block


@dataclass
class PackedBwt:
    """Host (numpy) packed representation; models.fm_index.FMIndex is its
    device mirror."""

    blocks: np.ndarray  # (n_blocks, 16) uint32
    block_counts: np.ndarray  # (n_blocks, 4) int32 — copy of words 12..15
    F: np.ndarray  # (4,) int64: [F_A, F_C, F_G, F_T] as in dna_bwt.hpp:47-61
    counts: np.ndarray  # (5,) int64 total counts of A,C,G,T,TERM
    n: int
    term: int = dna.DEFAULT_TERM


# the block counters are uint32; the margin matches the JAX package's cap
CAP = 2**32 - 2**25

CAP_MESSAGE = (
    f"input exceeds {CAP} characters — the 32-bit block counters of one "
    "run; process the input as independent context-sorted pieces (the "
    "reference's own scaling story, pebwt2InDel.sh:49-83)"
)


def forbidden_message(ch: int, term: int) -> str:
    """The reference's forbidden-character error (dna_string.hpp:90-96)."""
    return (
        f"Error while reading file: read forbidden character "
        f"'{chr(ch)}' (ASCII code {ch}). Only A,C,G,T, and {chr(term)} are "
        f"admitted in the input BWT! If the unknown character is the "
        f'terminator, you can solve the problem by adding option "-t {ch}".'
    )


def f_from_totals(totals: np.ndarray) -> np.ndarray:
    """F column boundaries from (5,) char totals, TERM lexicographically
    smallest (dna_bwt.hpp:47-61): F_A = #TERM, F_C = F_A + #A, ..."""
    F = np.empty(4, dtype=np.int64)
    F[0] = totals[4]
    F[1] = F[0] + totals[0]
    F[2] = F[1] + totals[1]
    F[3] = F[2] + totals[2]
    return F


def pack_codes(codes: np.ndarray, term: int = dna.DEFAULT_TERM) -> PackedBwt:
    """Pack an array of 3-bit codes (A=0..T=3, TERM=4) into block rows."""
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    n = int(codes.shape[0])
    if n >= CAP:
        raise ValueError(CAP_MESSAGE)
    # one extra block guarantees rank(n) addresses a valid row, mirroring the
    # reference's (n+1)-based block count (dna_string.hpp:61-62)
    n_blocks = n // BLOCK + 1
    padded = np.zeros(n_blocks * BLOCK, dtype=np.uint8)
    padded[:n] = codes

    bits = padded.reshape(n_blocks, WPB, 32)
    weights = (np.uint32(1) << np.arange(32, dtype=np.uint32))[None, None, :]
    planes = np.empty((n_blocks, 3 * WPB), dtype=np.uint32)
    for p in range(3):
        plane_bits = ((bits >> p) & 1).astype(np.uint32)
        planes[:, p * WPB : (p + 1) * WPB] = (plane_bits * weights).sum(
            axis=2, dtype=np.uint32
        )

    # absolute counts of each base before each block
    per_block = np.empty((n_blocks, 4), dtype=np.int64)
    blk = padded.reshape(n_blocks, BLOCK)
    for c in range(4):
        per_block[:, c] = (blk == c).sum(axis=1)
    # the padding is code 0 ('A'); remove its contribution from the final block
    per_block[-1, 0] -= n_blocks * BLOCK - n
    cum = np.zeros((n_blocks, 4), dtype=np.int64)
    np.cumsum(per_block[:-1], axis=0, out=cum[1:])

    blocks = np.empty((n_blocks, 16), dtype=np.uint32)
    blocks[:, :12] = planes
    blocks[:, 12:16] = cum.astype(np.uint32)

    totals = np.zeros(5, dtype=np.int64)
    totals[:4] = cum[-1] + per_block[-1]
    totals[4] = n - totals[:4].sum()
    return PackedBwt(
        blocks=blocks,
        block_counts=cum.astype(np.int32),
        F=f_from_totals(totals),
        counts=totals,
        n=n,
        term=term,
    )


def widen_u32(x) -> np.ndarray:
    """int64 copy of an integer array whose 32-bit entries are uint32 bit
    patterns (``pack_codes``' block counters, ``pack_bitvector``'s
    counts): they widen unsigned, so a count at or past 2^31 stays
    positive."""
    x = np.asarray(x)
    if x.dtype.itemsize == 4:
        return x.astype(np.int64) & 0xFFFFFFFF
    return x.astype(np.int64)


def ascii_to_codes(raw: np.ndarray, term: int = dna.DEFAULT_TERM) -> np.ndarray:
    """ASCII bytes -> codes, validating the alphabet with the reference's
    message (internal/dna_string.hpp:76-105)."""
    codes = dna.code_table(term)[raw]
    bad = codes == 255
    if bad.any():
        raise ValueError(forbidden_message(int(raw[bad.argmax()]), term))
    return codes


def read_ebwt_codes(path: str, term: int = dna.DEFAULT_TERM) -> np.ndarray:
    """Read an ASCII eBWT file and convert to codes."""
    return ascii_to_codes(np.fromfile(path, dtype=np.uint8), term)


def pack_bytes(raw: np.ndarray, term: int = dna.DEFAULT_TERM) -> PackedBwt:
    """Pack raw ASCII bytes: the native multithreaded packer where it
    builds, else the numpy path (same result)."""
    from . import native

    try:
        return native.pack_bytes(raw, term)
    except native.NativeUnavailable:
        return pack_codes(ascii_to_codes(raw, term), term)


def pack_file(path: str, term: int = dna.DEFAULT_TERM) -> PackedBwt:
    """Pack an ASCII eBWT file: the native multithreaded packer where it
    builds, else the numpy path (same result). Forbidden-character errors
    carry the reference's message either way."""
    from . import native

    try:
        return native.pack_file(path, term)
    except native.NativeUnavailable:
        return pack_codes(read_ebwt_codes(path, term), term)


_POPCOUNT8 = np.array([bin(i).count("1") for i in range(256)], dtype=np.uint8)


def pack_bitvector(bits: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Pack a 0/1 array into the rank-1 layout of ``ops.rank.bv_rank1``:
    (n_blocks*4,) uint32 FLAT words, LSB-first, and (n_blocks,) int32
    exclusive per-block popcounts, n_blocks = n // 128 + 1 (the document
    array of mode 3, ebwt2InDel.cpp:1495-1508)."""
    bits = np.asarray(bits)
    n = int(bits.shape[0])
    n_blocks = n // BLOCK + 1
    # little bit order packs positions 8k..8k+7 into byte k LSB-first, so
    # four bytes read as one little-endian uint32 are 32 positions LSB-first
    packed = np.zeros(n_blocks * BLOCK // 8, dtype=np.uint8)
    packed[: (n + 7) // 8] = np.packbits(bits, bitorder="little")
    per_block = _POPCOUNT8[packed].reshape(n_blocks, BLOCK // 8).sum(
        axis=1, dtype=np.int64)
    cum = np.zeros(n_blocks, dtype=np.int64)
    np.cumsum(per_block[:-1], out=cum[1:])
    return packed.view("<u4").astype(np.uint32), cum.astype(np.int32)


def read_da_file(path: str, n: int) -> np.ndarray:
    """Read an ASCII '0'/'1' document-array file, one byte per BWT position,
    '1' marking the second collection (ebwt2InDel.cpp:1495-1508)."""
    raw = np.fromfile(path, dtype=np.uint8, count=n)
    return (raw == ord("1")).astype(np.uint8)
