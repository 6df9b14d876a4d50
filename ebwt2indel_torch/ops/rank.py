"""Batched rank / access / select over the packed block layout.

Counterparts of ``ebwt2indel_tpu/ops/rank.py`` (reference primitives
dna_string.hpp:113-135, 140-152, 182-272):

* ``parallel_rank`` dispatches on the device of its query tensor: a CUDA
  tensor goes to the hand-written kernel (``ops/rank_cuda.py``,
  ``csrc/rank_decode.cu``) and a CPU tensor to ``parallel_rank_plain``,
  the kernel's plain PyTorch version. There is no fallback between them.
* ``access``, ``select`` and the bitvector rank ``bv_rank1`` / ``bv_get``
  (rank.py:389-454, the document array of modes 2 and 3) are plain
  PyTorch on either device.

Blocks are int32 storage holding the uint32 bit patterns of
``ops/packing.py``. This module widens gathered rows to int64 and masks them
with ``& 0xFFFFFFFF``: CPU PyTorch cannot shift uint32 and has no popcount
op, so bits are counted with a SWAR popcount on int64. Positions and ranks
are int64 throughout.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

BLOCK = 128
WPB = 4
_LOW32 = 0xFFFFFFFF


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of int64 values in [0, 2^32)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def _rows(blocks: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Block rows ``blocks[b]`` as int64 uint32 values; ``b`` is clamped to
    the valid rows, as JAX's gather clamps (rank.py:109, :305)."""
    b = b.clamp(0, blocks.shape[0] - 1)
    return blocks[b].to(torch.int64) & _LOW32


def _prefix_masks(o: torch.Tensor) -> torch.Tensor:
    """(..., 4) int64 masks of the first ``o`` bits of a 128-bit block. The
    shift is int64, so a word taken whole (take == 32) needs no special
    case here; the CUDA kernel special-cases it (rank.py:44-46)."""
    w = torch.arange(WPB, dtype=torch.int64, device=o.device)
    take = (o[..., None] - w * 32).clamp(0, 32)
    return (torch.ones_like(take) << take) - 1


def parallel_rank_plain(blocks: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Counts of (A,C,G,T) in the prefix of length ``i`` — the plain version
    of the rank kernel (rank.py:63-110).

    blocks: int32 (n_blocks, 16); i: int64 [...]; returns int64 [..., 4].
    With S = #non-TERM, x = #bit0, y = #bit1, z = #(bit0 & bit1) among the
    first o = i & 127 characters of block i >> 7: A = S-x-y+z, C = x-z,
    G = y-z, T = z, each added to the block's counter.
    """
    shape = i.shape
    i = i.reshape(-1)
    row = _rows(blocks, i >> 7)
    mask = _prefix_masks(i & (BLOCK - 1))
    np2m = ~row[:, 8:12] & mask
    t0 = row[:, 0:4] & np2m
    t1 = row[:, 4:8] & np2m
    t2 = t0 & t1
    S = popcount32(np2m).sum(-1)
    x = popcount32(t0).sum(-1)
    y = popcount32(t1).sum(-1)
    z = popcount32(t2).sum(-1)
    cnt = row[:, 12:16]
    out = torch.stack(
        [cnt[:, 0] + (S - x - y + z), cnt[:, 1] + (x - z),
         cnt[:, 2] + (y - z), cnt[:, 3] + z], dim=-1)
    return out.reshape(shape + (4,))


def parallel_rank(blocks: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Counts of (A,C,G,T) in the prefix of length ``i`` (int64 [..., 4]).

    A CUDA query launches the rank kernel (or raises); a CPU query runs the
    plain version."""
    if i.device.type == "cuda":
        from . import rank_cuda

        return rank_cuda.rank_decode(blocks, i)
    if i.device.type == "cpu" and blocks.device.type == "cpu":
        return parallel_rank_plain(blocks, i)
    raise ValueError(
        f"parallel_rank: blocks on {blocks.device}, queries on {i.device}")


def access(blocks: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Character code (0..4) at position i (dna_string.hpp:113-135)."""
    row = _rows(blocks, i >> 7)
    o = i & (BLOCK - 1)
    widx = (o >> 5)[..., None]
    bit = o & 31
    code = torch.zeros_like(i)
    for p in range(3):
        word = torch.gather(row[..., p * WPB:(p + 1) * WPB], -1, widx)[..., 0]
        code |= ((word >> bit) & 1) << p
    return code


def _select_in_word(word: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Position (0..31) of the (t+1)-th set bit of ``word``: a 5-step binary
    descent on prefix popcounts (rank.py:316-328)."""
    lo = torch.zeros_like(t)
    for k in (16, 8, 4, 2, 1):
        pref = (torch.ones_like(lo) << (lo + k)) - 1
        cnt = popcount32(word & pref)
        lo = torch.where(cnt <= t, lo + k, lo)
    return lo


def select_block(block_counts: torch.Tensor, r: torch.Tensor,
                 c: torch.Tensor) -> torch.Tensor:
    """The block holding the (r+1)-th occurrence of char c: a binary search
    over the absolute per-block counters (rank.py:331-351).

    block_counts: int64 (n_blocks, 4); r, c: int64 [...]."""
    nb = block_counts.shape[0]
    lo = torch.zeros_like(r)
    hi = torch.full_like(r, nb)  # exclusive
    # invariant: counts[lo] <= r < counts[hi] (counts[nb] == total > r)
    for _ in range(max(1, (nb - 1).bit_length())):
        mid = (lo + hi) >> 1
        use = mid > lo
        cm = block_counts[mid.clamp(0, nb - 1), c]
        gt = cm > r
        lo = torch.where(use & ~gt, mid, lo)
        hi = torch.where(use & gt, mid, hi)
    return lo


def select_in_block(row: torch.Tensor, r: torch.Tensor,
                    c: torch.Tensor) -> torch.Tensor:
    """Offset (0..127) of the (t+1)-th occurrence of char c inside a gathered
    int64 block row, t = r minus the block's counter (rank.py:354-371)."""
    t = r - torch.gather(row[..., 12:16], -1, c[..., None])[..., 0]
    p0, p1 = row[..., 0:4], row[..., 4:8]
    np2 = ~row[..., 8:12] & _LOW32
    # the char's occurrence bits: c = bit0 + 2*bit1 among non-TERM codes
    b0 = (c & 1)[..., None].bool()
    b1 = ((c >> 1) & 1)[..., None].bool()
    words = (np2 & torch.where(b0, p0, ~p0 & _LOW32)
             & torch.where(b1, p1, ~p1 & _LOW32))
    wc = popcount32(words)
    cum = torch.cumsum(wc, dim=-1)
    prev = cum - wc
    widx = (cum <= t[..., None]).sum(-1).clamp(0, WPB - 1)
    t2 = t - torch.gather(prev, -1, widx[..., None])[..., 0]
    word = torch.gather(words, -1, widx[..., None])[..., 0]
    return widx * 32 + _select_in_word(word, t2)


def select(blocks: torch.Tensor, block_counts: torch.Tensor, r: torch.Tensor,
           c: torch.Tensor) -> torch.Tensor:
    """Position of the (r+1)-th occurrence of char code c (0..3), batched.
    Assumes 0 <= r < total count of c (dna_string.hpp:182-188)."""
    b = select_block(block_counts, r, c)
    return b * BLOCK + select_in_block(_rows(blocks, b), r, c)


# rank-1 over a packed bitvector (the document array): FLAT int32 words,
# four per 128-position block, and int64 exclusive per-block counts (the
# layout of ops/bits.py::bv_build and ops/packing.py::pack_bitvector).
# Indices are clamped to the valid range, as JAX's gather clamps.


def _bv_row(words: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 4) words of block b as int64 uint32 values (rank.py:389-394)."""
    b = b.clamp(0, words.shape[0] // WPB - 1)
    idx = WPB * b[..., None] + torch.arange(WPB, device=b.device)
    return words[idx].to(torch.int64) & _LOW32


def bv_rank1(words: torch.Tensor, counts: torch.Tensor,
             i: torch.Tensor) -> torch.Tensor:
    """Number of 1-bits before position i, int64 (rank.py:397-409)."""
    b = i >> 7
    inblock = popcount32(_bv_row(words, b)
                         & _prefix_masks(i & (BLOCK - 1))).sum(-1)
    return counts[b.clamp(0, counts.shape[0] - 1)] + inblock


def bv_get(words: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Bit at position i, int64 0 or 1 (rank.py:449-454)."""
    word = words[(i >> 5).clamp(0, words.shape[0] - 1)].to(torch.int64)
    return (word >> (i & 31)) & 1


class BitRank(NamedTuple):
    """A 0/1 vector's rank structure (``bits.bv_build``'s layout) answering
    ``bv_rank1`` and ``bv_get``; the mesh's ``calling.ShardedBits`` answers
    the same calls."""

    words: torch.Tensor
    counts: torch.Tensor

    def rank1(self, i: torch.Tensor) -> torch.Tensor:
        return bv_rank1(self.words, self.counts, i)

    def get(self, i: torch.Tensor) -> torch.Tensor:
        return bv_get(self.words, i)
