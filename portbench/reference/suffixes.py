"""Suffix sorting of a read collection in plain PyTorch: the order of the
extended BWT (eBWT) and the LCP array between neighbouring suffixes.

A collection is R reads of L bases each, codes 0..3 for A, C, G, T, every
read followed by its own terminator. Terminators are distinct, smaller
than every base and ordered by their read, so suffixes are ordered by
their bases up to the terminator, a proper prefix first, and equal ones by
read. Suffix ``r * (L + 1) + o`` starts at base ``o`` of read ``r``
(``o = L`` is the terminator alone).

The sort is a least-significant-first series of stable sorts over the
suffixes' bases packed 21 to an int64 word (3 bits a symbol, the
terminator and the padding after it 0), so it runs as a few large device
calls. Nothing here reads an eBWT file or any structure the program makes.
"""

from __future__ import annotations

import torch

SYMS_PER_WORD = 21  # 3-bit symbols in a non-negative int64
ASCII = torch.tensor(list(b"#ACGT"), dtype=torch.uint8)  # symbol 0..4


def _n_words(L: int) -> int:
    return -(-L // SYMS_PER_WORD)


def suffix_word(reads: torch.Tensor, k: int) -> torch.Tensor:
    """Word ``k`` of every suffix, (R * (L + 1),) int64: its symbols
    21k .. 21k + 20, the first in the highest bits."""
    R, L = reads.shape
    width = L + 1 + SYMS_PER_WORD * _n_words(L)
    sym = torch.zeros((R, width), dtype=torch.uint8, device=reads.device)
    sym[:, :L] = reads + 1
    w = torch.zeros((R, L + 1), dtype=torch.int64, device=reads.device)
    for j in range(SYMS_PER_WORD):
        c = SYMS_PER_WORD * k + j
        w.mul_(8).add_(sym[:, c:c + L + 1])
    return w.reshape(-1)


def sort_suffixes(reads: torch.Tensor) -> torch.Tensor:
    """The suffix ids of a collection (R, L) in eBWT order, (R * (L + 1),)
    int64."""
    R, L = reads.shape
    order = torch.arange(R * (L + 1), dtype=torch.int64, device=reads.device)
    for k in reversed(range(_n_words(L))):
        key = suffix_word(reads, k)[order]
        order = order[torch.sort(key, stable=True).indices]
        del key
    return order


def bwt_codes(reads: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """The eBWT as symbols 0..4 (terminator, A, C, G, T): the base before
    each suffix, the terminator before a read's first base."""
    L = reads.shape[1]
    r = order // (L + 1)
    o = order % (L + 1)
    prev = reads[r, (o - 1).clamp_min(0)].to(torch.uint8) + 1
    return torch.where(o > 0, prev, torch.zeros_like(prev))


def to_ascii(sym: torch.Tensor) -> bytes:
    """Symbols 0..4 as the bytes ``#ACGT`` of an eBWT file."""
    return ASCII.to(sym.device)[sym.long()].cpu().numpy().tobytes()


def _first_symbol(x: torch.Tensor) -> torch.Tensor:
    """Index (0..20) of the first non-zero 3-bit symbol of non-zero
    words, the first in the highest bits. Integer shifts only: a float
    logarithm is not exact at powers of two on every device."""
    first = torch.full_like(x, SYMS_PER_WORD)
    for j in reversed(range(SYMS_PER_WORD)):
        on = ((x >> (3 * (SYMS_PER_WORD - 1 - j))) & 7) != 0
        first = torch.where(on, j, first)
    return first


def lcp(reads: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """LCP[i] = the bases that suffixes order[i - 1] and order[i] share
    before either ends (LCP[0] = 0), int32."""
    R, L = reads.shape
    n = order.shape[0]
    shared = torch.full((n,), SYMS_PER_WORD * _n_words(L), dtype=torch.int64,
                        device=reads.device)
    open_ = torch.ones(n, dtype=torch.bool, device=reads.device)
    for k in range(_n_words(L)):
        w = suffix_word(reads, k)[order]
        x = w[1:] ^ w[:-1]
        del w
        hit = (x != 0) & open_[1:]
        shared[1:][hit] = SYMS_PER_WORD * k + _first_symbol(x[hit])
        open_[1:] &= ~hit
        del x
    length = L - order % (L + 1)
    out = torch.minimum(shared[1:], torch.minimum(length[1:], length[:-1]))
    return torch.cat([out.new_zeros(1), out]).to(torch.int32)
