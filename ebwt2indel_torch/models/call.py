"""Batched per-cluster variant analysis: base counts, consensus left context
and right context (counterpart of ``ebwt2indel_tpu/models/call.py``;
reference find_variants, ebwt2InDel.cpp:840-1096; extract_consensus,
243-319; extract_dna, 325-342).

All clusters (and all 4 candidate characters) advance their backward and
forward walks in lockstep, k_left / k_right steps with masked early exit.

Quirks kept:
* base counts map TERM to 'A' (include.hpp:275-289), so terminators inside
  a cluster inflate the A count;
* consensus ties prefer A<C<G<T (cpp:252-255): ``torch.argmax`` returns the
  first maximum;
* the context is built variant-first and then reversed;
* support = occurrences of the starting character in the cluster range
  (cpp:310), excluding TERM.
"""

from __future__ import annotations

import torch

from ..ops import rank
from . import fm_index as fm_ops
from .fm_index import FMIndex

_LOW32 = 0xFFFFFFFF
_NO_BIT = 1 << 30  # "no set bit" sentinel above every in-block offset


def range_counts(fm: FMIndex, begins: torch.Tensor, ends: torch.Tensor):
    """Counts of A,C,G,T in BWT[begin:end) with the TERM->A quirk, and the
    pure (quirk-free) counts. Both endpoints go in one rank launch."""
    r = fm_ops.parallel_rank(fm, torch.stack([begins, ends], dim=-1))
    pure = r[:, 1] - r[:, 0]  # (B, 4)
    quirk = pure.clone()
    quirk[:, 0] += (ends - begins) - pure.sum(-1)
    return quirk, pure


def extract_consensus_batch(fm: FMIndex, begins: torch.Tensor,
                            ends: torch.Tensor, *, k_left: int):
    """For every cluster and every c in {A,C,G,T}: the consensus left context
    of length k_left ending with c, its support, and whether it reached full
    length. Returns (ctx (B,4,k_left) int8 codes, support (B,4) int64,
    full (B,4) bool)."""
    B = begins.shape[0]
    lo4, hi4 = fm_ops.lf_range(fm, begins, ends)  # (B, 4)
    support = hi4 - lo4
    ctx = torch.zeros((B * 4, k_left), dtype=torch.int8, device=begins.device)
    ctx[:, 0] = torch.arange(4, dtype=torch.int8,
                             device=begins.device).repeat(B)
    alive = (support > 0).reshape(-1)  # empty start range stops after char 0
    length = torch.ones(B * 4, dtype=torch.int64, device=begins.device)
    lo = lo4.reshape(-1)
    hi = hi4.reshape(-1)
    for step in range(1, k_left):
        l4, h4 = fm_ops.lf_range(fm, lo, hi)
        cnt = h4 - l4  # (B*4, 4)
        best = torch.argmax(cnt, dim=-1, keepdim=True)  # first max wins
        bc = torch.gather(cnt, 1, best)[:, 0]
        alive = alive & (bc > 0)
        lo = torch.where(alive, torch.gather(l4, 1, best)[:, 0], lo)
        hi = torch.where(alive, torch.gather(h4, 1, best)[:, 0], hi)
        ctx[:, step] = torch.where(alive, best[:, 0].to(torch.int8),
                                   ctx[:, step])
        length += alive.to(torch.int64)
    # the context was built variant-first; reverse to genomic order
    ctx = ctx.flip(1)
    full = length == k_left
    return ctx.reshape(B, 4, k_left), support, full.reshape(B, 4)


def extract_dna_batch(fm: FMIndex, starts: torch.Tensor, active: torch.Tensor,
                      *, k_right: int):
    """Forward extraction of up to k_right characters starting at F position
    ``starts``; stops at TERM (extract_dna, ebwt2InDel.cpp:325-342).
    Returns (seq (B, k_right) int8 codes, length (B,) int64)."""
    B = starts.shape[0]
    seq = torch.zeros((B, k_right), dtype=torch.int8, device=starts.device)
    length = torch.zeros(B, dtype=torch.int64, device=starts.device)
    i, alive = starts, active
    for step in range(k_right):
        c = fm_ops.f_char(fm, i)
        alive = alive & (c != 4)
        seq[:, step] = torch.where(alive, c.to(torch.int8), seq[:, step])
        length += alive.to(torch.int64)
        # dead rows walk from 0; fl keeps them in bounds, the result is unused
        i = torch.where(alive, fm_ops.fl(fm, torch.where(alive, i, 0)), i)
    return seq, length


def next_set_table(thr_R: torch.Tensor) -> torch.Tensor:
    """next_set[i] = smallest j >= i with thr_R[j] set (n if none): a
    cumulative minimum over the flipped vector."""
    n = thr_R.shape[0]
    idx = torch.where(thr_R != 0,
                      torch.arange(n, dtype=torch.int64, device=thr_R.device),
                      n)
    return torch.cummin(idx.flip(0), dim=0).values.flip(0)


def _lowest_bit(w: torch.Tensor) -> torch.Tensor:
    """Index of the lowest set bit of int64 words in [0, 2^32), _NO_BIT
    where a word is 0."""
    low = w & -w
    return torch.where(w != 0, rank.popcount32(low - 1), _NO_BIT)


def _anchor_from_words(words: torch.Tensor, n: int):
    """The bit-packed route's right-context anchor structure (words, T)
    from its thr_R words (``ops/bits.py`` layout; call.py:187, :214):
    T[b] = the first set position >= 128 * b (n if none), nb + 1 entries
    with T[nb] = n. The reverse cumulative minimum runs over the nb block
    entries, not over n positions."""
    w = words.to(torch.int64) & _LOW32
    slot = torch.arange(0, 128, 32, device=w.device)  # bit 0 of each word
    first = (_lowest_bit(w).view(-1, 4) + slot).min(1).values
    nb = first.shape[0]
    blk = torch.where(first < 128,
                      torch.arange(nb, device=w.device) * 128 + first, n)
    T = torch.cummin(blk.flip(0), 0).values.flip(0)
    return words, torch.cat([T, T.new_full((1,), n)])


def first_thr_position_device(next_set, begins: torch.Tensor,
                              ends: torch.Tensor):
    """For each cluster the first position in [begin, end) with thr_R set
    (the right-context anchor, cpp:979-985): returns (pos, found).
    ``next_set`` is the dense route's ``next_set_table`` or the packed
    route's (words, T); with (words, T) it is one word-row gather, the
    lowest set bit at or after the in-block offset, else T[b + 1]
    (call.py:229-249)."""
    if isinstance(next_set, tuple):
        words, T = next_set
        b = begins >> 7
        slot = torch.arange(0, 128, 32, device=begins.device)
        start = ((begins & 127)[:, None] - slot).clamp(0, 32)
        m = rank._bv_row(words, b) & ~((1 << start) - 1)
        off = (_lowest_bit(m) + slot).min(1).values
        pos = torch.where(off < 128, b * 128 + off, T[b + 1])
    else:
        pos = next_set[begins.clamp(0, next_set.shape[0] - 1)]
    found = pos < ends
    return torch.where(found, pos, 0), found
