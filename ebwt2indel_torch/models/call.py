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

import dataclasses
from collections.abc import Callable
from functools import partial

import torch

from ..ops import rank, scan
from . import fm_index as fm_ops
from .fm_index import FMIndex

_LOW32 = 0xFFFFFFFF
_NO_BIT = 1 << 30  # "no set bit" sentinel above every in-block offset


@dataclasses.dataclass(frozen=True)
class Walks:
    """The three calling walks over an index given by its rank, its select
    and its F boundaries, on ``device``: one device's index (``of``), or
    the mesh's, whose rank and select each query's owning shard answers
    (``parallel/pipeline.py::OnMesh.walks``)."""

    rank: Callable  # positions (...) -> A,C,G,T counts before each (..., 4)
    select: Callable  # (r, c) -> the position of the (r+1)-th c
    F: torch.Tensor  # (4,) int64: ``FMIndex.F``
    device: torch.device

    @staticmethod
    def of(fm: FMIndex) -> Walks:
        return Walks(partial(fm_ops.parallel_rank, fm),
                     partial(rank.select, fm.blocks, fm.block_counts), fm.F,
                     fm.device)

    def range_counts(self, begins: torch.Tensor, ends: torch.Tensor):
        """Counts of A,C,G,T in BWT[begin:end) with the TERM->A quirk, and
        the pure (quirk-free) counts. Both endpoints go in one rank launch
        (call.py:28 of the JAX package)."""
        r = self.rank(torch.stack([begins, ends], dim=-1))
        pure = r[:, 1] - r[:, 0]  # (B, 4)
        quirk = pure.clone()
        quirk[:, 0] += (ends - begins) - pure.sum(-1)
        return quirk, pure

    def _lf_range(self, lo: torch.Tensor, hi: torch.Tensor):
        """``fm_index.lf_range`` over this rank."""
        r = self.rank(torch.stack([lo, hi], dim=-1))
        return self.F + r[..., 0, :], self.F + r[..., 1, :]

    def consensus(self, begins: torch.Tensor, ends: torch.Tensor,
                  k_left: int):
        """For every cluster and every c in {A,C,G,T}: the consensus left
        context of length k_left ending with c, its support, and whether it
        reached full length. Returns (ctx (B,4,k_left) int8 codes, support
        (B,4) int64, full (B,4) bool)."""
        B = begins.shape[0]
        lo4, hi4 = self._lf_range(begins, ends)  # (B, 4)
        support = hi4 - lo4
        ctx = torch.zeros((B * 4, k_left), dtype=torch.int8,
                          device=begins.device)
        ctx[:, 0] = torch.arange(4, dtype=torch.int8,
                                 device=begins.device).repeat(B)
        # an empty start range stops after char 0
        alive = (support > 0).reshape(-1)
        length = torch.ones(B * 4, dtype=torch.int64, device=begins.device)
        lo = lo4.reshape(-1)
        hi = hi4.reshape(-1)
        for step in range(1, k_left):
            l4, h4 = self._lf_range(lo, hi)
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

    def _fl(self, i: torch.Tensor) -> torch.Tensor:
        """``fm_index.fl`` over this select."""
        cc = fm_ops.f_char(self, i).clamp(0, 3)
        return self.select((i - self.F[cc]).clamp_min(0), cc)

    def dna(self, starts: torch.Tensor, active: torch.Tensor, k_right: int):
        """Forward extraction of up to k_right characters starting at F
        position ``starts``; stops at TERM (extract_dna,
        ebwt2InDel.cpp:325-342). Returns (seq (B, k_right) int8 codes,
        length (B,) int64)."""
        B = starts.shape[0]
        seq = torch.zeros((B, k_right), dtype=torch.int8,
                          device=starts.device)
        length = torch.zeros(B, dtype=torch.int64, device=starts.device)
        i, alive = starts, active
        for step in range(k_right):
            c = fm_ops.f_char(self, i)
            alive = alive & (c != 4)
            seq[:, step] = torch.where(alive, c.to(torch.int8), seq[:, step])
            length += alive.to(torch.int64)
            # dead rows walk from 0; fl keeps them in bounds, the result is
            # unused
            i = torch.where(alive, self._fl(torch.where(alive, i, 0)), i)
        return seq, length


def _lowest_bit(w: torch.Tensor) -> torch.Tensor:
    """Index of the lowest set bit of int64 words in [0, 2^32), _NO_BIT
    where a word is 0."""
    low = w & -w
    return torch.where(w != 0, rank.popcount32(low - 1), _NO_BIT)


def _anchor_from_words(words: torch.Tensor, n: int):
    """The bit-packed route's right-context anchor structure (words, T)
    from its thr_R words (``ops/bits.py`` layout; call.py:187, :214):
    T[b] = the first set position >= 128 * b (n if none), nb + 1 entries
    with T[nb] = n. The next-set op runs over the nb blocks' "has a set
    bit" flags, not over n positions, and one gather reads each block's
    first bit."""
    w = words.to(torch.int64) & _LOW32
    slot = torch.arange(0, 128, 32, device=w.device)  # bit 0 of each word
    first = (_lowest_bit(w).view(-1, 4) + slot).min(1).values
    nb = first.shape[0]
    b = scan.next_set(first < 128)  # the first block >= b with a set bit
    T = torch.where(b < nb, b * 128 + first[b.clamp_max(max(nb - 1, 0))],
                    n)
    return words, torch.cat([T, T.new_full((1,), n)])


def first_thr_position_device(next_set: torch.Tensor, begins: torch.Tensor,
                              ends: torch.Tensor):
    """For each cluster the first position in [begin, end) with thr_R set
    (the right-context anchor, cpp:979-985): returns (pos, found).
    ``next_set`` is the dense route's next-set table (``scan.next_set``:
    next_set[i] = the smallest j >= i with thr_R[j] set, n if none)."""
    return _found(next_set[begins.clamp(0, next_set.shape[0] - 1)], ends)


def first_thr_position_packed(words: torch.Tensor, T: torch.Tensor,
                              begins: torch.Tensor, ends: torch.Tensor):
    """``first_thr_position_device`` over the bit-packed route's (words, T)
    (``_anchor_from_words``): one word-row gather, the lowest set bit at or
    after the in-block offset, else T[b + 1] (call.py:229-249)."""
    b = begins >> 7
    slot = torch.arange(0, 128, 32, device=begins.device)
    start = ((begins & 127)[:, None] - slot).clamp(0, 32)
    m = rank._bv_row(words, b) & ~((1 << start) - 1)
    off = (_lowest_bit(m) + slot).min(1).values
    return _found(torch.where(off < 128, b * 128 + off, T[b + 1]), ends)


def _found(pos: torch.Tensor, ends: torch.Tensor):
    found = pos < ends
    return torch.where(found, pos, 0), found
