"""Wavefront traversal of the implicit suffix tree (counterpart of
``ebwt2indel_tpu/models/traverse.py::navigate_one_bwt``; reference
ebwt2InDel.cpp:555-676).

Every write of the traversal (LCP-threshold bits, LCP-minima bits) targets a
position fixed by the visited node alone, independent of visit order
(traverse.py:6-12 of the JAX package). So a host loop over chunks of a FIFO
of device tensors is exact: it pops up to ``CHUNK`` rows, runs one batched
step on them, and queues the surviving children.

* Leaf step (``_leaf_body``): ±1 boundary deltas at first+1 and second, in
  separate int32 K and R delta vectors (the exact int32-per-field layout of
  ``_leaf_body_wide``), then the left extensions of size >= 2.
* Node step (``_node_body``): border flags (1 = thr_K, 2 = thr_R) and minima
  marks (4) added into a per-position uint8 flag vector, then the Weiner
  extension by the 4 nucleotides, keeping children with >= 2 children.
* After both phases: a prefix sum of the deltas gives the leaf-interior
  fills, and thr_K = flag bit 1 | fill_K, thr_R = bit 2 | fill_R.

Two routes give the same flags (``packed=`` of the navigate functions):

* dense, below ``LEAN_N`` positions: each result is an (n,) uint8 vector;
* bit-packed (``navigate_one_bwt``'s ``huge`` branch, traverse.py:1511-1582
  of the JAX package): the prefix sums run slice by slice with a running
  carry and come out as packed words, each delta vector freed as soon as its
  fill is packed, and every result is words in the ``ops/bits.py`` layout.
  Peak memory is the leaf phase's int32 delta vectors, not the n-sized int64
  temporaries of the dense calling passes.

Mode 2 walks the suffix trees of two indexes in lockstep
(``navigate_two_bwts``; reference ebwt2InDel.cpp:679-831): a row holds the
node's boundaries in both, and the merged collection's are their sums. The
leaf-pair step adds a third delta vector, the document array (DA), and the
node-pair step adds flag bit 8 for the DA of size-1 leaves.
"""

from __future__ import annotations

import collections
import dataclasses
import time

import torch

from ..device import synchronize
from ..ops import bits
from . import fm_index as fm_ops
from .fm_index import FMIndex

CHUNK = 256 * 1024  # rows popped per step (traverse.py:39)

# The route switch (the JAX package's _LEAN_N = 2**27, traverse.py:1221, was
# sized for a 16 GB TPU). On an 80 GB H100 the dense route peaked at 35.75 B
# per position: 4,152,354,816 B at 116,149,697 positions and
# 37,552,146,432 B at 1,050,398,182. At 2**30 positions that is 38.4 GB,
# under half the card; at 2**31 it would be 76.8 GB, past what the card
# leaves free. So inputs from 2**30 positions on take the bit-packed route
# (9.09 B per position at 1,050,398,182).
LEAN_N = 2**30
# positions per slice of the packed route's passes (traverse.py:1222)
LEAN_SLICE = 2**24


@dataclasses.dataclass
class TraversalResult:
    """Flag vectors + diagnostics (the reference's globals LCP_threshold /
    LCP_minima, ebwt2InDel.cpp:56-58). With ``packed`` each flag vector is
    instead (4 * (n // 128 + 1),) int32 words in the ``ops/bits.py``
    layout, pad bits 0."""

    thr_K: torch.Tensor  # (n,) uint8 — LCP_threshold[2i]   (LCP[i] >= K)
    thr_R: torch.Tensor  # (n,) uint8 — LCP_threshold[2i+1] (LCP[i] >= k_right)
    minima: torch.Tensor  # (n,) uint8
    stats: dict
    da: torch.Tensor | None = None  # (n,) uint8, 1 = collection 2 (mode 2)
    packed: bool = False


def _char_major(children: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Kept rows of (C, 4, w) children in char-major order: children that
    extend by the same character live in the same F-region, so neighbouring
    queue rows read nearby block rows (the order is otherwise free)."""
    return children.transpose(0, 1)[keep.transpose(0, 1)]


def _add_bounds(dif: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor):
    """+1 at each ``lo`` and -1 at each ``hi`` of an int32 delta vector: its
    prefix sum is > 0 exactly on the union of the ranges [lo, hi)."""
    idx = torch.cat([lo, hi])
    val = torch.ones_like(idx, dtype=torch.int32)
    val[lo.shape[0]:] = -1
    dif.index_add_(0, idx, val)


def _border_values(coords: torch.Tensor, depth: torch.Tensor, stats,
                   K: int, k_right: int) -> torch.Tensor:
    """Flag values at the borders j = 1..4 of nodes given by their 6
    boundaries (C, 6) and depth (C, 1): 1 = thr_K and 2 = thr_R where the
    border is not empty and not ``last`` (update_lcp_threshold,
    include.hpp:826-860), 4 = an LCP minimum where the previous child has
    >= 2 positions (update_lcp_minima, ebwt2InDel.cpp:357-391).
    Returns (C, 4) uint8; adds the LCP and minima counts to stats[1:3]."""
    last = coords[:, 5:6]
    border = coords[:, 1:5]
    prev = coords[:, 0:4]  # their left neighbours j-1
    cond = (border > prev) & (border != last)
    v = (cond & (depth >= K)).to(torch.uint8) \
        + (cond & (depth >= k_right)).to(torch.uint8) * 2
    # minima at borders j >= 2 (the first column is border j = 1)
    cond_m = ((border - prev) >= 2) & (border < last - 1)
    cond_m[:, 0] = False
    v += cond_m.to(torch.uint8) * 4
    stats[1] += cond.sum()
    stats[2] += cond_m.sum()
    return v


def _leaf_body(fm: FMIndex, chunk, difs, stats, K: int, k_right: int):
    """Suffix-tree leaf step (reference update_LCP_leaf,
    ebwt2InDel.cpp:344-355; next_leaves, dna_bwt.hpp:358-379).
    chunk: (C, 3) [first, second, depth]."""
    first, second, depth = chunk.unbind(1)
    for dif, bound in zip(difs, (K, k_right)):
        on = depth >= bound
        _add_bounds(dif, first[on] + 1, second[on])
    stats[0] += chunk.shape[0]
    stats[1] += (second - first - 1).sum()

    lo4, hi4 = fm_ops.lf_range(fm, first, second)  # (C, 4)
    children = torch.stack(
        [lo4, hi4, (depth + 1)[:, None].expand_as(lo4)], dim=-1)
    return _char_major(children, (hi4 - lo4) >= 2)


def _node_body(fm: FMIndex, chunk, flags, stats, K: int, k_right: int):
    """Internal-node step: border LCP writes, minima marks, Weiner-link
    extension (update_lcp_threshold include.hpp:826-860; update_lcp_minima
    ebwt2InDel.cpp:357-391; next_nodes dna_bwt.hpp:381-404).
    chunk: (C, 7)."""
    v = _border_values(chunk[:, :6], chunk[:, 6:7], stats, K, k_right)
    # each flagged position is written by exactly one (node, border) over the
    # whole traversal, so the add never collides (traverse.py:432-436)
    border = chunk[:, 1:5]
    on = v > 0
    flags.index_add_(0, border[on], v[on])
    stats[0] += chunk.shape[0]

    ext = fm_ops.extend_node(fm, chunk)  # (C, 4, 7)
    return _char_major(ext, fm_ops.node_num_children(ext) >= 2)


def _leaf_pair_body(fm1: FMIndex, fm2: FMIndex, chunk, difs, stats, K: int,
                    k_right: int):
    """Leaf-pair step of the lockstep two-index traversal, in the
    int32-per-field layout of ``_leaf_pair_body_wide`` (traverse.py:589-626;
    update_DA, ebwt2InDel.cpp:394-425). chunk: (C, 5) [f1, s1, f2, s2,
    depth]. In the merged collection the leaf covers [f1+f2, s1+s2), its
    collection-1 part first: K and R fill (f1+f2, end) and DA fills
    [f2+s1, end), the collection-2 part. Children are kept when the two
    sides together hold >= 2 positions (cpp:452-472); size-1 leaves are
    recovered in the node phase."""
    f1, s1, f2, s2, depth = chunk.unbind(1)
    start1 = f1 + f2
    end = s1 + s2
    for dif, bound in zip(difs[:2], (K, k_right)):
        on = depth >= bound
        _add_bounds(dif, start1[on] + 1, end[on])
    _add_bounds(difs[2], f2 + s1, end)
    stats[0] += chunk.shape[0]
    stats[1] += (end - start1 - 1).sum()
    stats[2] += (end - start1).sum()  # da_values

    lo1, hi1 = fm_ops.lf_range(fm1, f1, s1)  # (C, 4)
    lo2, hi2 = fm_ops.lf_range(fm2, f2, s2)
    children = torch.stack(
        [lo1, hi1, lo2, hi2, (depth + 1)[:, None].expand_as(lo1)], dim=-1)
    return _char_major(children, (hi1 - lo1) + (hi2 - lo2) >= 2)


def _node_pair_body(fm1: FMIndex, fm2: FMIndex, chunk, flags, stats, K: int,
                    k_right: int):
    """Node-pair step (traverse.py:629-710): size-1 leaf recovery
    (find_leaves, ebwt2InDel.cpp:474-527), the merged node's LCP and minima
    flags (cpp:792-802), and the pairwise Weiner extension keeping pairs
    with >= 2 union children (cpp:529-553). chunk: (C, 13) = the 6
    boundaries in each index, then the depth. The merged node's boundaries
    are their sums (include.hpp:476-490)."""
    c1 = chunk[:, 0:6]
    c2 = chunk[:, 6:12]
    depth = chunk[:, 12:13]
    merged = c1 + c2
    # find_leaves: a child interval of one merged position is a leaf; it
    # counts as a DA value, and DA = 1 when it comes from collection 2
    l1 = c1[:, 1:] - c1[:, :-1]
    l2 = c2[:, 1:] - c2[:, :-1]
    single = (l1 + l2) == 1
    v = (single & (l2 == 1)).to(torch.uint8) * 8  # at merged[:, 0:5]
    v[:, 1:] += _border_values(merged, depth, stats, K, k_right)
    # a singleton position gets its DA bit from exactly one node pair, and
    # the LCP bits are written once each as in mode 1 (traverse.py:647-649),
    # so the bits add without carries
    pos = merged[:, 0:5]
    on = v > 0
    flags.index_add_(0, pos[on], v[on])
    stats[0] += chunk.shape[0]
    stats[3] += single.sum()

    ext1 = fm_ops.extend_coords(fm1, c1)  # (C, 4, 6)
    ext2 = fm_ops.extend_coords(fm2, c2)
    union = (ext1[..., 1:] > ext1[..., :-1]) | (ext2[..., 1:] > ext2[..., :-1])
    children = torch.cat(
        [ext1, ext2, (depth + 1)[:, None, :].expand(-1, 4, 1)], dim=-1)
    return _char_major(children, union.sum(-1) >= 2)


def _run_phase(init: torch.Tensor, step) -> int:
    """Drain a FIFO of device row tensors in chunks of up to CHUNK rows;
    ``step(chunk)`` returns the children to queue. Returns the largest
    pending count seen (it depends on visit order; diagnostic only)."""
    pending = collections.deque([init])
    n_pending = max_pending = init.shape[0]
    while pending:
        parts, need = [], CHUNK
        while pending and need:
            head = pending[0]
            if head.shape[0] <= need:
                parts.append(pending.popleft())
                need -= head.shape[0]
            else:
                parts.append(head[:need])
                pending[0] = head[need:]
                need = 0
        chunk = parts[0] if len(parts) == 1 else torch.cat(parts)
        n_pending -= chunk.shape[0]
        children = step(chunk)
        if children.shape[0]:
            pending.append(children)
            n_pending += children.shape[0]
        max_pending = max(max_pending, n_pending)
    return max_pending


def _slice_len(slice_len: int | None) -> int:
    L = LEAN_SLICE if slice_len is None else slice_len
    if L <= 0 or L % 32:
        raise ValueError(f"slice length {L} is not a positive multiple of 32")
    return L


def _n_words(n: int) -> int:
    """Words of an n-position packed vector: n // 128 + 1 blocks of 4."""
    return bits.WPB * (n // bits.BLOCK + 1)


def _fills_packed(difs: list, n: int,
                  slice_len: int | None = None) -> list[torch.Tensor]:
    """Bit-packed fills of int32 delta vectors (traverse.py:1248-1318 of the
    JAX package): the prefix sum of each vector over [0, n), slice by slice
    with a running int32 carry, is > 0 exactly on its fill. Each comes out
    as packed words (``_n_words(n)``, pad bits 0).

    ``difs`` is emptied: each vector is dropped as soon as its fill is
    packed, so at most one slice's sum lives beside the vectors.
    ``slice_len`` (a multiple of 32) defaults to ``LEAN_SLICE``."""
    L = _slice_len(slice_len)
    fills = []
    while difs:
        d = difs.pop(0)
        words = torch.zeros(_n_words(n), dtype=torch.int32, device=d.device)
        carry = torch.zeros((), dtype=torch.int32, device=d.device)
        for lo in range(0, n, L):
            cs = torch.cumsum(d[lo:min(lo + L, n)], 0,
                              dtype=torch.int32) + carry
            carry = cs[-1]
            w = bits.pack_bits(cs > 0)
            words[lo // 32:lo // 32 + w.shape[0]] = w
        del d
        fills.append(words)
    return fills


def _combine_packed(flags: torch.Tensor, fills: list, n: int,
                    slice_len: int | None = None) -> list[torch.Tensor]:
    """Packed thr_K = (flags & 1) | fill_K, thr_R = (flags & 2) | fill_R,
    minima = flags & 4 and, with a third fill, da = (flags & 8) | fill_D
    (traverse.py:1424-1490), slice by slice from the (n,) uint8 node flags.
    The flag bits are packed and OR-ed into the fill words in place."""
    L = _slice_len(slice_len)
    outs = [fills[0], fills[1], torch.zeros_like(fills[0]), *fills[2:]]
    for lo in range(0, n, L):
        f = flags[lo:lo + L]
        for bit, out in zip((1, 2, 4, 8), outs):
            w = bits.pack_bits((f & bit) != 0)
            out[lo // 32:lo // 32 + w.shape[0]] |= w
    return outs


def _fills_dense(difs: list, n: int) -> list[torch.Tensor]:
    """The dense route's fills, (n,) bool each; ``difs`` is emptied."""
    fills = [torch.cumsum(d[:n], 0, dtype=torch.int32) > 0 for d in difs]
    difs.clear()
    return fills


def _combine_dense(flags: torch.Tensor, fills: list) -> list[torch.Tensor]:
    """The dense route's thr_K, thr_R, minima (and da) as (n,) uint8."""
    outs = [((flags & 1).bool() | fills[0]).to(torch.uint8),
            ((flags & 2).bool() | fills[1]).to(torch.uint8),
            (flags >> 2) & 1]
    if len(fills) == 3:
        outs.append(((flags & 8).bool() | fills[2]).to(torch.uint8))
    return outs


def navigate_one_bwt(fm: FMIndex, K: int, k_right: int,
                     packed: bool | None = None,
                     slice_len: int | None = None) -> TraversalResult:
    """Single-BWT navigation (reference navigate_one_bwt,
    ebwt2InDel.cpp:555-676): the leaf phase, then the node phase.
    ``packed=None`` takes the bit-packed route from ``LEAN_N`` positions on;
    True or False forces a route. ``stats`` carries the counts of the JAX
    package plus the seconds of each phase (``leaf_seconds``,
    ``node_seconds``)."""
    n, dev = fm.n, fm.device
    if packed is None:
        packed = n >= LEAN_N
    t0 = time.perf_counter()
    difs = [torch.zeros(n + 1, dtype=torch.int32, device=dev)
            for _ in range(2)]  # K, R
    st_l = torch.zeros(2, dtype=torch.int64, device=dev)  # leaves, lcp
    maxp_l = _run_phase(
        fm.first_leaf()[None, :],
        lambda c: _leaf_body(fm, c, difs, st_l, K, k_right))
    fills = (_fills_packed(difs, n, slice_len) if packed
             else _fills_dense(difs, n))
    synchronize(dev)
    t1 = time.perf_counter()

    flags = torch.zeros(n, dtype=torch.uint8, device=dev)
    st_n = torch.zeros(3, dtype=torch.int64, device=dev)  # nodes, lcp, n_min
    maxp_n = _run_phase(
        fm.root()[None, :],
        lambda c: _node_body(fm, c, flags, st_n, K, k_right))
    thr_K, thr_R, minima = (_combine_packed(flags, fills, n, slice_len)
                            if packed else _combine_dense(flags, fills))
    del flags, fills
    synchronize(dev)
    t2 = time.perf_counter()

    l, n_ = st_l.tolist(), st_n.tolist()
    stats = {
        "leaves": l[0], "nodes": n_[0], "lcp_values": 1 + l[1] + n_[1],
        "n_min": n_[2], "max_pending": max(maxp_l, maxp_n),
        "leaf_seconds": t1 - t0, "node_seconds": t2 - t1,
    }
    return TraversalResult(thr_K=thr_K, thr_R=thr_R, minima=minima,
                           stats=stats, packed=packed)


def navigate_two_bwts(fm1: FMIndex, fm2: FMIndex, K: int, k_right: int,
                      packed: bool | None = None,
                      slice_len: int | None = None) -> TraversalResult:
    """Lockstep navigation of two suffix trees that simulates the merged
    collection (reference navigate_two_bwts, ebwt2InDel.cpp:679-831): the
    leaf-pair phase, then the node-pair phase, over n = n1 + n2 merged
    positions. ``da`` is the merged document array. ``packed`` chooses the
    route as in ``navigate_one_bwt``, over the merged n. ``stats`` adds
    ``da_values`` to the counts of ``navigate_one_bwt``."""
    n, dev = fm1.n + fm2.n, fm1.device
    if packed is None:
        packed = n >= LEAN_N
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    t0 = time.perf_counter()
    difs = [torch.zeros(n + 1, dtype=torch.int32, device=dev)
            for _ in range(3)]  # K, R, DA
    st_l = torch.zeros(3, dtype=torch.int64, device=dev)  # leaves, lcp, da
    maxp_l = _run_phase(
        torch.cat([fm1.first_leaf()[:2], fm2.first_leaf()[:2], zero])[None],
        lambda c: _leaf_pair_body(fm1, fm2, c, difs, st_l, K, k_right))
    fills = (_fills_packed(difs, n, slice_len) if packed
             else _fills_dense(difs, n))
    synchronize(dev)
    t1 = time.perf_counter()

    flags = torch.zeros(n, dtype=torch.uint8, device=dev)
    # nodes, lcp, n_min, da
    st_n = torch.zeros(4, dtype=torch.int64, device=dev)
    maxp_n = _run_phase(
        torch.cat([fm1.root()[:6], fm2.root()[:6], zero])[None],
        lambda c: _node_pair_body(fm1, fm2, c, flags, st_n, K, k_right))
    thr_K, thr_R, minima, da = (_combine_packed(flags, fills, n, slice_len)
                                if packed else _combine_dense(flags, fills))
    del flags, fills
    synchronize(dev)
    t2 = time.perf_counter()

    l, n_ = st_l.tolist(), st_n.tolist()
    stats = {
        "leaves": l[0], "nodes": n_[0], "lcp_values": 1 + l[1] + n_[1],
        "n_min": n_[2], "da_values": l[2] + n_[3],
        "max_pending": max(maxp_l, maxp_n),
        "leaf_seconds": t1 - t0, "node_seconds": t2 - t1,
    }
    return TraversalResult(thr_K=thr_K, thr_R=thr_R, minima=minima,
                           stats=stats, da=da, packed=packed)
