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
  extension by the 4 nucleotides, keeping children with >= 2 children. A
  chunk on the card is one CUDA step (``ops/node_cuda.py``,
  ``csrc/node_step.cu``: three launches and one read of the count of
  children kept, the step's one wait on the card); a chunk on the CPU runs
  the plain PyTorch version, ``_node_body_plain``.
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

Checkpoint and resume (``ckpt_dir``, ``ckpt_every`` of the navigate
functions; traverse.py:1124-1206 of the JAX package): every ``ckpt_every``
chunks a phase saves its pending FIFO, its accumulators (delta vectors or
flags, and its counts) and ``max_pending`` to ``<ckpt_dir>/phase_<body>.pt``
through a temporary file and ``os.replace``, so a kill during a save leaves
the last good one. A phase resumes from a saved state whose ``n``, ``K``,
``k_right`` and row width match its own, else it starts fresh, and it
deletes the file when it completes. The writes do not depend on visit
order, so a resumed phase gives the uninterrupted flags and counts; only
``max_pending`` may differ.

``EBWT_PROGRESS`` (set and not ``0``; read when a phase starts) prints
``[progress] processed {p} items, {w} pending`` after each chunk, the JAX
package's line (traverse.py:973-977 there): p is the phase's count of
leaves or nodes so far, w the FIFO's pending rows. Reading p syncs the
device once a chunk, so it is off by default.
"""

from __future__ import annotations

import collections
import dataclasses
import os
from functools import partial

import torch

from ..device import synchronize
from ..ops import bits, node_cuda, rank, scan
from ..utils.profile import span
from . import call, cluster
from . import fm_index as fm_ops
from .fm_index import FMIndex

CHUNK = 256 * 1024  # rows popped per step (traverse.py:39)
# The span of a node step's wait on the device: on the card the step's one
# read of the count of children kept (mode 2's node-pair step: each of its
# two boolean-mask indexes, the flags' positions and the kept children)
# copies a count to the host, so the host waits there for all the step's
# work queued before it. The span holds that read alone; a synchronise of
# its own before it would add an idle round trip to the card per wait.
WAIT = "node_phase.wait"

# The route switch (the JAX package's _LEAN_N = 2**27, traverse.py:1221, was
# sized for a 16 GB TPU). On an 80 GB H100 the dense route peaks at
# 19.17-19.19 B per position from 116,149,697 to 1,050,398,182 positions,
# the packed route at 9.09 B per position at 1,050,398,182. Memory alone
# would keep the dense route on the card to about 3.9 G positions (75 GB),
# near the packer's CAP, so 2**30 is not a memory bound: which route is
# faster on either side of it is still to be measured.
LEAN_N = 2**30
# positions per slice of the packed route's passes (traverse.py:1222)
LEAN_SLICE = 2**24


@dataclasses.dataclass
class TraversalResult:
    """Flag vectors + diagnostics (the reference's globals LCP_threshold /
    LCP_minima, ebwt2InDel.cpp:56-58). With ``packed`` each flag vector is
    instead (4 * (n // 128 + 1),) int32 words in the ``ops/bits.py``
    layout, pad bits 0. The methods read the flags in their layout, so that
    no caller needs to know it; ``parallel/calling.py::ShardedTraversal``
    answers the same calls on the mesh."""

    thr_K: torch.Tensor  # (n,) uint8 — LCP_threshold[2i]   (LCP[i] >= K)
    thr_R: torch.Tensor  # (n,) uint8 — LCP_threshold[2i+1] (LCP[i] >= k_right)
    minima: torch.Tensor  # (n,) uint8
    stats: dict
    n: int
    da: torch.Tensor | None = None  # (n,) uint8, 1 = collection 2 (mode 2)
    packed: bool = False

    def anchor(self):
        """The right-context anchor, ``(begins, ends) -> (pos, found)``
        (``call.first_thr_position_*``), over a structure built from thr_R
        on the device's clock (span ``cluster.next_set``): the next-set
        table, or the packed route's (words, T). It holds that structure,
        not this result."""
        with span("cluster.next_set", device=self.thr_R.device):
            if self.packed:
                return partial(call.first_thr_position_packed,
                               *call._anchor_from_words(self.thr_R, self.n))
            return partial(call.first_thr_position_device,
                           scan.next_set(self.thr_R))

    def clusters(self, mcov_out: int) -> cluster.Clusters:
        """The clusters of thr_K and minima (``cluster.py``)."""
        if self.packed:
            return cluster.find_clusters_device_packed(
                self.thr_K, self.minima, n=self.n, mcov_out=mcov_out)
        return cluster.find_clusters_device(self.thr_K, self.minima,
                                            mcov_out)

    def da_rank(self) -> rank.BitRank:
        """Mode 2's document array as a rank structure: the packed route's
        DA is already words in its layout and needs only the counts."""
        if self.packed:
            return rank.BitRank(self.da, bits.bv_counts(self.da))
        return rank.BitRank(*bits.bv_build(self.da))


def _char_major(children: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Kept rows of (C, 4, w) children in char-major order: children that
    extend by the same character live in the same F-region, so neighbouring
    queue rows read nearby block rows (the order is otherwise free)."""
    return children.transpose(0, 1)[keep.transpose(0, 1)]


# The longest vector that one ``index_add_`` adds into. On CUDA, PyTorch's
# ``index_add_`` into a tensor of 2^31 elements or more does not launch
# ("invalid configuration argument", PyTorch 2.11 on an H100, at
# 2,206,844,243 positions), so adds into a longer vector go window by window.
ADD_WINDOW = 2**30


def add_at(x: torch.Tensor, idx: torch.Tensor, val: torch.Tensor) -> None:
    """``x.index_add_(0, idx, val)`` into a vector of any length: one
    ``index_add_`` per window of ``ADD_WINDOW`` elements, each with the
    entries that land in it."""
    n = x.shape[0]
    if n <= ADD_WINDOW:
        x.index_add_(0, idx, val)
        return
    for lo in range(0, n, ADD_WINDOW):
        m = (idx >= lo) & (idx < lo + ADD_WINDOW)
        x[lo:lo + ADD_WINDOW].index_add_(0, idx[m] - lo, val[m])


def _add_bounds(dif: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor):
    """+1 at each ``lo`` and -1 at each ``hi`` of an int32 delta vector: its
    prefix sum is > 0 exactly on the union of the ranges [lo, hi)."""
    idx = torch.cat([lo, hi])
    val = torch.ones_like(idx, dtype=torch.int32)
    val[lo.shape[0]:] = -1
    add_at(dif, idx, val)


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
    chunk: (C, 7). A CUDA chunk launches the node-step kernel (or raises);
    a CPU chunk runs the plain version."""
    if chunk.device.type == "cuda":
        return node_cuda.node_step(fm.blocks, fm.F, chunk, flags, stats, K,
                                   k_right, wait=partial(span, WAIT))
    return _node_body_plain(fm, chunk, flags, stats, K, k_right)


def _node_body_plain(fm: FMIndex, chunk, flags, stats, K: int,
                     k_right: int):
    """The node step in plain PyTorch ops, the kernel's arithmetic: the
    border values and their add into ``flags``, the counts into
    ``stats[0:3]``, and the kept children (M, 7) in ``_char_major``'s
    order."""
    v = _border_values(chunk[:, :6], chunk[:, 6:7], stats, K, k_right)
    # each flagged position is written by exactly one (node, border) over the
    # whole traversal, so the add never collides (traverse.py:432-436)
    border = chunk[:, 1:5]
    on = v > 0
    with span(WAIT):
        at = border[on]
    add_at(flags, at, v[on])
    stats[0] += chunk.shape[0]

    ext = fm_ops.extend_node(fm, chunk)  # (C, 4, 7)
    keep = fm_ops.node_num_children(ext) >= 2
    with span(WAIT):
        return _char_major(ext, keep)


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
    for dif, (lo, hi) in zip(difs, leaf_pair_bounds(chunk, stats, K,
                                                    k_right)):
        _add_bounds(dif, lo, hi)
    r1 = fm_ops.parallel_rank(fm1, chunk[:, 0:2])
    r2 = fm_ops.parallel_rank(fm2, chunk[:, 2:4])
    return leaf_pair_children(fm1.F, fm2.F, chunk, r1, r2)


def leaf_pair_bounds(chunk, stats, K: int, k_right: int):
    """The (lo, hi) ranges of the K, R and DA fills of leaf-pair rows
    (C, 5), in merged positions; adds the leaves, LCP and DA counts to
    stats[0:3]."""
    f1, s1, f2, s2, depth = chunk.unbind(1)
    start1 = f1 + f2
    end = s1 + s2
    stats[0] += chunk.shape[0]
    stats[1] += (end - start1 - 1).sum()
    stats[2] += (end - start1).sum()  # da_values
    on_k, on_r = depth >= K, depth >= k_right
    return ((start1[on_k] + 1, end[on_k]), (start1[on_r] + 1, end[on_r]),
            (f2 + s1, end))


def leaf_pair_children(F1, F2, chunk, r1, r2):
    """The left extensions of leaf-pair rows (C, 5) from the ranks (C, 2, 4)
    of their side-1 and side-2 boundaries, kept where the two sides
    together hold >= 2 positions."""
    lo1, hi1 = F1 + r1[:, 0], F1 + r1[:, 1]
    lo2, hi2 = F2 + r2[:, 0], F2 + r2[:, 1]
    children = torch.stack(
        [lo1, hi1, lo2, hi2, (chunk[:, 4] + 1)[:, None].expand_as(lo1)],
        dim=-1)
    return _char_major(children, (hi1 - lo1) + (hi2 - lo2) >= 2)


def _node_pair_body(fm1: FMIndex, fm2: FMIndex, chunk, flags, stats, K: int,
                    k_right: int):
    """Node-pair step (traverse.py:629-710): size-1 leaf recovery
    (find_leaves, ebwt2InDel.cpp:474-527), the merged node's LCP and minima
    flags (cpp:792-802), and the pairwise Weiner extension keeping pairs
    with >= 2 union children (cpp:529-553). chunk: (C, 13) = the 6
    boundaries in each index, then the depth."""
    pos, v = node_pair_values(chunk, stats, K, k_right)
    on = v > 0
    with span(WAIT):
        at = pos[on]
    # a singleton position gets its DA bit from exactly one node pair, and
    # the LCP bits are written once each as in mode 1 (traverse.py:647-649),
    # so the bits add without carries
    add_at(flags, at, v[on])
    ext1 = fm_ops.extend_coords(fm1, chunk[:, 0:6])  # (C, 4, 6)
    ext2 = fm_ops.extend_coords(fm2, chunk[:, 6:12])
    children, keep = node_pair_rows(ext1, ext2, chunk)
    with span(WAIT):
        return _char_major(children, keep)


def node_pair_flags(chunk, stats, K: int, k_right: int):
    """The nonzero flag values of node-pair rows (C, 13) and their merged
    positions (``node_pair_values`` where nonzero)."""
    pos, v = node_pair_values(chunk, stats, K, k_right)
    on = v > 0
    return pos[on], v[on]


def node_pair_values(chunk, stats, K: int, k_right: int):
    """The flag values (C, 5) of node-pair rows (C, 13) at their merged
    positions (C, 5): the merged node's boundaries are the sums of the two
    sides' (include.hpp:476-490). A child interval of one merged position
    is a leaf (find_leaves); it counts as a DA value, and DA = 1 (bit 8)
    when it comes from collection 2. Adds the nodes, LCP, minima and DA
    counts to stats[0:4]."""
    c1 = chunk[:, 0:6]
    c2 = chunk[:, 6:12]
    merged = c1 + c2
    l1 = c1[:, 1:] - c1[:, :-1]
    l2 = c2[:, 1:] - c2[:, :-1]
    single = (l1 + l2) == 1
    v = (single & (l2 == 1)).to(torch.uint8) * 8  # at merged[:, 0:5]
    v[:, 1:] += _border_values(merged, chunk[:, 12:13], stats, K, k_right)
    stats[0] += chunk.shape[0]
    stats[3] += single.sum()
    return merged[:, 0:5], v


def node_pair_children(ext1, ext2, chunk):
    """The Weiner extensions (C, 4, 13) of node-pair rows from each side's
    extended boundaries (C, 4, 6), kept where the pair has >= 2 union
    children (``node_pair_rows``)."""
    return _char_major(*node_pair_rows(ext1, ext2, chunk))


def node_pair_rows(ext1, ext2, chunk):
    """All Weiner extensions (C, 4, 13) of node-pair rows and whether each
    is kept (C, 4): the pair has >= 2 union children."""
    union = (ext1[..., 1:] > ext1[..., :-1]) | (ext2[..., 1:] > ext2[..., :-1])
    children = torch.cat(
        [ext1, ext2, (chunk[:, 12:13] + 1)[:, None, :].expand(-1, 4, 1)],
        dim=-1)
    return children, union.sum(-1) >= 2


@dataclasses.dataclass
class _Checkpoint:
    """One phase's resume state on disk. ``state`` holds the phase's
    accumulators (delta vectors or flags, then its counts), restored in
    place; ``meta`` (``n``, ``K``, ``k_right``, the row width) must match
    for a saved state to be taken. A save every ``every`` chunks (0: never).
    """

    path: str
    every: int
    state: list
    meta: dict

    def load(self):
        """The saved FIFO and ``max_pending``, with ``state`` restored, or
        None when there is no matching saved state."""
        if not os.path.isfile(self.path):
            return None
        z = torch.load(self.path, map_location="cpu", weights_only=True)
        if z["meta"] != self.meta or [t.shape for t in z["state"]] != \
                [t.shape for t in self.state]:
            return None
        for t, saved in zip(self.state, z["state"]):
            t.copy_(saved)
        return z["queue"].to(self.state[0].device), z["max_pending"]

    def save(self, queue: torch.Tensor, max_pending: int) -> None:
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        tmp = self.path + ".tmp"
        torch.save({"meta": self.meta, "queue": queue.cpu(),
                    "state": [t.cpu() for t in self.state],
                    "max_pending": max_pending}, tmp)
        os.replace(tmp, self.path)

    def remove(self) -> None:
        if os.path.isfile(self.path):
            os.remove(self.path)


def _checkpoint(ckpt_dir, every: int, body: str, state: list, n: int,
                K: int, k_right: int,
                init: torch.Tensor) -> _Checkpoint | None:
    if not ckpt_dir:
        return None
    return _Checkpoint(
        os.path.join(ckpt_dir, f"phase_{body}.pt"), every, state,
        {"n": n, "K": K, "k_right": k_right, "width": init.shape[1]})


class Fifo:
    """A FIFO of row tensors (all of one width), popped in chunks."""

    def __init__(self, rows: torch.Tensor | None = None):
        self.parts = collections.deque()
        self.n = 0  # rows pending
        if rows is not None:
            self.push(rows)

    def push(self, rows: torch.Tensor) -> None:
        if rows.shape[0]:
            self.parts.append(rows)
            self.n += rows.shape[0]

    def pop(self, want: int) -> torch.Tensor:
        """Up to ``want`` rows from the front (at least one is pending)."""
        parts, need = [], want
        while self.parts and need:
            head = self.parts[0]
            if head.shape[0] <= need:
                parts.append(self.parts.popleft())
                need -= head.shape[0]
            else:
                parts.append(head[:need])
                self.parts[0] = head[need:]
                need = 0
        chunk = parts[0] if len(parts) == 1 else torch.cat(parts)
        self.n -= chunk.shape[0]
        return chunk

    def merged(self) -> torch.Tensor:
        """All pending rows as one tensor, which also becomes the FIFO's
        only part."""
        if len(self.parts) > 1:
            self.parts = collections.deque([torch.cat(list(self.parts))])
        return self.parts[0]


def _run_phase(init: torch.Tensor, step, stats: torch.Tensor,
               ckpt: _Checkpoint | None = None) -> int:
    """Drain a FIFO of device row tensors in chunks of up to CHUNK rows;
    ``step(chunk)`` returns the children to queue and counts the rows it
    took in ``stats[0]``. Returns the largest pending count seen (it
    depends on visit order; diagnostic only). With ``ckpt``, the phase
    starts from its saved state where one matches, saves every
    ``ckpt.every`` chunks and deletes the file at the end."""
    progress = os.environ.get("EBWT_PROGRESS", "0") != "0"
    fifo = Fifo(init)
    max_pending = init.shape[0]
    saved = ckpt.load() if ckpt is not None else None
    if saved is not None:
        queue, max_pending = saved
        fifo = Fifo(queue)
    steps = 0
    while fifo.n:
        fifo.push(step(fifo.pop(CHUNK)))
        max_pending = max(max_pending, fifo.n)
        steps += 1
        if progress:
            print(f"[progress] processed {int(stats[0])} items, {fifo.n} "
                  "pending", flush=True)
        if ckpt is not None and ckpt.every and steps % ckpt.every == 0 \
                and fifo.n:
            ckpt.save(fifo.merged(), max_pending)
    if ckpt is not None:
        ckpt.remove()
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
                     slice_len: int | None = None, ckpt_dir=None,
                     ckpt_every: int = 0) -> TraversalResult:
    """Single-BWT navigation (reference navigate_one_bwt,
    ebwt2InDel.cpp:555-676): the leaf phase, then the node phase.
    ``packed=None`` takes the bit-packed route from ``LEAN_N`` positions on;
    True or False forces a route. With ``ckpt_dir`` each phase resumes from
    and saves to a checkpoint there (every ``ckpt_every`` chunks; see the
    module's docstring). ``stats`` carries the counts of the JAX package;
    each phase is a span (``leaf_phase``, ``node_phase``, each ended by a
    synchronise), the node steps' waits on the device ``node_phase.wait``.
    """
    n, dev = fm.n, fm.device
    if packed is None:
        packed = n >= LEAN_N
    with span("leaf_phase"):
        difs = [torch.zeros(n + 1, dtype=torch.int32, device=dev)
                for _ in range(2)]  # K, R
        st_l = torch.zeros(2, dtype=torch.int64, device=dev)  # leaves, lcp
        init = fm.first_leaf()[None, :]
        maxp_l = _run_phase(
            init, lambda c: _leaf_body(fm, c, difs, st_l, K, k_right), st_l,
            _checkpoint(ckpt_dir, ckpt_every, "leaf_body", [*difs, st_l], n,
                        K, k_right, init))
        fills = (_fills_packed(difs, n, slice_len) if packed
                 else _fills_dense(difs, n))
        synchronize(dev)

    with span("node_phase"):
        flags = torch.zeros(n, dtype=torch.uint8, device=dev)
        # nodes, lcp, n_min
        st_n = torch.zeros(3, dtype=torch.int64, device=dev)
        init = fm.root()[None, :]
        maxp_n = _run_phase(
            init, lambda c: _node_body(fm, c, flags, st_n, K, k_right), st_n,
            _checkpoint(ckpt_dir, ckpt_every, "node_body", [flags, st_n], n,
                        K, k_right, init))
        thr_K, thr_R, minima = (_combine_packed(flags, fills, n, slice_len)
                                if packed else _combine_dense(flags, fills))
        del flags, fills
        synchronize(dev)

    l, n_ = st_l.tolist(), st_n.tolist()
    stats = {
        "leaves": l[0], "nodes": n_[0], "lcp_values": 1 + l[1] + n_[1],
        "n_min": n_[2], "max_pending": max(maxp_l, maxp_n),
    }
    return TraversalResult(thr_K=thr_K, thr_R=thr_R, minima=minima,
                           stats=stats, n=n, packed=packed)


def navigate_two_bwts(fm1: FMIndex, fm2: FMIndex, K: int, k_right: int,
                      packed: bool | None = None,
                      slice_len: int | None = None, ckpt_dir=None,
                      ckpt_every: int = 0) -> TraversalResult:
    """Lockstep navigation of two suffix trees that simulates the merged
    collection (reference navigate_two_bwts, ebwt2InDel.cpp:679-831): the
    leaf-pair phase, then the node-pair phase, over n = n1 + n2 merged
    positions. ``da`` is the merged document array. ``packed`` chooses the
    route as in ``navigate_one_bwt``, over the merged n, and ``ckpt_dir``
    and ``ckpt_every`` act as there. ``stats`` adds ``da_values`` to the
    counts of ``navigate_one_bwt``."""
    n, dev = fm1.n + fm2.n, fm1.device
    if packed is None:
        packed = n >= LEAN_N
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    with span("leaf_phase"):
        difs = [torch.zeros(n + 1, dtype=torch.int32, device=dev)
                for _ in range(3)]  # K, R, DA
        # leaves, lcp, da
        st_l = torch.zeros(3, dtype=torch.int64, device=dev)
        init = torch.cat([fm1.first_leaf()[:2], fm2.first_leaf()[:2],
                          zero])[None]
        maxp_l = _run_phase(
            init,
            lambda c: _leaf_pair_body(fm1, fm2, c, difs, st_l, K, k_right),
            st_l,
            _checkpoint(ckpt_dir, ckpt_every, "leaf_pair_body",
                        [*difs, st_l], n, K, k_right, init))
        fills = (_fills_packed(difs, n, slice_len) if packed
                 else _fills_dense(difs, n))
        synchronize(dev)

    with span("node_phase"):
        flags = torch.zeros(n, dtype=torch.uint8, device=dev)
        # nodes, lcp, n_min, da
        st_n = torch.zeros(4, dtype=torch.int64, device=dev)
        init = torch.cat([fm1.root()[:6], fm2.root()[:6], zero])[None]
        maxp_n = _run_phase(
            init,
            lambda c: _node_pair_body(fm1, fm2, c, flags, st_n, K, k_right),
            st_n,
            _checkpoint(ckpt_dir, ckpt_every, "node_pair_body",
                        [flags, st_n], n, K, k_right, init))
        thr_K, thr_R, minima, da = (
            _combine_packed(flags, fills, n, slice_len) if packed
            else _combine_dense(flags, fills))
        del flags, fills
        synchronize(dev)

    l, n_ = st_l.tolist(), st_n.tolist()
    stats = {
        "leaves": l[0], "nodes": n_[0], "lcp_values": 1 + l[1] + n_[1],
        "n_min": n_[2], "da_values": l[2] + n_[3],
        "max_pending": max(maxp_l, maxp_n),
    }
    return TraversalResult(thr_K=thr_K, thr_R=thr_R, minima=minima,
                           stats=stats, n=n, da=da, packed=packed)
