"""The calling of all three modes over the sharded indexes and flags
(counterpart of ``ebwt2indel_tpu/parallel/calling.py``).

Cluster state (begins, ends, walk intervals) is O(#clusters) and every
shard holds all of it, on ``mesh.device``; every rank and select is
answered by the owning shard and combined by one ``psum``. The walks are
``models/call.py``'s ``Walks`` over the sharded rank and select
(``shard.py``). Flags, the anchor table and the document array's rank
structure (``ShardedBits``) stay sharded in the traversal's partition:
shard s holds positions [s * local_n, (s + 1) * local_n). The pipelines'
skeletons (``models/pipeline.py``) reach them through ``ShardedTraversal``
and ``ShardedBits``, which answer the calls of ``traverse.TraversalResult``
and ``rank.BitRank``.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import torch

from ..models import cluster
from ..ops import bits, rank, scan
from .mesh import Mesh


def next_set_table_sharded(mesh: Mesh, thr_R: dict, *, local_n: int,
                           n: int) -> dict:
    """``scan.next_set`` on the mesh: next_set[i] = the smallest j >= i
    with thr_R[j] set (n if none), per shard. The next-set op over the
    shard's slice from its first global position, then the minimum of the
    shards to the right (one gather of S values)."""
    loc = {s: scan.next_set(thr_R[s], base=s * local_n, n=n)
           for s in mesh.local}
    firsts = torch.cat(mesh.all_gather({s: loc[s][:1] for s in mesh.local}))
    for s in mesh.local:
        right = firsts[s + 1:].min() if s + 1 < mesh.size else n
        loc[s].clamp_max_(int(right))  # in place: no second table
    return loc


def find_clusters_sharded(mesh: Mesh, thr_K: dict, minima: dict, *,
                          local_n: int, n: int,
                          mcov_out: int) -> cluster.Clusters:
    """``cluster.find_clusters_device`` on the mesh: per-shard run marks
    with 1-element halos from both neighbours, a run still open at n-1
    never closes, and the marks' positions gathered (O(#runs)) into the
    clusters every shard holds."""
    mask = {s: (thr_K[s] != 0) & (minima[s] == 0) for s in mesh.local}
    left = mesh.shift({s: mask[s][-1:].to(torch.uint8) for s in mesh.local},
                      1)
    right = mesh.shift({s: mask[s][:1].to(torch.uint8) for s in mesh.local},
                       -1)
    starts, ends = {}, {}
    for s in mesh.local:
        m = mask.pop(s)
        base = s * local_n
        prev = torch.zeros_like(m)
        prev[1:] = m[:-1]
        nxt = torch.zeros_like(m)
        nxt[:-1] = m[1:]
        if left[s] is not None:
            prev[0] = left[s][0] != 0
        if right[s] is not None:
            nxt[-1] = right[s][0] != 0
        end_at = m & ~nxt
        if base <= n - 1 < base + local_n:
            end_at[n - 1 - base] = False  # (cluster.py:95 of the JAX package)
        starts[s] = torch.nonzero(m & ~prev).flatten() + base
        ends[s] = torch.nonzero(end_at).flatten() + base + 1
    return cluster._runs_to_clusters(torch.cat(mesh.all_gather(starts)),
                                     torch.cat(mesh.all_gather(ends)),
                                     mcov_out)


def first_thr_position_sharded(mesh: Mesh, next_set: dict,
                               begins: torch.Tensor, ends: torch.Tensor, *,
                               local_n: int):
    """``call.first_thr_position_device`` on the mesh: the anchor table is
    read at each cluster's begin by the shard that holds it."""
    parts = {}
    for s in mesh.local:
        b = begins.to(mesh.devices[s]) - s * local_n
        mine = (b >= 0) & (b < local_n)
        out = torch.zeros_like(b)
        out[mine] = next_set[s][b[mine]]
        parts[s] = out
    pos = mesh.psum(parts)
    found = pos < ends
    return torch.where(found, pos, 0), found


@dataclasses.dataclass(frozen=True)
class ShardedBits:
    """A 0/1 vector (the document array) sharded in ``local_n``-position
    slices: each shard's ``bits.bv_build`` words and counts over its own
    slice, and the ones before each shard (S,) on ``mesh.device``. It
    answers the calls of ``rank.BitRank``."""

    mesh: Mesh
    words: dict
    counts: dict
    before: torch.Tensor
    local_n: int

    def rank1(self, i: torch.Tensor) -> torch.Tensor:
        return bv_rank1_sharded(self, i)

    def get(self, i: torch.Tensor) -> torch.Tensor:
        return bv_get_sharded(self, i)


def bv_build_sharded(mesh: Mesh, parts: dict, *,
                     local_n: int) -> ShardedBits:
    """The rank structure of a vector given as each local shard's
    (local_n,) 0/1 slice: ``bits.bv_build`` per shard, and one gather of
    the S shard totals, whose exclusive prefix makes a local rank
    global."""
    words, counts, totals = {}, {}, {}
    for s in mesh.local:
        words[s], counts[s] = bits.bv_build(parts[s])
        totals[s] = (parts[s] != 0).sum(dtype=torch.int64)[None]
    tot = torch.cat(mesh.all_gather(totals))
    return ShardedBits(mesh=mesh, words=words, counts=counts,
                       before=torch.cumsum(tot, 0) - tot, local_n=local_n)


def bv_rank1_sharded(bv: ShardedBits, i: torch.Tensor) -> torch.Tensor:
    """``rank.bv_rank1`` of positions every shard holds (0 <= i <= n), on
    ``mesh.device``: the owner of i (i // local_n; a shard's right edge is
    the next shard's local 0) answers its local rank plus the ones before
    it, and one ``psum`` combines."""
    mesh, L = bv.mesh, bv.local_n
    parts = {}
    for s in mesh.local:
        q = i.to(mesh.devices[s]) - s * L
        mine = (q >= 0) & (q < L)
        r = rank.bv_rank1(bv.words[s], bv.counts[s], q.clamp(0, L - 1))
        parts[s] = torch.where(mine, r + bv.before.to(q.device)[s], 0)
    return mesh.psum(parts)


def bv_get_sharded(bv: ShardedBits, i: torch.Tensor) -> torch.Tensor:
    """``rank.bv_get`` of positions every shard holds (int64 0 or 1), on
    ``mesh.device``."""
    mesh, L = bv.mesh, bv.local_n
    parts = {}
    for s in mesh.local:
        q = i.to(mesh.devices[s]) - s * L
        mine = (q >= 0) & (q < L)
        parts[s] = torch.where(
            mine, rank.bv_get(bv.words[s], q.clamp(0, L - 1)), 0)
    return mesh.psum(parts)


@dataclasses.dataclass
class ShardedTraversal:
    """``traverse.TraversalResult`` on the mesh: the flags that
    ``frontier.navigate_*_sharded`` return, a dict of the local shards'
    (local_n,) uint8 vectors each. Each method is called once and lets go
    of the flags it reads, so that they are freed as soon as it returns."""

    mesh: Mesh
    local_n: int
    n: int
    stats: dict
    thr_K: dict
    thr_R: dict
    minima: dict
    da: dict | None = None

    def anchor(self):
        """``(begins, ends) -> (pos, found)`` over the sharded next-set
        table."""
        thr_R, self.thr_R = self.thr_R, None
        table = next_set_table_sharded(self.mesh, thr_R, local_n=self.local_n,
                                       n=self.n)
        return partial(first_thr_position_sharded, self.mesh, table,
                       local_n=self.local_n)

    def clusters(self, mcov_out: int) -> cluster.Clusters:
        thr_K, minima = self.thr_K, self.minima
        self.thr_K = self.minima = None
        return find_clusters_sharded(self.mesh, thr_K, minima,
                                     local_n=self.local_n, n=self.n,
                                     mcov_out=mcov_out)

    def da_rank(self) -> ShardedBits:
        da, self.da = self.da, None
        return bv_build_sharded(self.mesh, da, local_n=self.local_n)
