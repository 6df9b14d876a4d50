"""The calling of all three modes over the sharded indexes and flags
(counterpart of ``ebwt2indel_tpu/parallel/calling.py``).

Cluster state (begins, ends, walk intervals) is O(#clusters) and every
shard holds all of it, on ``mesh.device``; every rank and select is
answered by the owning shard and combined by one ``psum``. The walk bodies
are ``models/call.py``'s (``range_counts_core``, ``consensus_core``,
``extract_dna_core``). Flags, the anchor table and the document array's
rank structure (``ShardedBits``) stay sharded in the traversal's partition:
shard s holds positions [s * local_n, (s + 1) * local_n).
"""

from __future__ import annotations

import dataclasses

import torch

from ..models import call, cluster
from ..models import fm_index as fm_ops
from ..ops import bits, rank, scan
from . import shard
from .mesh import Mesh
from .shard import ShardedFM


def range_counts_sharded(sfm: ShardedFM, begins: torch.Tensor,
                         ends: torch.Tensor):
    """``call.range_counts`` on the mesh: (quirk, pure) counts."""
    return call.range_counts_core(
        lambda i: shard.sharded_parallel_rank(sfm, i), begins, ends)


def extract_consensus_sharded(sfm: ShardedFM, begins: torch.Tensor,
                              ends: torch.Tensor, *, k_left: int):
    """``call.extract_consensus_batch`` on the mesh."""
    def lf_range(lo, hi):
        r = shard.sharded_parallel_rank(sfm, torch.stack([lo, hi], dim=-1))
        return sfm.F + r[..., 0, :], sfm.F + r[..., 1, :]

    return call.consensus_core(lf_range, begins, ends, k_left)


def extract_dna_sharded(sfm: ShardedFM, starts: torch.Tensor,
                        active: torch.Tensor, *, k_right: int):
    """``call.extract_dna_batch`` on the mesh: the FL step's select runs on
    the shard that holds the target rank (by ``bounds``)."""
    def fl(i):
        cc = fm_ops.f_char(sfm, i).clamp(0, 3)
        return shard.sharded_select(sfm, (i - sfm.F[cc]).clamp_min(0), cc)

    return call.extract_dna_core(lambda i: fm_ops.f_char(sfm, i), fl,
                                 starts, active, k_right)


def next_set_table_sharded(mesh: Mesh, thr_R: dict, *, local_n: int,
                           n: int) -> dict:
    """``call.next_set_table`` on the mesh: next_set[i] = the smallest
    j >= i with thr_R[j] set (n if none), per shard. The next-set op over
    the shard's slice from its first global position, then the minimum of
    the shards to the right (one gather of S values)."""
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
    slice, and the ones before each shard (S,) on ``mesh.device``."""

    mesh: Mesh
    words: dict
    counts: dict
    before: torch.Tensor
    local_n: int


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
