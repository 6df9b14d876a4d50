"""The position-sharded index and its rank and select (counterpart of
``ebwt2indel_tpu/parallel/shard.py``).

The BWT's positions split into one block-aligned range per shard: shard s
owns block rows [s * rows, (s + 1) * rows), that is ``local_n = rows * 128``
positions from ``s * local_n``. The traversal's flags, the calling's anchor
table and the clusters' marks use the same partition.

A shard holds its rows with ABSOLUTE counters, so a rank of a position i it
owns is the rank kernel (``rank.parallel_rank``: ``csrc/rank_decode.cu`` on
the card, its plain version on the CPU) at the local position
``i - s * local_n`` against the shard's rows alone. Each shard's rows carry
one more row, the right neighbour's first (the halo), so a suffix-tree node
whose boundaries span two blocks is extended without a collective. Rows
past the input (padding) hold no characters and the total counts.

A query vector that every shard holds (``sharded_parallel_rank``,
``sharded_select``) is answered by the owning shard of each query, a
boolean-mask compaction, and the shards' answers add up in one ``psum``.
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..ops import packing as pk
from ..ops import rank
from .mesh import Mesh


@dataclasses.dataclass(frozen=True)
class ShardedFM:
    """Mesh mirror of ``models.fm_index.FMIndex``."""

    mesh: Mesh
    blocks: dict  # s -> (rows + 1, 16) int32: the shard's rows, then its halo
    block_counts: dict  # s -> (rows, 4) int64 absolute counters
    F: torch.Tensor  # (4,) int64 on mesh.device
    bounds: torch.Tensor  # (S + 1, 4) int64: counts before each shard
    rows: int  # block rows per shard
    n: int
    term: int
    # input bytes this process read and packed (~n / processes)
    local_bytes: int = 0

    @property
    def local_n(self) -> int:
        return self.rows * pk.BLOCK


def _check_mesh_cap(n: int) -> None:
    """One mesh run, like one device run, is capped by the packer's 32-bit
    block counters. (The JAX package also bounds each shard's span below
    2^31 positions, an int32 index limit that int64 positions do not
    have.)"""
    if n >= pk.CAP:
        raise ValueError(pk.CAP_MESSAGE)


def _rows_per_shard(n: int, S: int) -> int:
    return -(-(n // pk.BLOCK + 1) // S)


def _assemble(mesh: Mesh, packs: dict, all_totals: np.ndarray, rows: int,
              n: int, term: int, local_bytes: int) -> ShardedFM:
    """Absolute counters from the (S, 5) table of per-shard totals, padding
    rows, the halo rows, and the upload of this process's shards."""
    totals = all_totals.sum(axis=0)
    bases = np.zeros((mesh.size, 4), np.int64)
    np.cumsum(all_totals[:-1, :4], axis=0, out=bases[1:])
    tot4 = totals[:4]
    blocks, counts = {}, {}
    for s in mesh.local:
        sp = packs[s]
        pk.apply_shard_base(sp, bases[s])
        b = np.zeros((rows, 16), np.uint32)
        b[:sp.n_rows] = sp.rows
        # padding rows carry the totals: a rank at a block-aligned n reads
        # them, and select's search never lands on one for r < total
        b[sp.n_rows:, 12:16] = (tot4 & 0xFFFFFFFF).astype(np.uint32)
        c = np.empty((rows, 4), np.int64)
        c[:sp.n_rows] = sp.row_counts
        c[sp.n_rows:] = tot4
        dev = mesh.devices[s]
        blocks[s] = torch.from_numpy(b.view(np.int32)).to(dev)
        counts[s] = torch.from_numpy(c).to(dev)
    halo = mesh.shift({s: blocks[s][:1] for s in mesh.local}, -1)
    for s in mesh.local:
        # the last shard's halo is never read (no node spans past n)
        h = blocks[s][-1:] if halo[s] is None else halo[s]
        blocks[s] = torch.cat([blocks[s], h])
    bounds = np.concatenate([bases, tot4[None]])
    return ShardedFM(
        mesh=mesh, blocks=blocks, block_counts=counts,
        F=torch.from_numpy(pk.f_from_totals(totals)).to(mesh.device),
        bounds=torch.from_numpy(bounds).to(mesh.device),
        rows=rows, n=int(n), term=int(term), local_bytes=int(local_bytes))


def shard_fm(pb: pk.PackedBwt, mesh: Mesh) -> ShardedFM:
    """Shard an index packed in full on this host."""
    _check_mesh_cap(pb.n)
    rows = _rows_per_shard(pb.n, mesh.size)
    ranges = pk.shard_row_ranges(pb.n, mesh.size)
    packs = {}
    all_totals = np.zeros((mesh.size, 5), np.int64)
    counts = pk.widen_u32(pb.block_counts)
    for s, (lo, hi) in enumerate(ranges):
        base = counts[min(lo, len(counts) - 1)]
        if lo < hi:
            end = counts[hi] if hi < len(counts) else pb.counts[:4]
            all_totals[s, :4] = end - base
            all_totals[s, 4] = min(hi * pk.BLOCK, pb.n) - lo * pk.BLOCK \
                - all_totals[s, :4].sum()
        if s in mesh.local:
            packs[s] = pk.ShardPack(rows=pb.blocks[lo:hi].copy(),
                                    row_counts=counts[lo:hi] - base,
                                    totals=all_totals[s], row_lo=lo,
                                    n_rows=hi - lo)
    return _assemble(mesh, packs, all_totals, rows, pb.n, pb.term, 0)


def shard_fm_from_file(path: str, mesh: Mesh, term: int = ord("#"),
                       n_threads: int = 2) -> ShardedFM:
    """The sharded loader: this process packs only the byte ranges its
    shards own (memmap-backed, so only those pages are read)."""
    n = os.path.getsize(path)
    data = np.memmap(path, dtype=np.uint8, mode="r") if n else \
        np.zeros(0, np.uint8)
    return shard_fm_from_loader(lambda lo, hi: data[lo:hi], n, mesh, term,
                                n_threads)


def shard_fm_from_loader(loader, n: int, mesh: Mesh, term: int = ord("#"),
                         n_threads: int = 2) -> ShardedFM:
    """``shard_fm_from_file`` over any ``loader(lo_char, hi_char)`` byte
    source. Each local shard packs its range with range-local counters (in
    a small thread pool); the (S, 5) table of per-shard totals is gathered
    across processes, and its exclusive prefix makes the counters
    absolute. A process that meets a forbidden character still joins the
    gather, so that every process raises instead of waiting."""
    _check_mesh_cap(n)
    rows = _rows_per_shard(n, mesh.size)
    ranges = pk.shard_row_ranges(n, mesh.size)

    def _pack(s):
        lo, hi = ranges[s]
        if hi <= lo:
            return pk.pack_bytes_range(np.zeros(0, np.uint8), lo, 0, term)
        return pk.pack_bytes_range(
            loader(lo * pk.BLOCK, min(hi * pk.BLOCK, n)), lo, hi - lo, term)

    packs, error = {}, None
    with ThreadPoolExecutor(max(1, n_threads)) as ex:
        futures = {s: ex.submit(_pack, s) for s in mesh.local}
        for s, f in futures.items():
            try:
                packs[s] = f.result()
            except ValueError as e:  # the reference's forbidden character
                error = error or e
    local = np.zeros((len(mesh.local), 6), np.int64)
    for k, s in enumerate(mesh.local):
        if s in packs:
            local[k, :5] = packs[s].totals
    local[:, 5] = error is not None
    table = mesh.allgather_host(local)
    if error is not None:
        raise error
    if table[:, 5].any():
        bad = mesh.owner(int(np.flatnonzero(table[:, 5])[0]))
        raise ValueError(f"process {bad} could not pack its input range")
    local_bytes = sum(min(ranges[s][1] * pk.BLOCK, n) - ranges[s][0]
                      * pk.BLOCK for s in mesh.local
                      if ranges[s][1] > ranges[s][0])
    return _assemble(mesh, packs, table[:, :5], rows, n, term, local_bytes)


def local_rank(sfm: ShardedFM, s: int, i: torch.Tensor) -> torch.Tensor:
    """Shard s's part of the rank of positions i (on its device): the
    counts of the queries it owns, 0 elsewhere. int64 [..., 4]."""
    loc = i - s * sfm.local_n
    mine = (loc >= 0) & (loc < sfm.local_n)
    out = torch.zeros(i.shape + (4,), dtype=torch.int64, device=i.device)
    out[mine] = rank.parallel_rank(sfm.blocks[s], loc[mine])
    return out


def sharded_parallel_rank(sfm: ShardedFM, i: torch.Tensor) -> torch.Tensor:
    """``rank.parallel_rank`` of positions every shard holds, on
    ``mesh.device``."""
    mesh = sfm.mesh
    return mesh.psum({s: local_rank(sfm, s, i.to(mesh.devices[s]))
                      for s in mesh.local})


def local_select(sfm: ShardedFM, s: int, r: torch.Tensor,
                 c: torch.Tensor) -> torch.Tensor:
    """Shard s's part of the select of (r, c): the position of the
    (r+1)-th c where this shard holds it (by the per-shard count bounds),
    0 elsewhere. The block search runs over the shard's own absolute
    counters."""
    lo_b = sfm.bounds[s].to(r.device)[c]
    hi_b = sfm.bounds[s + 1].to(r.device)[c]
    mine = (r >= lo_b) & (r < hi_b)
    out = torch.zeros_like(r)
    out[mine] = s * sfm.local_n + rank.select(
        sfm.blocks[s][:sfm.rows], sfm.block_counts[s], r[mine], c[mine])
    return out


def sharded_select(sfm: ShardedFM, r: torch.Tensor,
                   c: torch.Tensor) -> torch.Tensor:
    """``rank.select`` of queries every shard holds, on ``mesh.device``."""
    mesh = sfm.mesh
    return mesh.psum({s: local_select(sfm, s, r.to(mesh.devices[s]),
                                      c.to(mesh.devices[s]))
                      for s in mesh.local})
