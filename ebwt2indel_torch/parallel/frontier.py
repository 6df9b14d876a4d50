"""Frontier-sharded traversal of mode 1 (counterpart of the mode-1 parts of
``ebwt2indel_tpu/parallel/frontier.py``: ``_frontier_leaf_phase``,
``_frontier_node_phase``, ``_route``, ``_combine_frontier`` and
``navigate_one_bwt_frontier_device``).

Each shard drives its own FIFO of rows from the host, as
``models/traverse.py::_run_phase`` does for one device, and every shard
takes the same number of steps: the loop ends when the pending count summed
over the mesh is 0. The writes do not depend on visit order
(traverse.py:6-12 of the JAX package), so this is exact.

* A node (a leaf) lives on the shard that owns the block row of its first
  coordinate. A narrow one, whose coordinates span at most two blocks, is
  extended by the rank kernel on the shard's own rows and halo row, with no
  collective.
* Flag and delta entries of narrow rows that land past the shard's right
  edge (at most one block past it) go to the right neighbour (``shift``).
* Wide rows are gathered on every shard (``all_gather``); each shard ranks
  the coordinates it owns, one ``psum`` combines them, each shard writes the
  entries that land in its range, and each pushes the wide rows' children
  that it owns.
* Narrow rows' children go to their owners in one ``all_to_all``.

The bodies are ``models/traverse.py``'s: ``_border_values``, ``_char_major``
and the exact int32-per-field leaf deltas (separate K and R vectors), so no
depth bound and no fallback exist. After the leaf phase each shard's deltas
become fills by a local prefix sum plus the exclusive prefix of the
shards' totals.
"""

from __future__ import annotations

import time

import torch

from ..models import fm_index as fm_ops
from ..models import traverse
from ..ops import rank
from . import shard as shard_ops
from .shard import ShardedFM


def _drive(sfm: ShardedFM, width: int, init: torch.Tensor, step) -> int:
    """Run a phase: per-shard FIFOs, ``init`` on the shard that owns it,
    ``step(chunks)`` over a chunk of up to ``traverse.CHUNK`` rows of every
    local shard (possibly empty) returning each local shard's new rows.
    Returns the number of mesh steps."""
    mesh = sfm.mesh
    fifos = {s: traverse.Fifo() for s in mesh.local}
    owner = int(init[0, 0]) // sfm.local_n
    if owner in fifos:
        fifos[owner].push(init.to(mesh.devices[owner]))
    empty = {s: torch.zeros((0, width), dtype=torch.int64,
                            device=mesh.devices[s]) for s in mesh.local}
    steps = 0
    while mesh.psum_int(sum(f.n for f in fifos.values())):
        chunks = {s: f.pop(traverse.CHUNK) if f.n else empty[s]
                  for s, f in fifos.items()}
        for s, new in step(chunks).items():
            for rows in new:
                fifos[s].push(rows)
        steps += 1
    return steps


def _route(sfm: ShardedFM, children: dict, wide_children: torch.Tensor,
           out: dict) -> None:
    """Queue the children: the narrow rows' ``children`` to the owner of
    each row's first coordinate through the ``all_to_all``, and of the
    gathered wide rows' children (every process has them all) the ones that
    a local shard owns."""
    mesh = sfm.mesh
    owner = {s: (c[:, 0] >> 7) // sfm.rows for s, c in children.items()}
    got = mesh.all_to_all(children, owner)
    w_owner = (wide_children[:, 0] >> 7) // sfm.rows
    for s in mesh.local:
        out[s] += [got[s], wide_children[w_owner == s].to(mesh.devices[s])]


def _narrow_rank(sfm: ShardedFM, s: int, coords: torch.Tensor):
    """Rank of coordinates that span at most two blocks from shard s's own
    rows: its rows and its halo row, at local positions."""
    return rank.parallel_rank(sfm.blocks[s], coords - s * sfm.local_n)


def _gather_wide(sfm: ShardedFM, wide: dict):
    """The wide rows of every shard, on ``mesh.device``."""
    return torch.cat(sfm.mesh.all_gather(wide))


def _node_step(sfm: ShardedFM, chunks: dict, flags: dict, stats: dict,
               K: int, k_right: int) -> dict:
    """One mesh step of the node phase (``_node_body`` on every shard):
    border flags and minima marks, then the Weiner extension."""
    mesh, L = sfm.mesh, sfm.local_n
    spills, wide, children = {}, {}, {}
    for s, chunk in chunks.items():
        # the popping shard counts its nodes' LCP values and minima
        v = traverse._border_values(chunk[:, :6], chunk[:, 6:7], stats[s],
                                    K, k_right)
        stats[s][0] += chunk.shape[0]
        b = chunk[:, :6] >> 7
        narrow = (b[:, 5] - b[:, 0]) <= 1
        wide[s] = torch.cat([chunk[~narrow], v[~narrow].to(torch.int64)], 1)
        nodes, v = chunk[narrow], v[narrow]
        on = v > 0
        pos = nodes[:, 1:5][on] - s * L
        val = v[on]
        mine = pos < L
        flags[s].index_add_(0, pos[mine], val[mine])
        spills[s] = torch.stack([pos[~mine] - L,
                                 val[~mine].to(torch.int64)], 1)
        ranks = _narrow_rank(sfm, s, nodes[:, :6])  # (C, 6, 4)
        ext = torch.cat([sfm.F.to(chunk.device)[:, None]
                         + ranks.transpose(1, 2),
                         (nodes[:, 6] + 1)[:, None, None].expand(-1, 4, 1)],
                        -1)  # (C, 4, 7)
        children[s] = traverse._char_major(
            ext, fm_ops.node_num_children(ext) >= 2)

    got = mesh.shift(spills, 1)
    for s in mesh.local:
        if got[s] is not None:
            flags[s].index_add_(0, got[s][:, 0], got[s][:, 1].to(torch.uint8))

    W = _gather_wide(sfm, wide)  # (NW, 11): node rows, then their 4 values
    w_children = W[:, :7]
    if W.shape[0]:  # the same on every process
        ranks = shard_ops.sharded_parallel_rank(sfm, W[:, :6])
        ext = torch.cat([sfm.F[:, None] + ranks.transpose(1, 2),
                         (W[:, 6] + 1)[:, None, None].expand(-1, 4, 1)], -1)
        w_children = traverse._char_major(
            ext, fm_ops.node_num_children(ext) >= 2)
        v = W[:, 7:11]
        on = v > 0
        pos, val = W[:, 1:5][on], v[on].to(torch.uint8)
        for s in mesh.local:
            m = (pos >= s * L) & (pos < (s + 1) * L)
            dev = mesh.devices[s]
            flags[s].index_add_(0, (pos[m] - s * L).to(dev), val[m].to(dev))

    out = {s: [] for s in mesh.local}
    _route(sfm, children, w_children, out)
    return out


def _delta_entries(leaves: torch.Tensor, K: int, k_right: int):
    """(m, 3) [position, lane, value] boundary deltas of leaf rows
    [first, second, depth] (``_leaf_body``): +1 at first+1 and -1 at second,
    on lane 0 (thr_K) where depth >= K and lane 1 (thr_R) where depth >=
    k_right."""
    first, second, depth = leaves.unbind(1)
    parts = []
    for lane, bound in enumerate((K, k_right)):
        on = depth >= bound
        lo, hi = first[on] + 1, second[on]
        parts.append(torch.stack([
            torch.cat([lo, hi]), torch.full_like(torch.cat([lo, hi]), lane),
            torch.cat([torch.ones_like(lo), -torch.ones_like(hi)])], 1))
    return torch.cat(parts)


def _add_deltas(difs: list, ent: torch.Tensor, base: int, L: int):
    """Add the entries that land in [base, base + L) to a shard's two delta
    vectors; returns those past its right edge, at positions local to the
    right neighbour."""
    loc = ent[:, 0] - base
    for lane, d in enumerate(difs):
        m = (ent[:, 1] == lane) & (loc >= 0) & (loc < L)
        d.index_add_(0, loc[m], ent[m, 2].to(torch.int32))
    past = loc >= L
    spill = ent[past]
    spill[:, 0] = loc[past] - L
    return spill


def _leaf_step(sfm: ShardedFM, chunks: dict, difs: dict, stats: dict,
               K: int, k_right: int) -> dict:
    """One mesh step of the leaf phase (``_leaf_body`` on every shard):
    boundary deltas, then the left extensions of size >= 2."""
    mesh, L = sfm.mesh, sfm.local_n
    spills, wide, children = {}, {}, {}
    for s, chunk in chunks.items():
        first, second, depth = chunk.unbind(1)
        stats[s][0] += chunk.shape[0]
        stats[s][1] += (second - first - 1).sum()
        narrow = ((second >> 7) - (first >> 7)) <= 1
        wide[s] = chunk[~narrow]
        leaves = chunk[narrow]
        spills[s] = _add_deltas(difs[s], _delta_entries(leaves, K, k_right),
                                s * L, L)
        r = _narrow_rank(sfm, s, leaves[:, :2])  # (C, 2, 4)
        F = sfm.F.to(chunk.device)
        lo4, hi4 = F + r[:, 0], F + r[:, 1]
        kids = torch.stack(
            [lo4, hi4, (leaves[:, 2] + 1)[:, None].expand_as(lo4)], -1)
        children[s] = traverse._char_major(kids, (hi4 - lo4) >= 2)

    got = mesh.shift(spills, 1)
    for s in mesh.local:
        if got[s] is not None:
            _add_deltas(difs[s], got[s], 0, L)

    W = _gather_wide(sfm, wide)  # (NW, 3)
    w_children = W
    if W.shape[0]:  # the same on every process
        ent = _delta_entries(W, K, k_right)
        for s in mesh.local:
            _add_deltas(difs[s], ent.to(mesh.devices[s]), s * L, L)
        r = shard_ops.sharded_parallel_rank(sfm, W[:, :2])
        lo4, hi4 = sfm.F + r[:, 0], sfm.F + r[:, 1]
        kids = torch.stack(
            [lo4, hi4, (W[:, 2] + 1)[:, None].expand_as(lo4)], -1)
        w_children = traverse._char_major(kids, (hi4 - lo4) >= 2)

    out = {s: [] for s in mesh.local}
    _route(sfm, children, w_children, out)
    return out


def _fills(sfm: ShardedFM, difs: dict) -> dict:
    """Each shard's thr_K and thr_R fills (bool): the local prefix sum of
    its deltas plus the exclusive prefix of the shards' totals. ``difs`` is
    emptied as it goes."""
    mesh = sfm.mesh
    totals = torch.cat(mesh.all_gather(
        {s: torch.stack([d.sum(dtype=torch.int64) for d in difs[s]])[None]
         for s in mesh.local}))  # (S, 2)
    fills = {}
    for s in mesh.local:
        before = totals[:s].sum(0).to(torch.int32).tolist()
        fills[s] = [(torch.cumsum(d, 0, dtype=torch.int32) + c) > 0
                    for d, c in zip(difs.pop(s), before)]
    return fills


def navigate_one_bwt_sharded(sfm: ShardedFM, K: int, k_right: int):
    """Frontier-sharded mode-1 navigation: the leaf phase, then the node
    phase. Returns (thr_K, thr_R, minima, stats): each flag a dict of the
    local shards' (local_n,) uint8 vectors over the shard's positions (0
    past n), and ``stats`` the counts of ``traverse.navigate_one_bwt``
    (``leaves``, ``nodes``, ``lcp_values``, ``n_min``) plus the mesh steps
    and the seconds of each phase."""
    mesh, L = sfm.mesh, sfm.local_n
    dev = mesh.devices
    t0 = time.perf_counter()
    difs = {s: [torch.zeros(L, dtype=torch.int32, device=dev[s])
                for _ in range(2)] for s in mesh.local}
    st_l = {s: torch.zeros(2, dtype=torch.int64, device=dev[s])
            for s in mesh.local}
    F = sfm.F.tolist()
    leaf_steps = _drive(
        sfm, 3, torch.tensor([[0, F[0], 0]]),
        lambda c: _leaf_step(sfm, c, difs, st_l, K, k_right))
    fills = _fills(sfm, difs)
    mesh.synchronize()
    t1 = time.perf_counter()

    flags = {s: torch.zeros(L, dtype=torch.uint8, device=dev[s])
             for s in mesh.local}
    st_n = {s: torch.zeros(3, dtype=torch.int64, device=dev[s])
            for s in mesh.local}
    node_steps = _drive(
        sfm, 7, torch.tensor([[0, *F, sfm.n, 0]]),
        lambda c: _node_step(sfm, c, flags, st_n, K, k_right))
    thr_K, thr_R, minima = {}, {}, {}
    for s in mesh.local:
        thr_K[s], thr_R[s], minima[s] = traverse._combine_dense(
            flags.pop(s), fills.pop(s))
    mesh.synchronize()
    t2 = time.perf_counter()

    l = mesh.psum(st_l).tolist()
    n_ = mesh.psum(st_n).tolist()
    stats = {"leaves": l[0], "nodes": n_[0], "lcp_values": 1 + l[1] + n_[1],
             "n_min": n_[2], "leaf_steps": leaf_steps,
             "node_steps": node_steps, "leaf_seconds": t1 - t0,
             "node_seconds": t2 - t1}
    return thr_K, thr_R, minima, stats
