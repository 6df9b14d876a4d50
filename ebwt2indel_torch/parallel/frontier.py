"""Frontier-sharded traversals of modes 1 and 3 (one index) and of mode 2
(two indexes in lockstep): counterparts of ``ebwt2indel_tpu/parallel/
frontier.py``'s ``navigate_one_bwt_frontier_device`` and
``navigate_two_bwts_frontier_device``, with their phases, ``_route``,
``_routed_pair_rank`` and combines.

Each shard drives its own FIFO of rows from the host, as
``models/traverse.py::_run_phase`` does for one device, and every shard
takes the same number of steps: the loop ends when the pending count summed
over the mesh is 0. The writes do not depend on visit order
(traverse.py:6-12 of the JAX package), so this is exact.

* A node (a leaf) lives on the shard that owns the block row of its first
  coordinate (in mode 2: of its side-1 first coordinate). A narrow one,
  whose coordinates span at most two blocks, is extended by the rank kernel
  on the shard's own rows and halo row, with no collective.
* Mode 1: flag and delta entries of narrow rows that land past the shard's
  right edge (at most one block past it) go to the right neighbour
  (``shift``).
* Mode 2: the flags and deltas are in merged positions, which have a
  partition of their own (``merged_local_n``); every entry goes to the
  shard that owns its merged position through an ``all_to_all``. A row's
  side-2 boundaries are ranked by the shard that owns them in index 2: the
  queries travel there with their source slot and the answers come back
  (``_routed_rank``), two more ``all_to_all``s.
* Wide rows are gathered on every shard (``all_gather``); each shard ranks
  the coordinates it owns, one ``psum`` combines them, and each pushes the
  wide rows' children that it owns. In mode 1 each shard also writes the
  wide rows' entries that land in its range.
* Narrow rows' children go to their owners in one ``all_to_all``.

The bodies are ``models/traverse.py``'s: ``_border_values``, ``_char_major``,
the pair helpers, and the exact int32-per-field leaf deltas (separate K, R
and, in mode 2, DA vectors), so no depth bound and no fallback exist. After
the leaf phase each shard's deltas become fills by a local prefix sum plus
the exclusive prefix of the shards' totals.

Checkpoint and resume (``ckpt_dir``, ``ckpt_every`` of the navigate
functions; the JAX package's ``_ckpt_file``, ``_drive_phase`` and
``_maybe_resume``, frontier.py:206-251 there): every ``ckpt_every`` mesh
steps (the JAX package counts dispatches) each process saves, for every
local shard, its FIFO (``traverse.Fifo.merged``, so the order and the
chunking stay), its accumulators (K/R or K/R/DA delta vectors, or flags)
and its stats tensor, with the mesh steps so far and this process's routed
bytes of the phase so far, to ``<ckpt_dir>/frontier_<tag>.p<procid>.pt``
(tags ``m1leaf``, ``m1node``, ``pleaf``, ``pnode``, the JAX package's;
modes 1 and 3 share the first two). The JAX package writes one file from
one process; here every process writes its own, so a kill can land between
two processes' saves. Hence each process keeps its last two saves (the older
one as ``frontier_<tag>.p<procid>.prev.pt``), and before its first
collective a phase gathers every process's saved steps whose meta (the
positions, K, k_right, the row width, S, the processes, this process's id
and shards, the shard length) match its own, over ``mesh.allgather_host``.
Every process resumes from the newest step that all of them hold, or all
start fresh (process 0 says so on stderr when a save was found): no shard
ever resumes alone, and no resume mixes steps. A phase deletes its files
when it completes.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ..models import fm_index as fm_ops
from ..models import traverse
from ..ops import rank
from ..utils.profile import span
from . import shard as shard_ops
from .shard import ShardedFM


class _MeshCheckpoint:
    """One process's resume state of a mesh phase (see the module's
    docstring). ``state`` maps each local shard to its accumulators and
    stats tensor, restored in place; ``meta`` must match for a save to be
    taken. A save every ``every`` mesh steps (0: never)."""

    def __init__(self, mesh, ckpt_dir: str, every: int, tag: str,
                 state: dict, meta: dict):
        self.mesh, self.every, self.tag = mesh, every, tag
        self.state = state
        self.meta = dict(meta, S=mesh.size, nprocs=mesh.nprocs,
                         proc=mesh.proc, local=list(mesh.local))
        stem = os.path.join(ckpt_dir, f"frontier_{tag}.p{mesh.proc}")
        self.path, self.prev = stem + ".pt", stem + ".prev.pt"
        self.routed0 = 0

    def _saved(self) -> tuple[dict, int]:
        """This process's saves, by step, whose meta matches (the tensors
        stay on disk, memory-mapped), and the number of save files found."""
        found, files = {}, 0
        for path in (self.path, self.prev):
            if os.path.isfile(path):
                files += 1
                z = torch.load(path, map_location="cpu", weights_only=True,
                               mmap=True)
                if z["meta"] == self.meta:
                    found[z["step"]] = z
        return found, files

    def resume(self, fifos: dict) -> int:
        """Restore the newest step that every process holds into ``fifos``
        and ``state``; returns it, or 0 to start fresh. Every process must
        call it at the same point: it gathers every process's steps."""
        mesh = self.mesh
        saved, files = self._saved()
        steps = sorted(saved, reverse=True)[:2] + [-1, -1]
        row = np.array([[steps[0], steps[1], files]] * len(mesh.local),
                       np.int64)
        table = mesh.allgather_host(row)  # (S, 3)
        common = set(table[0, :2].tolist())
        for r in table[1:]:
            common &= set(r[:2].tolist())
        common.discard(-1)
        self.routed0 = mesh.routed_bytes
        if not common:
            if mesh.proc == 0 and table[:, 2].any():
                print(f"[ckpt] frontier_{self.tag}: no saved step that every "
                      f"process holds and that matches this run (steps per "
                      f"shard {table[:, :2].tolist()}); the phase starts "
                      "fresh", file=sys.stderr, flush=True)
            return 0
        step = max(common)
        z = saved[step]
        for s in mesh.local:
            shard = z["shards"][s]
            for t, x in zip(self.state[s], shard["state"]):
                t.copy_(x)
            fifos[s].push(shard["queue"].to(mesh.devices[s]))
        mesh.routed_bytes += z["routed"]
        return step

    def save(self, fifos: dict, step: int) -> None:
        """Write this process's state at ``step`` through a temporary file
        and ``os.replace``; the save it replaces becomes the previous one."""
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        tmp = self.path + ".tmp"
        torch.save({"meta": self.meta, "step": step,
                    "routed": self.mesh.routed_bytes - self.routed0,
                    "shards": {s: {"queue": f.merged().cpu()
                                   if f.n else torch.zeros(0),
                                   "state": [t.cpu() for t in self.state[s]]}
                               for s, f in fifos.items()}}, tmp)
        if os.path.isfile(self.path):
            os.replace(self.path, self.prev)
        os.replace(tmp, self.path)

    def remove(self) -> None:
        for path in (self.path, self.prev, self.path + ".tmp"):
            if os.path.isfile(path):
                os.remove(path)


def _checkpoint(mesh, ckpt_dir, every: int, tag: str, state: dict,
                **meta) -> _MeshCheckpoint | None:
    if not ckpt_dir:
        return None
    return _MeshCheckpoint(mesh, ckpt_dir, every, tag, state, meta)


def _drive(sfm: ShardedFM, width: int, init: torch.Tensor, step,
           ckpt: _MeshCheckpoint | None = None) -> int:
    """Run a phase: per-shard FIFOs, ``init`` on the shard that owns it,
    ``step(chunks)`` over a chunk of up to ``traverse.CHUNK`` rows of every
    local shard (possibly empty) returning each local shard's new rows.
    With ``ckpt`` the phase resumes where every process holds a save, saves
    every ``ckpt.every`` mesh steps and deletes its files at the end.
    Returns the number of mesh steps (those before the resume included)."""
    mesh = sfm.mesh
    fifos = {s: traverse.Fifo() for s in mesh.local}
    steps = ckpt.resume(fifos) if ckpt is not None else 0
    resumed = steps
    if not resumed:
        owner = int(init[0, 0]) // sfm.local_n
        if owner in fifos:
            fifos[owner].push(init.to(mesh.devices[owner]))
    empty = {s: torch.zeros((0, width), dtype=torch.int64,
                            device=mesh.devices[s]) for s in mesh.local}
    while mesh.psum_int(sum(f.n for f in fifos.values())):
        # the step count is the same on every process, so all save at once
        if ckpt is not None and ckpt.every and steps > resumed and \
                steps % ckpt.every == 0:
            ckpt.save(fifos, steps)
        chunks = {s: f.pop(traverse.CHUNK) if f.n else empty[s]
                  for s, f in fifos.items()}
        for s, new in step(chunks).items():
            for rows in new:
                fifos[s].push(rows)
        steps += 1
    if ckpt is not None:
        ckpt.remove()
    return steps


def _owner(sfm: ShardedFM, pos: torch.Tensor) -> torch.Tensor:
    """The shard that owns the block row of each position of ``sfm``'s
    index (n itself included, on the last shard)."""
    return ((pos >> 7) // sfm.rows).clamp_max(sfm.mesh.size - 1)


def _route(sfm: ShardedFM, children: dict, wide_children: torch.Tensor,
           out: dict) -> None:
    """Queue the children: the narrow rows' ``children`` to the owner of
    each row's first coordinate through the ``all_to_all``, and of the
    gathered wide rows' children (every process has them all) the ones that
    a local shard owns."""
    mesh = sfm.mesh
    owner = {s: _owner(sfm, c[:, 0]) for s, c in children.items()}
    got = mesh.all_to_all(children, owner)
    w_owner = _owner(sfm, wide_children[:, 0])
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
        traverse.add_at(flags[s], pos[mine], val[mine])
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
            traverse.add_at(flags[s], got[s][:, 0],
                            got[s][:, 1].to(torch.uint8))

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
            traverse.add_at(flags[s], (pos[m] - s * L).to(dev),
                            val[m].to(dev))

    out = {s: [] for s in mesh.local}
    _route(sfm, children, w_children, out)
    return out


def _delta_entries(leaves: torch.Tensor, K: int, k_right: int):
    """(m, 3) [position, lane, value] boundary deltas of leaf rows
    [first, second, depth] (``_leaf_body``): +1 at first+1 and -1 at second,
    on lane 0 (thr_K) where depth >= K and lane 1 (thr_R) where depth >=
    k_right."""
    first, second, depth = leaves.unbind(1)
    return torch.cat([
        _bound_entries(first[on] + 1, second[on], lane)
        for lane, on in enumerate((depth >= K, depth >= k_right))])


def _bound_entries(lo: torch.Tensor, hi: torch.Tensor, lane: int):
    """(m, 3) [position, lane, value] entries: +1 at each lo, -1 at each
    hi."""
    idx = torch.cat([lo, hi])
    return torch.stack([
        idx, torch.full_like(idx, lane),
        torch.cat([torch.ones_like(lo), -torch.ones_like(hi)])], 1)


def _add_deltas(difs: list, ent: torch.Tensor, base: int, L: int):
    """Add the entries that land in [base, base + L) to a shard's two delta
    vectors; returns those past its right edge, at positions local to the
    right neighbour."""
    loc = ent[:, 0] - base
    for lane, d in enumerate(difs):
        m = (ent[:, 1] == lane) & (loc >= 0) & (loc < L)
        traverse.add_at(d, loc[m], ent[m, 2].to(torch.int32))
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
    """Each shard's fills (bool) of its delta vectors (thr_K, thr_R and, in
    mode 2, DA): the local prefix sum of its deltas plus the exclusive
    prefix of the shards' totals. ``difs`` is emptied as it goes."""
    mesh = sfm.mesh
    totals = torch.cat(mesh.all_gather(
        {s: torch.stack([d.sum(dtype=torch.int64) for d in difs[s]])[None]
         for s in mesh.local}))  # (S, lanes)
    fills = {}
    for s in mesh.local:
        before = totals[:s].sum(0).to(torch.int32).tolist()
        fills[s] = [(torch.cumsum(d, 0, dtype=torch.int32) + c) > 0
                    for d, c in zip(difs.pop(s), before)]
    return fills


def navigate_one_bwt_sharded(sfm: ShardedFM, K: int, k_right: int,
                             ckpt_dir=None, ckpt_every: int = 0):
    """Frontier-sharded mode-1 navigation: the leaf phase, then the node
    phase. Returns (thr_K, thr_R, minima, stats): each flag a dict of the
    local shards' (local_n,) uint8 vectors over the shard's positions (0
    past n), and ``stats`` the counts of ``traverse.navigate_one_bwt``
    (``leaves``, ``nodes``, ``lcp_values``, ``n_min``) plus the mesh
    steps; each phase is a span (``leaf_phase``, ``node_phase``, each ended
    by a synchronise). With ``ckpt_dir`` each phase resumes
    from and saves to checkpoints there (every ``ckpt_every`` mesh steps;
    see the module's docstring)."""
    mesh, L = sfm.mesh, sfm.local_n
    dev = mesh.devices
    meta = {"n": sfm.n, "K": K, "k_right": k_right, "local_n": L,
            "rows": sfm.rows}
    with span("leaf_phase"):
        difs = {s: [torch.zeros(L, dtype=torch.int32, device=dev[s])
                    for _ in range(2)] for s in mesh.local}
        st_l = {s: torch.zeros(2, dtype=torch.int64, device=dev[s])
                for s in mesh.local}
        F = sfm.F.tolist()
        leaf_steps = _drive(
            sfm, 3, torch.tensor([[0, F[0], 0]]),
            lambda c: _leaf_step(sfm, c, difs, st_l, K, k_right),
            _checkpoint(mesh, ckpt_dir, ckpt_every, "m1leaf",
                        {s: [*difs[s], st_l[s]] for s in mesh.local},
                        width=3, **meta))
        fills = _fills(sfm, difs)
        mesh.synchronize()

    with span("node_phase"):
        flags = {s: torch.zeros(L, dtype=torch.uint8, device=dev[s])
                 for s in mesh.local}
        st_n = {s: torch.zeros(3, dtype=torch.int64, device=dev[s])
                for s in mesh.local}
        node_steps = _drive(
            sfm, 7, torch.tensor([[0, *F, sfm.n, 0]]),
            lambda c: _node_step(sfm, c, flags, st_n, K, k_right),
            _checkpoint(mesh, ckpt_dir, ckpt_every, "m1node",
                        {s: [flags[s], st_n[s]] for s in mesh.local},
                        width=7, **meta))
        thr_K, thr_R, minima = {}, {}, {}
        for s in mesh.local:
            thr_K[s], thr_R[s], minima[s] = traverse._combine_dense(
                flags.pop(s), fills.pop(s))
        mesh.synchronize()

    l = mesh.psum(st_l).tolist()
    n_ = mesh.psum(st_n).tolist()
    stats = {"leaves": l[0], "nodes": n_[0], "lcp_values": 1 + l[1] + n_[1],
             "n_min": n_[2], "leaf_steps": leaf_steps,
             "node_steps": node_steps}
    return thr_K, thr_R, minima, stats


def merged_local_n(n: int, S: int) -> int:
    """Positions per shard of a pair run's merged flags and document array
    (n = n1 + n2): whole blocks, as in an index's partition, so that each
    shard's DA words start at a block."""
    return shard_ops._rows_per_shard(n, S) * 128


def _routed_rank(sfm: ShardedFM, coords: dict) -> dict:
    """The ranks (m, k, 4) of each local shard's narrow (m, k) coordinate
    rows in ``sfm``'s index. Each row is decoded by the shard that owns the
    block row of its first coordinate, on that shard's rows and halo: the
    rows travel there with their source slot and shard through one
    ``all_to_all``, and the answers come back through a second."""
    mesh, L = sfm.mesh, sfm.local_n
    k = next(iter(coords.values())).shape[1]
    queries, dest = {}, {}
    for s, c in coords.items():
        slot = torch.arange(c.shape[0], device=c.device)[:, None]
        queries[s] = torch.cat([c, slot, torch.full_like(slot, s)], 1)
        dest[s] = _owner(sfm, c[:, 0])
    answers, back = {}, {}
    for d, q in mesh.all_to_all(queries, dest).items():
        r = rank.parallel_rank(sfm.blocks[d], q[:, :k] - d * L)  # (m, k, 4)
        answers[d] = torch.cat([q[:, k:k + 1], r.flatten(1)], 1)
        back[d] = q[:, k + 1]
    out = {}
    for s, a in mesh.all_to_all(answers, back).items():
        r = torch.empty((coords[s].shape[0], k, 4), dtype=torch.int64,
                        device=a.device)
        r[a[:, 0]] = a[:, 1:].reshape(-1, k, 4)
        out[s] = r
    return out


def _add_merged(sfm: ShardedFM, entries: dict, Lm: int, add) -> None:
    """Route each local shard's (m, w) entries [merged position, ...] to the
    shard that owns the position in the merged partition, where
    ``add(shard, entries)`` takes them."""
    mesh = sfm.mesh
    dest = {s: (e[:, 0] // Lm).clamp_max(mesh.size - 1)
            for s, e in entries.items()}
    for d, e in mesh.all_to_all(entries, dest).items():
        add(d, e)


def _split_narrow(chunk: torch.Tensor, ends: list):
    """(narrow, wide) rows of a pair chunk: narrow rows span at most two
    blocks on both sides; ``ends`` are the columns of side 1's first and
    last coordinate, then side 2's."""
    b = chunk[:, ends] >> 7
    keep = ((b[:, 1] - b[:, 0]) <= 1) & ((b[:, 3] - b[:, 2]) <= 1)
    return chunk[keep], chunk[~keep]


def _leaf_pair_step(sfm1: ShardedFM, sfm2: ShardedFM, Lm: int, chunks: dict,
                    difs: dict, stats: dict, K: int, k_right: int) -> dict:
    """One mesh step of the leaf-pair phase (``_leaf_pair_body`` on every
    shard): K, R and DA boundary deltas to their merged owners, then the
    left extensions in both indexes."""
    mesh = sfm1.mesh
    entries, narrow, wide = {}, {}, {}
    for s, chunk in chunks.items():
        bounds = traverse.leaf_pair_bounds(chunk, stats[s], K, k_right)
        entries[s] = torch.cat([_bound_entries(lo, hi, lane)
                                for lane, (lo, hi) in enumerate(bounds)])
        narrow[s], wide[s] = _split_narrow(chunk, [0, 1, 2, 3])
    _add_merged(sfm1, entries, Lm,
                lambda d, e: _add_deltas(difs[d], e, d * Lm, Lm))

    r2 = _routed_rank(sfm2, {s: c[:, 2:4] for s, c in narrow.items()})
    children = {s: traverse.leaf_pair_children(
        sfm1.F.to(c.device), sfm2.F.to(c.device), c,
        _narrow_rank(sfm1, s, c[:, 0:2]), r2[s]) for s, c in narrow.items()}

    W = _gather_wide(sfm1, wide)  # (NW, 5)
    w_children = W
    if W.shape[0]:  # the same on every process
        w_children = traverse.leaf_pair_children(
            sfm1.F, sfm2.F, W, shard_ops.sharded_parallel_rank(sfm1, W[:, 0:2]),
            shard_ops.sharded_parallel_rank(sfm2, W[:, 2:4]))

    out = {s: [] for s in mesh.local}
    _route(sfm1, children, w_children, out)
    return out


def _extend(F: torch.Tensor, ranks: torch.Tensor) -> torch.Tensor:
    """(C, 4, 6) extended boundaries from the ranks (C, 6, 4) of nodes'
    boundaries (``fm_index.extend_coords``)."""
    return F.to(ranks.device)[:, None] + ranks.transpose(1, 2)


def _node_pair_step(sfm1: ShardedFM, sfm2: ShardedFM, Lm: int, chunks: dict,
                    flags: dict, stats: dict, K: int, k_right: int) -> dict:
    """One mesh step of the node-pair phase (``_node_pair_body`` on every
    shard): the merged flags (DA bit of size-1 leaves, LCP borders, minima)
    to their merged owners, then the Weiner extension in both indexes."""
    mesh = sfm1.mesh
    entries, narrow, wide = {}, {}, {}
    for s, chunk in chunks.items():
        pos, v = traverse.node_pair_flags(chunk, stats[s], K, k_right)
        entries[s] = torch.stack([pos, v.to(torch.int64)], 1)
        narrow[s], wide[s] = _split_narrow(chunk, [0, 5, 6, 11])
    _add_merged(sfm1, entries, Lm, lambda d, e: traverse.add_at(
        flags[d], e[:, 0] - d * Lm, e[:, 1].to(torch.uint8)))

    r2 = _routed_rank(sfm2, {s: c[:, 6:12] for s, c in narrow.items()})
    children = {s: traverse.node_pair_children(
        _extend(sfm1.F, _narrow_rank(sfm1, s, c[:, 0:6])),
        _extend(sfm2.F, r2[s]), c) for s, c in narrow.items()}

    W = _gather_wide(sfm1, wide)  # (NW, 13)
    w_children = W
    if W.shape[0]:  # the same on every process
        w_children = traverse.node_pair_children(
            _extend(sfm1.F, shard_ops.sharded_parallel_rank(sfm1, W[:, 0:6])),
            _extend(sfm2.F, shard_ops.sharded_parallel_rank(sfm2, W[:, 6:12])),
            W)

    out = {s: [] for s in mesh.local}
    _route(sfm1, children, w_children, out)
    return out


def navigate_two_bwts_sharded(sfm1: ShardedFM, sfm2: ShardedFM, K: int,
                              k_right: int, ckpt_dir=None,
                              ckpt_every: int = 0):
    """Frontier-sharded lockstep navigation of two indexes on one mesh
    (mode 2): the leaf-pair phase, then the node-pair phase, over n = n1 +
    n2 merged positions partitioned in ``merged_local_n(n, S)`` positions a
    shard. Refuses n >= ``packing.CAP`` before it allocates. Returns
    (thr_K, thr_R, minima, da, stats): each a dict of the local shards'
    uint8 vectors over their merged positions (0 past n), and ``stats`` the
    counts of ``traverse.navigate_two_bwts`` (``da_values`` among them) plus
    the mesh steps, ``comm_bytes_per_step`` (the bytes of the rows that the
    ``all_to_all``s send to another shard, over the mesh, per step; the
    wide rows' gathers are not in it); its phases are spans as there.
    ``ckpt_dir`` and ``ckpt_every`` act as in ``navigate_one_bwt_sharded``;
    a resumed phase restores its routed bytes, so ``comm_bytes_per_step``
    is the uninterrupted run's."""
    mesh = sfm1.mesh
    n1, n2 = sfm1.n, sfm2.n
    n = n1 + n2
    shard_ops._check_mesh_cap(n)
    Lm = merged_local_n(n, mesh.size)
    dev = mesh.devices
    meta = {"n1": n1, "n2": n2, "Lm": Lm, "K": K, "k_right": k_right,
            "rows": [sfm1.rows, sfm2.rows]}
    routed = mesh.routed_bytes
    with span("leaf_phase"):
        difs = {s: [torch.zeros(Lm, dtype=torch.int32, device=dev[s])
                    for _ in range(3)] for s in mesh.local}  # K, R, DA
        st_l = {s: torch.zeros(3, dtype=torch.int64, device=dev[s])
                for s in mesh.local}  # leaves, lcp, da
        F1, F2 = sfm1.F.tolist(), sfm2.F.tolist()
        leaf_steps = _drive(
            sfm1, 5, torch.tensor([[0, F1[0], 0, F2[0], 0]]),
            lambda c: _leaf_pair_step(sfm1, sfm2, Lm, c, difs, st_l, K,
                                      k_right),
            _checkpoint(mesh, ckpt_dir, ckpt_every, "pleaf",
                        {s: [*difs[s], st_l[s]] for s in mesh.local},
                        width=5, **meta))
        fills = _fills(sfm1, difs)
        mesh.synchronize()

    with span("node_phase"):
        flags = {s: torch.zeros(Lm, dtype=torch.uint8, device=dev[s])
                 for s in mesh.local}
        st_n = {s: torch.zeros(4, dtype=torch.int64, device=dev[s])
                for s in mesh.local}  # nodes, lcp, n_min, da
        node_steps = _drive(
            sfm1, 13, torch.tensor([[0, *F1, n1, 0, *F2, n2, 0]]),
            lambda c: _node_pair_step(sfm1, sfm2, Lm, c, flags, st_n, K,
                                      k_right),
            _checkpoint(mesh, ckpt_dir, ckpt_every, "pnode",
                        {s: [flags[s], st_n[s]] for s in mesh.local},
                        width=13, **meta))
        thr_K, thr_R, minima, da = {}, {}, {}, {}
        for s in mesh.local:
            thr_K[s], thr_R[s], minima[s], da[s] = traverse._combine_dense(
                flags.pop(s), fills.pop(s))
        mesh.synchronize()

    l = mesh.psum(st_l).tolist()
    n_ = mesh.psum(st_n).tolist()
    steps = leaf_steps + node_steps
    stats = {"leaves": l[0], "nodes": n_[0], "lcp_values": 1 + l[1] + n_[1],
             "n_min": n_[2], "da_values": l[2] + n_[3],
             "leaf_steps": leaf_steps, "node_steps": node_steps,
             "comm_bytes_per_step":
                 mesh.psum_int(mesh.routed_bytes - routed) // max(steps, 1)}
    return thr_K, thr_R, minima, da, stats
