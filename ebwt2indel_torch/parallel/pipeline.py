"""The three run modes on the position mesh (counterpart of
``ebwt2indel_tpu/parallel/pipeline.py``'s ``run_one_dataset_sharded``,
``run_two_datasets_sharded`` and ``run_two_datasets_da_sharded``, with
their calling and emission): ``models/pipeline.py``'s phase skeletons on
the mesh's placement, ``OnMesh``.

Every O(n) structure (the index rows, the flags, the document array, the
anchor table) stays sharded; clusters and the walks' state are
O(#clusters) and every shard holds them; emission runs on the host of
every process, and only process 0 writes the ``.snp``
(``launch.redirect_output``). Its bytes equal the single-device pipeline's.
Select it with ``EBWT_MESH=<shards>`` on the CLI, or call it with a
``mesh.Mesh``.

A collective must come in the same order on every process, and each
loader's totals gather is one: with more than one process the indexes are
built one after the other; in one process the second is built in a worker
thread (mode 3: behind the traversal, as on one device).
"""

from __future__ import annotations

import os
from concurrent.futures import Future, ThreadPoolExecutor
from functools import partial

import numpy as np
import torch

from ..models import call
from ..models import pipeline as mpipe
from ..ops import packing
from ..utils.config import Config
from ..utils.profile import recorded
from . import calling, frontier, shard
from .mesh import Mesh


class OnMesh:
    """The mesh's placement of ``models/pipeline.py``'s skeletons (the
    calls of ``models.pipeline.OneDevice``): each index packed by the
    sharded loader, this process only its shards' byte ranges; the
    traversal's checkpoint and resume in ``ckpt_dir`` every ``ckpt_every``
    mesh steps, each process its own files."""

    where = "sharded"

    def __init__(self, mesh: Mesh, ckpt_dir, ckpt_every: int):
        self.mesh = mesh
        self.note = f" ({mesh.size}-device mesh)"
        self.ckpt = (ckpt_dir, ckpt_every)

    def synchronize(self) -> None:
        self.mesh.synchronize()

    def load(self, path: str, term: int) -> shard.ShardedFM:
        sfm = shard.shard_fm_from_file(path, self.mesh, term)
        self.synchronize()
        return sfm

    def load_two(self, cfg: Config):
        """Both indexes, n1 + n2 checked against ``packing.CAP`` before
        anything is read."""
        mesh = self.mesh
        shard._check_mesh_cap(os.path.getsize(cfg.input1)
                              + os.path.getsize(cfg.input2))
        # input 1 first: a bad input 1 is reported before input 2
        with ThreadPoolExecutor(1) as ex:
            f2 = ex.submit(shard.shard_fm_from_file, cfg.input2, mesh,
                           cfg.term) if mesh.nprocs == 1 else None
            sfm1 = shard.shard_fm_from_file(cfg.input1, mesh, cfg.term)
            sfm2 = f2.result() if f2 else shard.shard_fm_from_file(
                cfg.input2, mesh, cfg.term)
        self.synchronize()
        return sfm1, sfm2

    def load_merged(self, cfg: Config, ex: ThreadPoolExecutor):
        """Mode 3's merged index, and a call that returns its DA side
        (``load_da_side``): built by ``ex`` beside the index in one
        process, after it in several."""
        mesh = self.mesh
        n = os.path.getsize(cfg.input1)
        raw = np.memmap(cfg.input1, dtype=np.uint8, mode="r") if n \
            else np.zeros(0, np.uint8)
        da = np.memmap(cfg.input_da, dtype=np.uint8, mode="r") if n \
            else np.zeros(0, np.uint8)
        args = (mesh, raw, da, cfg.term)
        if mesh.nprocs == 1:
            side = ex.submit(load_da_side, *args)
        sfm = shard.shard_fm_from_file(cfg.input1, mesh, cfg.term)
        if mesh.nprocs > 1:
            side = Future()
            side.set_result(load_da_side(*args))
        self.synchronize()
        return sfm, side.result

    def walks(self, sfm: shard.ShardedFM) -> call.Walks:
        return call.Walks(partial(shard.sharded_parallel_rank, sfm),
                          partial(shard.sharded_select, sfm), sfm.F,
                          self.mesh.device)

    def log_loaded(self, log, *sfms: shard.ShardedFM) -> None:
        for sfm in sfms:
            log(f"[loader] process {self.mesh.proc} packed "
                f"{sfm.local_bytes}/{sfm.n} input bytes")

    def steps(self, st: dict) -> str:
        """The mesh steps (and routed bytes) of the phase timing line."""
        routed = (f", {st['comm_bytes_per_step']} routed bytes per step"
                  if "comm_bytes_per_step" in st else "")
        return (f" ({st['leaf_steps']} and {st['node_steps']} mesh steps"
                f"{routed})")

    def navigate_one(self, sfm: shard.ShardedFM, cfg: Config):
        *flags, st = frontier.navigate_one_bwt_sharded(
            sfm, cfg.K, cfg.k_right, *self.ckpt)
        return calling.ShardedTraversal(self.mesh, sfm.local_n, sfm.n, st,
                                        *flags)

    def navigate_two(self, sfm1: shard.ShardedFM, sfm2: shard.ShardedFM,
                     cfg: Config):
        """The lockstep traversal (``frontier.navigate_two_bwts_sharded``),
        its merged flags and document array in a third partition
        (``frontier.merged_local_n``)."""
        *flags, st = frontier.navigate_two_bwts_sharded(
            sfm1, sfm2, cfg.K, cfg.k_right, *self.ckpt)
        n = sfm1.n + sfm2.n
        return calling.ShardedTraversal(
            self.mesh, frontier.merged_local_n(n, self.mesh.size), n, st,
            *flags)


def load_da_side(mesh: Mesh, raw: np.ndarray, da: np.ndarray, term: int):
    """Mode 3's DA side over ``mesh`` from the merged eBWT's bytes ``raw``
    and the DA file's bytes ``da`` (memmaps, so each process reads only its
    shards' ranges): the index of the DA = 1 side, whose loader makes DA = 0
    bytes TERM one range at a time (no process builds an O(n) masked
    string), and the document array's rank structure in the index's
    partition. Returns (ShardedFM, ShardedBits)."""
    n = raw.shape[0]
    sfm_da1 = shard.shard_fm_from_loader(
        lambda lo, hi: packing.mask_da0(
            raw[lo:hi], (da[lo:hi] == ord("1")).view(np.uint8), term),
        n, mesh, term)
    L = sfm_da1.local_n
    parts = {}
    for s in mesh.local:
        lo, hi = min(s * L, n), min((s + 1) * L, n)
        x = np.zeros(L, np.uint8)
        x[:hi - lo] = da[lo:hi] == ord("1")
        parts[s] = torch.from_numpy(x).to(mesh.devices[s])
    return sfm_da1, calling.bv_build_sharded(mesh, parts, local_n=L)


@recorded
def run_one_dataset_sharded(cfg: Config, mesh: Mesh, log=mpipe.log_stdout,
                            ckpt_dir=None, ckpt_every: int = 0) -> dict:
    """Mode 1 over ``mesh``. ``ckpt_dir`` and ``ckpt_every`` give the
    traversal's checkpoint and resume (``frontier``; each process writes
    its own files). Returns the stats of ``models.pipeline.run_one_dataset``
    (its ``seconds`` too, each phase ended by a device synchronise) plus
    the traversal's mesh steps."""
    return mpipe.one_dataset(cfg, OnMesh(mesh, ckpt_dir, ckpt_every), log)


@recorded
def run_two_datasets_da_sharded(cfg: Config, mesh: Mesh,
                                log=mpipe.log_stdout, ckpt_dir=None,
                                ckpt_every: int = 0) -> dict:
    """Mode 3 over ``mesh``: the merged index (``-1``), its DA = 1 side
    built by the sharded loader from the eBWT and the document array
    (``-d``) range by range, and the document array's rank structure. The
    traversal is mode 1's, and so are ``ckpt_dir`` and ``ckpt_every``.
    Returns the stats of ``models.pipeline.run_two_datasets_da`` (its
    ``seconds`` with ``da_wait`` too) plus the traversal's mesh steps."""
    return mpipe.two_datasets_da(cfg, OnMesh(mesh, ckpt_dir, ckpt_every),
                                 log)


@recorded
def run_two_datasets_sharded(cfg: Config, mesh: Mesh, log=mpipe.log_stdout,
                             ckpt_dir=None, ckpt_every: int = 0) -> dict:
    """Mode 2 over ``mesh``: two indexes (``-1``, ``-2``), each in its own
    block partition, traversed in lockstep (``frontier.
    navigate_two_bwts_sharded``, with ``ckpt_dir`` and ``ckpt_every``); the
    merged flags and document array in a third (``frontier.
    merged_local_n``). n1 + n2 is checked against ``packing.CAP`` before
    anything is read. Returns the stats of
    ``models.pipeline.run_two_datasets`` plus the mesh steps and
    ``comm_bytes_per_step``."""
    return mpipe.two_datasets(cfg, OnMesh(mesh, ckpt_dir, ckpt_every), log)
