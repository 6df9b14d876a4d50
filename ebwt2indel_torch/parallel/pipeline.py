"""The three run modes on the position mesh (counterpart of
``ebwt2indel_tpu/parallel/pipeline.py``'s ``run_one_dataset_sharded``,
``run_two_datasets_sharded`` and ``run_two_datasets_da_sharded``, with
their calling and emission).

Every O(n) structure (the index rows, the flags, the document array, the
anchor table) stays sharded; clusters and the walks' state are
O(#clusters) and every shard holds them; emission runs on the host of
every process, and only process 0 writes the ``.snp``
(``launch.redirect_output``). Its bytes equal the single-device pipeline's,
whose emission (``models/pipeline.py``'s ``call_and_emit_*``) runs here
over the sharded walks. Select it with ``EBWT_MESH=<shards>`` on the CLI,
or call it with a ``mesh.Mesh``.

A collective must come in the same order on every process, and each
loader's totals gather is one: with more than one process the indexes are
built one after the other; in one process the second is built in a worker
thread (mode 3: behind the traversal, as on one device).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from functools import partial

import numpy as np
import torch

from ..models import pipeline as mpipe
from ..utils.config import Config
from ..utils.profile import recorded, span, spent
from . import calling, frontier, shard
from .mesh import Mesh


@recorded
def run_one_dataset_sharded(cfg: Config, mesh: Mesh, log=mpipe._log,
                            ckpt_dir=None, ckpt_every: int = 0) -> dict:
    """Mode 1 over ``mesh``. ``ckpt_dir`` and ``ckpt_every`` give the
    traversal's checkpoint and resume (``frontier``; each process writes
    its own files). Returns the stats of ``models.pipeline.run_one_dataset``
    (its ``seconds`` too, each phase ended by a device synchronise) plus
    the traversal's mesh steps."""
    cfg = cfg.resolved()
    log("Phase 1/4: loading and indexing eBWT ... ")
    with span("index") as sp:
        # the sharded loader: this process packs only its shards' byte
        # ranges
        sfm = shard.shard_fm_from_file(cfg.input1, mesh, cfg.term)
        mesh.synchronize()
    log(f"done. [{sp.seconds:.2f}s]")
    log(f"[loader] process {mesh.proc} packed {sfm.local_bytes}/{sfm.n} "
        "input bytes")

    log(f"\nPhase 2-3/4: suffix-tree wavefront navigation "
        f"({mesh.size}-device mesh).")
    thr_K, thr_R, minima, st = frontier.navigate_one_bwt_sharded(
        sfm, cfg.K, cfg.k_right, ckpt_dir, ckpt_every)
    log(f"Computed {st['lcp_values']}/{sfm.n} LCP values.")
    log(f"Found {st['n_min']} LCP minima.")
    log(f"Processed {st['leaves']} suffix-tree leaves and {st['nodes']} "
        f"nodes. [{spent('leaf_phase', 'node_phase'):.2f}s]")
    mpipe._log_phases(log, _steps(st))

    log("Phase 4/4: detecting SNPs and indels.")
    log(f"Output events will be stored in {cfg.output}")
    L = sfm.local_n
    with span("cluster") as sp:
        next_thr = calling.next_set_table_sharded(mesh, thr_R, local_n=L,
                                                  n=sfm.n)
        del thr_R
        cl = calling.find_clusters_sharded(mesh, thr_K, minima, local_n=L,
                                           n=sfm.n, mcov_out=cfg.mcov_out)
        del thr_K, minima
        mesh.synchronize()
    log(f"[timing] cluster detect (sharded) {sp.seconds:.2f}s")

    with span("call_emit") as sp:
        stats = _call_and_emit_single_sharded(sfm, cl, next_thr, cfg)
    log(f"[timing] call+emit {sp.seconds:.2f}s")
    stats.update(st)
    stats["n_clusters"] = cl.n_clusters

    mpipe.log_single_summary(cl, stats, log)
    return stats


def _steps(st: dict) -> str:
    """The mesh steps (and routed bytes) of the timing line."""
    routed = (f", {st['comm_bytes_per_step']} routed bytes per step"
              if "comm_bytes_per_step" in st else "")
    return (f" ({st['leaf_steps']} and {st['node_steps']} mesh steps"
            f"{routed})")


def _call_and_emit_single_sharded(sfm: shard.ShardedFM, cl, next_thr: dict,
                                  cfg: Config) -> dict:
    return mpipe.call_and_emit_single(
        cl, cfg, sfm.mesh.device,
        range_counts=lambda b, e: calling.range_counts_sharded(sfm, b, e),
        consensus=lambda b, e: calling.extract_consensus_sharded(
            sfm, b, e, k_left=cfg.k_left),
        anchor=lambda b, e: calling.first_thr_position_sharded(
            sfm.mesh, next_thr, b, e, local_n=sfm.local_n),
        dna=lambda p, f: calling.extract_dna_sharded(sfm, p, f,
                                                     k_right=cfg.k_right))


def _log_loader(sfm: shard.ShardedFM, log) -> None:
    log(f"[loader] process {sfm.mesh.proc} packed {sfm.local_bytes}/{sfm.n} "
        "input bytes")


def load_da_side(mesh: Mesh, raw: np.ndarray, da: np.ndarray, term: int):
    """Mode 3's DA side over ``mesh`` from the merged eBWT's bytes ``raw``
    and the DA file's bytes ``da`` (memmaps, so each process reads only its
    shards' ranges): the index of the DA = 1 side, whose loader makes DA = 0
    bytes TERM one range at a time (no process builds an O(n) masked
    string), and the document array's rank structure in the index's
    partition. Returns (ShardedFM, ShardedBits)."""
    n = raw.shape[0]
    sfm_da1 = shard.shard_fm_from_loader(
        lambda lo, hi: mpipe.mask_da0(
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
def run_two_datasets_da_sharded(cfg: Config, mesh: Mesh,
                                log=mpipe._log, ckpt_dir=None,
                                ckpt_every: int = 0) -> dict:
    """Mode 3 over ``mesh``: the merged index (``-1``), its DA = 1 side
    built by the sharded loader from the eBWT and the document array
    (``-d``) range by range, and the document array's rank structure. The
    traversal is mode 1's, and so are ``ckpt_dir`` and ``ckpt_every``.
    Returns the stats of ``models.pipeline.run_two_datasets_da`` (its
    ``seconds`` with ``da_wait`` too) plus the traversal's mesh steps."""
    cfg = cfg.resolved()
    log("Phase 1/4: loading and indexing eBWT ... ")
    with ThreadPoolExecutor(1) as ex:
        with span("index") as sp:
            n = os.path.getsize(cfg.input1)
            raw = np.memmap(cfg.input1, dtype=np.uint8, mode="r") if n \
                else np.zeros(0, np.uint8)
            da = np.memmap(cfg.input_da, dtype=np.uint8, mode="r") if n \
                else np.zeros(0, np.uint8)
            args = (mesh, raw, da, cfg.term)
            # one process: the DA side does not feed the traversal, so it
            # is built in a worker thread behind phases 2-3
            da_fut = ex.submit(load_da_side, *args) if mesh.nprocs == 1 \
                else None
            sfm = shard.shard_fm_from_file(cfg.input1, mesh, cfg.term)
            side = load_da_side(*args) if da_fut is None else None
            mesh.synchronize()
        log(f"done. [{sp.seconds:.2f}s]")
        _log_loader(sfm, log)

        log(f"\nPhase 2-3/4: suffix-tree wavefront navigation "
            f"({mesh.size}-device mesh).")
        thr_K, thr_R, minima, st = frontier.navigate_one_bwt_sharded(
            sfm, cfg.K, cfg.k_right, ckpt_dir, ckpt_every)
        log(f"Computed {st['lcp_values']}/{sfm.n} LCP values.")
        log(f"Found {st['n_min']} LCP minima.")
        mpipe._log_phases(log, _steps(st))

        log("Phase 4/4: detecting SNPs and indels.")
        log(f"Output events will be stored in {cfg.output}")
        with span("da_wait") as sp:
            sfm_da1, da_bv = side or da_fut.result()
            mesh.synchronize()
    log(f"[timing] DA-side index wait {sp.seconds:.2f}s")

    L = sfm.local_n
    with span("cluster") as sp:
        next_thr = calling.next_set_table_sharded(mesh, thr_R, local_n=L,
                                                  n=n)
        del thr_R
        cl = calling.find_clusters_sharded(mesh, thr_K, minima, local_n=L,
                                           n=n, mcov_out=cfg.mcov_out)
        del thr_K, minima
        mesh.synchronize()
    log(f"[timing] cluster detect (sharded) {sp.seconds:.2f}s")

    with span("call_emit") as sp:
        stats = mpipe.call_and_emit_pair_mode3(
            cl, cfg, mesh.device,
            range_counts_all=lambda b, e: calling.range_counts_sharded(
                sfm, b, e),
            range_counts_da1=lambda b, e: calling.range_counts_sharded(
                sfm_da1, b, e),
            da_rank1=lambda i: calling.bv_rank1_sharded(da_bv, i),
            consensus=lambda b, e: calling.extract_consensus_sharded(
                sfm, b, e, k_left=cfg.k_left),
            anchor=lambda b, e: calling.first_thr_position_sharded(
                mesh, next_thr, b, e, local_n=L),
            dna=lambda p, f: calling.extract_dna_sharded(
                sfm, p, f, k_right=cfg.k_right))
    log(f"[timing] call+emit {sp.seconds:.2f}s")
    stats.update(st)
    stats["n_clusters"] = cl.n_clusters
    mpipe.log_pair_summary(cl, log)
    # the reference prints its never-incremented `events` counter here,
    # always 0 (ebwt2InDel.cpp:1577)
    log(f"\nStored to file 0 sequences clustered in "
        f"{stats['cluster_nr'] - 1} clusters.")
    return stats


@recorded
def run_two_datasets_sharded(cfg: Config, mesh: Mesh, log=mpipe._log,
                             ckpt_dir=None, ckpt_every: int = 0) -> dict:
    """Mode 2 over ``mesh``: two indexes (``-1``, ``-2``), each in its own
    block partition, traversed in lockstep (``frontier.
    navigate_two_bwts_sharded``, with ``ckpt_dir`` and ``ckpt_every``); the
    merged flags and document array in a third (``frontier.
    merged_local_n``). n1 + n2 is checked against ``packing.CAP`` before
    anything is read. Returns the stats of
    ``models.pipeline.run_two_datasets`` plus the mesh steps and
    ``comm_bytes_per_step``."""
    cfg = cfg.resolved()
    log("Phase 1/4: loading and indexing eBWTs ... ")
    with span("index") as sp:
        shard._check_mesh_cap(os.path.getsize(cfg.input1)
                              + os.path.getsize(cfg.input2))
        # input 1 first: a bad input 1 is reported before input 2
        if mesh.nprocs > 1:
            sfm1 = shard.shard_fm_from_file(cfg.input1, mesh, cfg.term)
            sfm2 = shard.shard_fm_from_file(cfg.input2, mesh, cfg.term)
        else:
            with ThreadPoolExecutor(1) as ex:
                f2 = ex.submit(shard.shard_fm_from_file, cfg.input2, mesh,
                               cfg.term)
                sfm1 = shard.shard_fm_from_file(cfg.input1, mesh, cfg.term)
                sfm2 = f2.result()
        mesh.synchronize()
    log(f"done. [{sp.seconds:.2f}s]")
    _log_loader(sfm1, log)
    _log_loader(sfm2, log)

    log(f"\nPhase 2-3/4: merged suffix-tree wavefront navigation "
        f"({mesh.size}-device mesh).")
    thr_K, thr_R, minima, da, st = frontier.navigate_two_bwts_sharded(
        sfm1, sfm2, cfg.K, cfg.k_right, ckpt_dir, ckpt_every)
    n = sfm1.n + sfm2.n
    log(f"Computed {st['da_values']}/{n} DA values.")
    log(f"Computed {st['lcp_values']}/{n} LCP values.")
    log(f"Found {st['n_min']} LCP minima.")
    log(f"Processed {st['leaves']} suffix-tree leaves and {st['nodes']} "
        f"nodes. [{spent('leaf_phase', 'node_phase'):.2f}s]")
    mpipe._log_phases(log, _steps(st))

    log("Phase 4/4: detecting SNPs and indels.")
    log(f"Output events will be stored in {cfg.output}")
    L = frontier.merged_local_n(n, mesh.size)
    with span("cluster") as sp:
        next_thr = calling.next_set_table_sharded(mesh, thr_R, local_n=L,
                                                  n=n)
        del thr_R
        cl = calling.find_clusters_sharded(mesh, thr_K, minima, local_n=L,
                                           n=n, mcov_out=cfg.mcov_out)
        del thr_K, minima
        da_bv = calling.bv_build_sharded(mesh, da, local_n=L)
        del da
        mesh.synchronize()
    log(f"[timing] cluster detect and DA rank build (sharded) "
        f"{sp.seconds:.2f}s")

    sfms = (sfm1, sfm2)
    with span("call_emit") as sp:
        stats = mpipe.call_and_emit_pair_mode2(
            cl, cfg, mesh.device,
            da_rank1=lambda i: calling.bv_rank1_sharded(da_bv, i),
            da_get=lambda i: calling.bv_get_sharded(da_bv, i),
            range_counts=[partial(calling.range_counts_sharded, x)
                          for x in sfms],
            consensus=[partial(calling.extract_consensus_sharded, x,
                               k_left=cfg.k_left) for x in sfms],
            anchor=lambda b, e: calling.first_thr_position_sharded(
                mesh, next_thr, b, e, local_n=L),
            dna=[partial(calling.extract_dna_sharded, x,
                         k_right=cfg.k_right) for x in sfms])
    log(f"[timing] call+emit {sp.seconds:.2f}s")
    stats.update(st)
    stats["n_clusters"] = cl.n_clusters
    mpipe.log_pair_summary(cl, log)
    return stats
