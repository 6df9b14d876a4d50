"""Mode 1 on the position mesh (counterpart of
``ebwt2indel_tpu/parallel/pipeline.py``'s ``run_one_dataset_sharded`` and
``_call_and_emit_single_sharded``).

Every O(n) structure (the index rows, the flags, the anchor table) stays
sharded; clusters and the walks' state are O(#clusters) and every shard
holds them; emission runs on the host of every process, and only process 0
writes the ``.snp`` (``launch.redirect_output``). Its bytes equal the
single-device pipeline's. Select it with ``EBWT_MESH=<shards>`` on the CLI,
or call it with a ``mesh.Mesh``.
"""

from __future__ import annotations

import time

from ..models import pipeline as mpipe
from ..utils.config import Config
from . import calling, frontier, shard
from .mesh import Mesh


def run_one_dataset_sharded(cfg: Config, mesh: Mesh, log=mpipe._log) -> dict:
    """Mode 1 over ``mesh``. Returns the stats of
    ``models.pipeline.run_one_dataset`` (its ``seconds`` too, each phase
    ended by a device synchronise) plus the traversal's mesh steps."""
    cfg = cfg.resolved()
    seconds = {}
    t0 = time.perf_counter()
    log("Phase 1/4: loading and indexing eBWT ... ")
    # the sharded loader: this process packs only its shards' byte ranges
    sfm = shard.shard_fm_from_file(cfg.input1, mesh, cfg.term)
    mesh.synchronize()
    t1 = time.perf_counter()
    seconds["index"] = t1 - t0
    log(f"done. [{t1 - t0:.2f}s]")
    log(f"[loader] process {mesh.proc} packed {sfm.local_bytes}/{sfm.n} "
        "input bytes")

    log(f"\nPhase 2-3/4: suffix-tree wavefront navigation "
        f"({mesh.size}-device mesh).")
    thr_K, thr_R, minima, st = frontier.navigate_one_bwt_sharded(
        sfm, cfg.K, cfg.k_right)
    t2 = time.perf_counter()
    seconds["leaf_phase"] = st.pop("leaf_seconds")
    seconds["node_phase"] = st.pop("node_seconds")
    log(f"Computed {st['lcp_values']}/{sfm.n} LCP values.")
    log(f"Found {st['n_min']} LCP minima.")
    log(f"Processed {st['leaves']} suffix-tree leaves and {st['nodes']} "
        f"nodes. [{t2 - t1:.2f}s]")
    log(f"[timing] leaf phase {seconds['leaf_phase']:.2f}s, "
        f"node phase {seconds['node_phase']:.2f}s "
        f"({st['leaf_steps']} and {st['node_steps']} mesh steps)\n")

    log("Phase 4/4: detecting SNPs and indels.")
    log(f"Output events will be stored in {cfg.output}")
    L = sfm.local_n
    next_thr = calling.next_set_table_sharded(mesh, thr_R, local_n=L,
                                              n=sfm.n)
    del thr_R
    cl = calling.find_clusters_sharded(mesh, thr_K, minima, local_n=L,
                                       n=sfm.n, mcov_out=cfg.mcov_out)
    del thr_K, minima
    mesh.synchronize()
    t4 = time.perf_counter()
    seconds["cluster"] = t4 - t2
    log(f"[timing] cluster detect (sharded) {t4 - t2:.2f}s")

    stats = _call_and_emit_single_sharded(sfm, cl, next_thr, cfg)
    seconds["call_emit"] = time.perf_counter() - t4
    log(f"[timing] call+emit {seconds['call_emit']:.2f}s")
    stats.update(st)
    stats["n_clusters"] = cl.n_clusters
    stats["seconds"] = seconds

    mpipe.log_single_summary(cl, stats, log)
    return stats


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
