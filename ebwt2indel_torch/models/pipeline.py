"""End-to-end mode-1 pipeline (genotyping one collection): counterpart of
``ebwt2indel_tpu/models/pipeline.py::run_one_dataset`` (reference
run_one_dataset, ebwt2InDel.cpp:1584-1674).

Phases: pack and upload the index (fm_index.py), the leaf then node
wavefront (traverse.py), cluster detection (cluster.py), the filter,
consensus and right-context walks (call.py), and host emission
(emit_vec.py). The log lines are the JAX package's, plus one timing line per
traversal phase.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from .. import device as device_mod
from ..utils import dna
from ..utils.config import Config
from . import call, cluster, emit, emit_vec, traverse
from .fm_index import FMIndex

MAX_CLUST_LEN = cluster.MAX_CLUST_LEN


def _log(msg: str, file=None):
    print(msg, file=file or sys.stdout, flush=True)


def histogram_str(hist: np.ndarray) -> str:
    """ASCII cluster-size histogram (ebwt2InDel.cpp:1454-1462)."""
    scale = max(int(hist.max()), 1)
    lines = []
    for i in range(MAX_CLUST_LEN + 1):
        pad = "   " if i < 10 else ("  " if i < 100 else " ")
        bars = "-" * ((100 * int(hist[i])) // scale)
        lines.append(f"{i}{pad}{bars} {int(hist[i])}")
    return "\n".join(lines)


def print_histogram(hist: np.ndarray, log=_log):
    log(histogram_str(hist))


def _decode_rows(codes: np.ndarray, term: int):
    """(..., L) int8 codes -> ASCII bytes for lazy per-row slicing."""
    return dna.decode_table(term)[codes.astype(np.uint8)]


def run_one_dataset(cfg: Config, log=_log, device="cuda") -> dict:
    """Mode 1 on ``device``. Returns the JAX package's stats (events,
    cluster_nr, traversal counts, n_clusters) plus ``seconds``: the wall
    time of each phase, each ended by a device synchronise."""
    dev = device_mod.resolve(device)
    cfg = cfg.resolved()
    seconds = {}
    t0 = time.perf_counter()
    log("Phase 1/4: loading and indexing eBWT ... ")
    fm = FMIndex.from_file(cfg.input1, cfg.term, dev)
    device_mod.synchronize(dev)
    t1 = time.perf_counter()
    seconds["index"] = t1 - t0
    log(f"done. [{t1 - t0:.2f}s]")

    log("\nPhase 2-3/4: suffix-tree wavefront navigation.")
    res = traverse.navigate_one_bwt(fm, cfg.K, cfg.k_right)
    t2 = time.perf_counter()
    st = res.stats
    seconds["leaf_phase"] = st.pop("leaf_seconds")
    seconds["node_phase"] = st.pop("node_seconds")
    log(f"Computed {st['lcp_values']}/{fm.n} LCP values.")
    log(f"Found {st['n_min']} LCP minima.")
    log(f"Max pending frontier = {st['max_pending']}")
    log(f"Processed {st['leaves']} suffix-tree leaves and {st['nodes']} "
        f"nodes. [{t2 - t1:.2f}s]")
    log(f"[timing] leaf phase {seconds['leaf_phase']:.2f}s, "
        f"node phase {seconds['node_phase']:.2f}s\n")

    log("Phase 4/4: detecting SNPs and indels.")
    log(f"Output events will be stored in {cfg.output}")
    next_thr = call.next_set_table(res.thr_R)
    cl = cluster.find_clusters_device(res.thr_K, res.minima, cfg.mcov_out)
    del res
    device_mod.synchronize(dev)
    t4 = time.perf_counter()
    seconds["cluster"] = t4 - t2
    log(f"[timing] cluster detect (device) {t4 - t2:.2f}s")

    stats = _call_and_emit_single(fm, cl, next_thr, cfg)
    seconds["call_emit"] = time.perf_counter() - t4
    log(f"[timing] call+emit {seconds['call_emit']:.2f}s")
    stats.update(st)
    stats["n_clusters"] = cl.n_clusters
    stats["seconds"] = seconds

    avg = cl.clust_size_sum / cl.n_clusters if cl.n_clusters else float("nan")
    log(f"\nDone.\nAnalyzed {cl.n_clusters} clusters.")
    log(f"Average cluster length: {avg}.\n")
    log(
        f"Stored to file {stats['events']} events clustered in "
        f"{stats['cluster_nr'] - 1} clusters.\n"
    )
    log(
        "Distribution of bases inside clusters "
        "(cluster length / number of bases inside clusters of that length): "
    )
    print_histogram(cl.hist, log)
    return stats


def _call_and_emit_single(fm: FMIndex, cl: cluster.Clusters, next_thr,
                          cfg: Config) -> dict:
    B = cl.n_clusters
    with open(cfg.output, "w") as out_f:
        writer = emit.SnpWriter(
            out_f, complexity=cfg.complexity, max_snvs=cfg.max_snvs,
            mcov_out=cfg.mcov_out, max_gap=cfg.max_gap,
        )
        if B == 0:
            return {"events": 0, "cluster_nr": writer.cluster_nr}

        # cheap filter first, on the device; only the B survivor booleans
        # come to the host (the reference rejects clusters on base counts
        # before any context extraction, ebwt2InDel.cpp:947-966)
        quirk, _pure = call.range_counts(fm, cl.begins, cl.ends)
        freq_d = quirk >= cfg.mcov_out  # TERM->A quirk included
        nfreq = freq_d.sum(1)
        passes_d = nfreq >= 2
        if cfg.max_variants_per_position > 0:
            passes_d &= nfreq <= cfg.max_variants_per_position
        passes = passes_d.cpu().numpy()
        sel = np.flatnonzero(passes)
        if len(sel) == 0:
            return {"events": 0, "cluster_nr": 1}

        sel_d = torch.from_numpy(sel).to(fm.device)
        sb = cl.begins[sel_d]
        se = cl.ends[sel_d]
        ctx, support, full = call.extract_consensus_batch(
            fm, sb, se, k_left=cfg.k_left)
        pos, found = call.first_thr_position_device(next_thr, sb, se)
        seq, seqlen = call.extract_dna_batch(fm, pos, found,
                                             k_right=cfg.k_right)

        out = emit_vec.emit_single(
            out_f, cfg, found.cpu().numpy(), passes[sel],
            freq_d[sel_d].cpu().numpy(), full.cpu().numpy(),
            support.cpu().numpy(),
            _decode_rows(ctx.cpu().numpy(), cfg.term),
            _decode_rows(seq.cpu().numpy(), cfg.term),
            seqlen.cpu().numpy(),
        )
        return out
