"""End-to-end pipelines of the three run modes: counterparts of
``ebwt2indel_tpu/models/pipeline.py``'s ``run_one_dataset`` (mode 1,
genotyping; reference ebwt2InDel.cpp:1584-1674), ``run_two_datasets``
(mode 2, two eBWTs; cpp:1344-1465) and ``run_two_datasets_da`` (mode 3, a
merged eBWT and its document array; cpp:1471-1579).

Phases: pack and upload the index (fm_index.py), the leaf then node
wavefront (traverse.py), cluster detection (cluster.py), the filter,
consensus and right-context walks (call.py), and host emission
(emit_vec.py). The log lines are the JAX package's, plus timing lines; each
run returns ``stats["seconds"]``, the wall time of each phase, each ended by
a device synchronise.
"""

from __future__ import annotations

import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import device as device_mod
from ..ops import bits, packing, rank
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


def _anchor_and_clusters(res: traverse.TraversalResult, n: int,
                         mcov_out: int):
    """The right-context anchor structure and the clusters, from either
    route's flags (pipeline.py:132-142 of the JAX package)."""
    if res.packed:
        return (call._anchor_from_words(res.thr_R, n),
                cluster.find_clusters_device_packed(
                    res.thr_K, res.minima, n=n, mcov_out=mcov_out))
    return (call.next_set_table(res.thr_R),
            cluster.find_clusters_device(res.thr_K, res.minima, mcov_out))


def run_one_dataset(cfg: Config, log=_log, device="cuda",
                    packed: bool | None = None) -> dict:
    """Mode 1 on ``device``. ``packed`` chooses the traversal's route
    (``traverse.navigate_one_bwt``; None: by ``traverse.LEAN_N``). Returns
    the JAX package's stats (events, cluster_nr, traversal counts,
    n_clusters) plus ``seconds``: the wall time of each phase, each ended
    by a device synchronise."""
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
    res = traverse.navigate_one_bwt(fm, cfg.K, cfg.k_right, packed)
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
    next_thr, cl = _anchor_and_clusters(res, fm.n, cfg.mcov_out)
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


def _log_pair_summary(cl: cluster.Clusters, log) -> None:
    avg = cl.clust_size_sum / cl.n_clusters if cl.n_clusters else float("nan")
    log(f"\nDone.\nAnalyzed {cl.n_clusters} clusters.")
    log(f"Average cluster length: {avg}.\n")
    log(
        "Distribution of bases inside clusters "
        "(cluster length / number of bases inside clusters of that length): \n"
    )
    print_histogram(cl.hist, log)


def _pair_passes(quirk0: torch.Tensor, quirk1: torch.Tensor,
                 cfg: Config) -> torch.Tensor:
    """The clusters worth the context walks (pipeline.py:378-393): both
    samples have a frequent character (ebwt2InDel.cpp:870-880), within -q,
    and their frequent sets are not the same single character, which could
    give no pair whose final characters differ (cpp:921)."""
    freq0 = quirk0 >= cfg.mcov_out
    freq1 = quirk1 >= cfg.mcov_out
    n0 = freq0.sum(1)
    n1 = freq1.sum(1)
    passes = (n0 > 0) & (n1 > 0)
    if cfg.max_variants_per_position > 0:
        q = cfg.max_variants_per_position
        passes &= (n0 <= q) & (n1 <= q)
    same_single = (n0 == 1) & (n1 == 1) & ((freq0 & freq1).sum(1) == 1)
    return passes & ~same_single


def run_two_datasets(cfg: Config, log=_log, device="cuda",
                     packed: bool | None = None) -> dict:
    """Mode 2 on ``device``: two eBWTs (``-1``, ``-2``) merged implicitly by
    the lockstep traversal. ``packed`` as in ``run_one_dataset``, over the
    merged n. Returns the JAX package's stats (with ``da_values``) plus
    ``seconds``, the wall time of each phase."""
    dev = device_mod.resolve(device)
    cfg = cfg.resolved()
    seconds = {}
    t0 = time.perf_counter()
    log("Phase 1/4: loading and indexing eBWTs ... ")
    # input 1 first: a bad input 1 is reported before input 2 (cpp:1750-1758)
    fm1 = FMIndex.from_file(cfg.input1, cfg.term, dev)
    fm2 = FMIndex.from_file(cfg.input2, cfg.term, dev)
    device_mod.synchronize(dev)
    t1 = time.perf_counter()
    seconds["index"] = t1 - t0
    log(f"done. [{t1 - t0:.2f}s]")

    log("\nPhase 2-3/4: merged suffix-tree wavefront navigation.")
    res = traverse.navigate_two_bwts(fm1, fm2, cfg.K, cfg.k_right, packed)
    t2 = time.perf_counter()
    st = res.stats
    seconds["leaf_phase"] = st.pop("leaf_seconds")
    seconds["node_phase"] = st.pop("node_seconds")
    n = fm1.n + fm2.n
    log(f"Computed {st['da_values']}/{n} DA values.")
    log(f"Computed {st['lcp_values']}/{n} LCP values.")
    log(f"Found {st['n_min']} LCP minima.")
    log(f"Processed {st['leaves']} suffix-tree leaves and {st['nodes']} "
        f"nodes. [{t2 - t1:.2f}s]")
    log(f"[timing] leaf phase {seconds['leaf_phase']:.2f}s, "
        f"node phase {seconds['node_phase']:.2f}s\n")

    log("Phase 4/4: detecting SNPs and indels.")
    log(f"Output events will be stored in {cfg.output}")
    next_thr, cl = _anchor_and_clusters(res, n, cfg.mcov_out)
    # the DA stays on the device as a rank structure (the reference scans
    # its vector<bool> DA, cpp:1431-1432); the packed route's DA is already
    # words in its layout (pipeline.py:276-277)
    da_bv = ((res.da, bits.bv_counts(res.da)) if res.packed
             else bits.bv_build(res.da))
    del res
    device_mod.synchronize(dev)
    t4 = time.perf_counter()
    seconds["cluster"] = t4 - t2
    log(f"[timing] cluster detect and DA rank build (device) {t4 - t2:.2f}s")

    stats = _call_and_emit_pair_mode2(fm1, fm2, cl, next_thr, da_bv, cfg)
    seconds["call_emit"] = time.perf_counter() - t4
    log(f"[timing] call+emit {seconds['call_emit']:.2f}s")
    stats.update(st)
    stats["n_clusters"] = cl.n_clusters
    stats["seconds"] = seconds
    _log_pair_summary(cl, log)
    return stats


def _call_and_emit_pair_mode2(fm1: FMIndex, fm2: FMIndex,
                              cl: cluster.Clusters, next_thr, da_bv,
                              cfg: Config) -> dict:
    with open(cfg.output, "w") as out_f:
        if cl.n_clusters == 0:
            return {"events": 0, "cluster_nr": 1}
        words, counts = da_bv
        begins, ends = cl.begins, cl.ends
        # each sample's sub-range of a merged range, by DA rank (the
        # reference advances i0/i1 position by position, cpp:1431-1432)
        b1 = rank.bv_rank1(words, counts, begins)
        e1 = rank.bv_rank1(words, counts, ends)
        b0 = begins - b1
        e0 = ends - e1
        quirk0, _ = call.range_counts(fm1, b0, e0)
        quirk1, _ = call.range_counts(fm2, b1, e1)
        passes = _pair_passes(quirk0, quirk1, cfg).cpu().numpy()
        sel = np.flatnonzero(passes)
        if len(sel) == 0:
            return {"events": 0, "cluster_nr": 1}

        sel_d = torch.from_numpy(sel).to(fm1.device)
        ctx0, support0, full0 = call.extract_consensus_batch(
            fm1, b0[sel_d], e0[sel_d], k_left=cfg.k_left)
        ctx1, support1, full1 = call.extract_consensus_batch(
            fm2, b1[sel_d], e1[sel_d], k_left=cfg.k_left)
        # the right context comes from the index that holds the anchor
        # position; each walk runs only on its own side's clusters
        pos, found = call.first_thr_position_device(
            next_thr, begins[sel_d], ends[sel_d])
        hit1 = rank.bv_rank1(words, counts, pos)
        da_at = rank.bv_get(words, pos) != 0
        seq0, len0 = call.extract_dna_batch(fm1, pos - hit1, found & ~da_at,
                                            k_right=cfg.k_right)
        seq1, len1 = call.extract_dna_batch(fm2, hit1, found & da_at,
                                            k_right=cfg.k_right)
        seq = torch.where(da_at[:, None], seq1, seq0)
        seqlen = torch.where(da_at, len1, len0)

        # every walked cluster passed _pair_passes, so the emission's own
        # both-covered test (pipeline.py:404-411) holds for all of them
        return emit_vec.emit_pair(
            out_f, cfg, found.cpu().numpy(),
            (quirk0[sel_d] >= cfg.mcov_out).cpu().numpy(),
            full0.cpu().numpy(),
            (quirk1[sel_d] >= cfg.mcov_out).cpu().numpy(),
            full1.cpu().numpy(),
            support0.cpu().numpy(), support1.cpu().numpy(),
            _decode_rows(ctx0.cpu().numpy(), cfg.term),
            _decode_rows(ctx1.cpu().numpy(), cfg.term),
            _decode_rows(seq.cpu().numpy(), cfg.term), seqlen.cpu().numpy(),
        )


def run_two_datasets_da(cfg: Config, log=_log, device="cuda",
                        packed: bool | None = None) -> dict:
    """Mode 3 on ``device``: one merged eBWT (``-1``) and its document array
    (``-d``). The traversal is mode 1's, and so is ``packed``. Returns the
    JAX package's stats plus ``seconds``, the wall time of each phase."""
    dev = device_mod.resolve(device)
    cfg = cfg.resolved()
    seconds = {}
    t0 = time.perf_counter()
    log("Phase 1/4: loading and indexing eBWT ... ")
    raw = np.fromfile(cfg.input1, dtype=np.uint8)

    def da_side():
        da = packing.read_da_file(cfg.input_da, raw.size)
        # the index of the DA = 1 side: DA = 0 characters become TERM (in
        # ASCII, so the native packer packs it), and each sample's counts
        # come from two rank differences. The select is done in uint8
        # arithmetic, exact modulo 256: np.where is ~5x slower at 116M.
        term = np.uint8(cfg.term)
        raw_da1 = (raw - term) * da + term
        fm_da1 = FMIndex.from_packed(packing.pack_bytes(raw_da1, cfg.term),
                                     dev)
        return fm_da1, bits.from_numpy(*packing.pack_bitvector(da),
                                       device=dev)

    # the DA side does not feed the traversal: it is built in a worker
    # thread behind phases 2-3 (pipeline.py:433-452)
    with ThreadPoolExecutor(1) as ex:
        da_fut = ex.submit(da_side)
        fm = FMIndex.from_packed(packing.pack_bytes(raw, cfg.term), dev)
        device_mod.synchronize(dev)
        t1 = time.perf_counter()
        seconds["index"] = t1 - t0
        log(f"done. [{t1 - t0:.2f}s]")

        log("\nPhase 2-3/4: suffix-tree wavefront navigation.")
        res = traverse.navigate_one_bwt(fm, cfg.K, cfg.k_right, packed)
        st = res.stats
        seconds["leaf_phase"] = st.pop("leaf_seconds")
        seconds["node_phase"] = st.pop("node_seconds")
        log(f"Computed {st['lcp_values']}/{fm.n} LCP values.")
        log(f"Found {st['n_min']} LCP minima.")
        log(f"[timing] leaf phase {seconds['leaf_phase']:.2f}s, "
            f"node phase {seconds['node_phase']:.2f}s\n")

        log("Phase 4/4: detecting SNPs and indels.")
        log(f"Output events will be stored in {cfg.output}")
        t2 = time.perf_counter()
        fm_da1, da_bv = da_fut.result()
    device_mod.synchronize(dev)
    t3 = time.perf_counter()
    seconds["da_wait"] = t3 - t2
    log(f"[timing] DA-side index wait {t3 - t2:.2f}s")

    next_thr, cl = _anchor_and_clusters(res, fm.n, cfg.mcov_out)
    del res
    device_mod.synchronize(dev)
    t4 = time.perf_counter()
    seconds["cluster"] = t4 - t3
    log(f"[timing] cluster detect (device) {t4 - t3:.2f}s")

    stats = _call_and_emit_pair_mode3(fm, fm_da1, cl, next_thr, da_bv, cfg)
    seconds["call_emit"] = time.perf_counter() - t4
    log(f"[timing] call+emit {seconds['call_emit']:.2f}s")
    stats.update(st)
    stats["n_clusters"] = cl.n_clusters
    stats["seconds"] = seconds
    _log_pair_summary(cl, log)
    # the reference prints its never-incremented `events` counter here,
    # always 0 (ebwt2InDel.cpp:1577)
    log(f"\nStored to file 0 sequences clustered in "
        f"{stats['cluster_nr'] - 1} clusters.")
    return stats


def _call_and_emit_pair_mode3(fm: FMIndex, fm_da1: FMIndex,
                              cl: cluster.Clusters, next_thr, da_bv,
                              cfg: Config) -> dict:
    with open(cfg.output, "w") as out_f:
        if cl.n_clusters == 0:
            return {"events": 0, "cluster_nr": 1}
        words, counts = da_bv
        begins, ends = cl.begins, cl.ends
        # each sample's counts with the TERM->A quirk applied per side
        # (find_variants with a DA, ebwt2InDel.cpp:1013-1030); the lengths
        # come from the DA rank
        _, pure_all = call.range_counts(fm, begins, ends)
        _, pure1 = call.range_counts(fm_da1, begins, ends)
        len1 = (rank.bv_rank1(words, counts, ends)
                - rank.bv_rank1(words, counts, begins))
        pure0 = pure_all - pure1
        quirk1 = pure1.clone()
        quirk1[:, 0] += len1 - pure1.sum(1)
        quirk0 = pure0.clone()
        quirk0[:, 0] += (ends - begins - len1) - pure0.sum(1)
        passes = _pair_passes(quirk0, quirk1, cfg).cpu().numpy()
        sel = np.flatnonzero(passes)
        if len(sel) == 0:
            return {"events": 0, "cluster_nr": 1}

        # both samples' left contexts come from the merged index
        # (cpp:1057-1058), so they share the consensus and its support
        sel_d = torch.from_numpy(sel).to(fm.device)
        sb = begins[sel_d]
        se = ends[sel_d]
        ctx, support, full = call.extract_consensus_batch(
            fm, sb, se, k_left=cfg.k_left)
        pos, found = call.first_thr_position_device(next_thr, sb, se)
        seq, seqlen = call.extract_dna_batch(fm, pos, found,
                                             k_right=cfg.k_right)

        ctx_ascii = _decode_rows(ctx.cpu().numpy(), cfg.term)
        support = support.cpu().numpy()
        full = full.cpu().numpy()
        # every walked cluster passed _pair_passes (see mode 2)
        return emit_vec.emit_pair(
            out_f, cfg, found.cpu().numpy(),
            (quirk0[sel_d] >= cfg.mcov_out).cpu().numpy(), full,
            (quirk1[sel_d] >= cfg.mcov_out).cpu().numpy(), full,
            support, support, ctx_ascii, ctx_ascii,
            _decode_rows(seq.cpu().numpy(), cfg.term), seqlen.cpu().numpy(),
        )
