"""End-to-end pipelines of the three run modes: counterparts of
``ebwt2indel_tpu/models/pipeline.py``'s ``run_one_dataset`` (mode 1,
genotyping; reference ebwt2InDel.cpp:1584-1674), ``run_two_datasets``
(mode 2, two eBWTs; cpp:1344-1465) and ``run_two_datasets_da`` (mode 3, a
merged eBWT and its document array; cpp:1471-1579).

Phases: pack and upload the index (fm_index.py), the leaf then node
wavefront (traverse.py), cluster detection (cluster.py), the filter,
consensus and right-context walks (call.py), and host emission
(emit_vec.py). The log lines are the JAX package's, plus timing lines; each
run returns ``stats["seconds"]``, its spans (``utils/profile.py``): the
wall time of each phase, each ended by a device synchronise, and of the
parts timed inside it. ``EBWT_PROFILE=<dir>`` traces each run, each span
marked. ``stats["emit_counts"]`` holds what the emission's filters kept
and dropped (``emit_vec.SINGLE_COUNTS``, ``emit_vec.PAIR_COUNTS``; all
zero where no cluster reached emission).

The parts, each placed at its call site:

* ``index.pack``: reading the eBWT file(s) and packing them on the host;
  ``index.upload``: the upload and the phase's closing synchronise (the
  pageable copies block); ``index.da_side``: mode 3's DA-side worker,
  which runs beside phases 1-3.
* ``cluster.next_set``: the anchor table's build (``ops/scan.py``), on
  the device's clock.
* ``call_emit.walks``: the calling walks through their last device-to-host
  copy; ``call_emit.write``: the host's emission and the ``.snp`` write,
  and within it ``emit_vec.py``'s ``call_emit.align`` (its vectorized
  half: contexts ordered, alignments, filters) and ``call_emit.format``
  (the per-record loop and the write);
  ``call_emit.da_rank``: the document array's rank (modes 2 and 3), on the
  device's clock.
* ``node_phase.wait`` is the traversal's (``traverse.py``).
"""

from __future__ import annotations

import contextvars
import sys
from concurrent.futures import ThreadPoolExecutor
from functools import partial

import numpy as np
import torch

from .. import device as device_mod
from ..ops import bits, packing, rank, scan
from ..utils import dna
from ..utils.config import Config
from ..utils.profile import profiled, span, spent
from . import call, cluster, emit_vec, traverse
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
    route's flags (pipeline.py:132-142 of the JAX package). The anchor
    table's build is the span ``cluster.next_set``, on the device's
    clock."""
    with span("cluster.next_set", device=res.thr_R.device):
        anchor = (call._anchor_from_words(res.thr_R, n) if res.packed
                  else scan.next_set(res.thr_R))
    if res.packed:
        return anchor, cluster.find_clusters_device_packed(
            res.thr_K, res.minima, n=n, mcov_out=mcov_out)
    return anchor, cluster.find_clusters_device(res.thr_K, res.minima,
                                                mcov_out)


def _load_index(path: str, term: int, dev: torch.device) -> FMIndex:
    """Pack an eBWT file on the host (``index.pack``) and upload it
    (``index.upload``, ended by a synchronise)."""
    with span("index.pack"):
        pb = FMIndex.pack_file(path, term)
    with span("index.upload"):
        fm = FMIndex.from_packed(pb, dev)
        device_mod.synchronize(dev)
    return fm


def _log_phases(log, extra: str = "") -> None:
    log(f"[timing] leaf phase {spent('leaf_phase'):.2f}s, "
        f"node phase {spent('node_phase'):.2f}s{extra}\n")


@profiled
def run_one_dataset(cfg: Config, log=_log, device="cuda",
                    packed: bool | None = None, ckpt_dir=None,
                    ckpt_every: int = 0) -> dict:
    """Mode 1 on ``device``. ``packed`` chooses the traversal's route
    (``traverse.navigate_one_bwt``; None: by ``traverse.LEAN_N``), and
    ``ckpt_dir``/``ckpt_every`` its checkpoint and resume. Returns
    the JAX package's stats (events, cluster_nr, traversal counts,
    n_clusters) plus ``seconds``, the run's spans."""
    dev = device_mod.resolve(device)
    cfg = cfg.resolved()
    log("Phase 1/4: loading and indexing eBWT ... ")
    with span("index") as sp:
        fm = _load_index(cfg.input1, cfg.term, dev)
    log(f"done. [{sp.seconds:.2f}s]")

    log("\nPhase 2-3/4: suffix-tree wavefront navigation.")
    res = traverse.navigate_one_bwt(fm, cfg.K, cfg.k_right, packed,
                                    ckpt_dir=ckpt_dir, ckpt_every=ckpt_every)
    st = res.stats
    log(f"Computed {st['lcp_values']}/{fm.n} LCP values.")
    log(f"Found {st['n_min']} LCP minima.")
    log(f"Max pending frontier = {st['max_pending']}")
    log(f"Processed {st['leaves']} suffix-tree leaves and {st['nodes']} "
        f"nodes. [{spent('leaf_phase', 'node_phase'):.2f}s]")
    _log_phases(log)

    log("Phase 4/4: detecting SNPs and indels.")
    log(f"Output events will be stored in {cfg.output}")
    with span("cluster") as sp:
        next_thr, cl = _anchor_and_clusters(res, fm.n, cfg.mcov_out)
        del res
        device_mod.synchronize(dev)
    log(f"[timing] cluster detect (device) {sp.seconds:.2f}s")

    with span("call_emit") as sp:
        stats = _call_and_emit_single(fm, cl, next_thr, cfg)
    log(f"[timing] call+emit {sp.seconds:.2f}s")
    stats.update(st)
    stats["n_clusters"] = cl.n_clusters

    log_single_summary(cl, stats, log)
    return stats


def log_single_summary(cl: cluster.Clusters, stats: dict, log=_log) -> None:
    """Mode 1's closing lines and cluster histogram (the end of the
    reference's run_one_dataset, ebwt2InDel.cpp:1584-1674)."""
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


def _call_and_emit_single(fm: FMIndex, cl: cluster.Clusters, next_thr,
                          cfg: Config) -> dict:
    return call_and_emit_single(
        cl, cfg, fm.device,
        range_counts=lambda b, e: call.range_counts(fm, b, e),
        consensus=lambda b, e: call.extract_consensus_batch(
            fm, b, e, k_left=cfg.k_left),
        anchor=lambda b, e: call.first_thr_position_device(next_thr, b, e),
        dna=lambda p, f: call.extract_dna_batch(fm, p, f,
                                                k_right=cfg.k_right))


def call_and_emit_single(cl: cluster.Clusters, cfg: Config, dev, *,
                         range_counts, consensus, anchor, dna) -> dict:
    """Mode 1's calling and emission over the walks of one index, on one
    device or on the mesh (``parallel/pipeline.py``): ``range_counts(b,
    e)``, ``consensus(b, e)``, ``anchor(b, e)`` (the right-context anchor
    and whether it was found) and ``dna(pos, found)``."""
    B = cl.n_clusters
    none = emit_vec.nothing_emitted(emit_vec.SINGLE_COUNTS)
    with open(cfg.output, "w") as out_f:
        if B == 0:
            return none

        with span("call_emit.walks"):
            # cheap filter first, on the device; only the B survivor
            # booleans come to the host (the reference rejects clusters on
            # base counts before any context extraction,
            # ebwt2InDel.cpp:947-966)
            quirk, _pure = range_counts(cl.begins, cl.ends)
            freq_d = quirk >= cfg.mcov_out  # TERM->A quirk included
            nfreq = freq_d.sum(1)
            passes_d = nfreq >= 2
            if cfg.max_variants_per_position > 0:
                passes_d &= nfreq <= cfg.max_variants_per_position
            passes = passes_d.cpu().numpy()
            sel = np.flatnonzero(passes)
            if len(sel) == 0:
                return none

            sel_d = torch.from_numpy(sel).to(dev)
            sb = cl.begins[sel_d]
            se = cl.ends[sel_d]
            ctx, support, full = consensus(sb, se)
            pos, found = anchor(sb, se)
            seq, seqlen = dna(pos, found)
            found, freq, full, support, ctx, seq, seqlen = _to_host(
                found, freq_d[sel_d], full, support, ctx, seq, seqlen)

        with span("call_emit.write"):
            return emit_vec.emit_single(
                out_f, cfg, found, passes[sel], freq, full, support,
                _decode_rows(ctx, cfg.term), _decode_rows(seq, cfg.term),
                seqlen)


def _to_host(*tensors) -> list[np.ndarray]:
    """The walks' results on the host, copied in order (each copy waits
    for the device)."""
    return [t.cpu().numpy() for t in tensors]


def log_pair_summary(cl: cluster.Clusters, log) -> None:
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


@profiled
def run_two_datasets(cfg: Config, log=_log, device="cuda",
                     packed: bool | None = None, ckpt_dir=None,
                     ckpt_every: int = 0) -> dict:
    """Mode 2 on ``device``: two eBWTs (``-1``, ``-2``) merged implicitly by
    the lockstep traversal. ``packed``, ``ckpt_dir`` and ``ckpt_every`` as
    in ``run_one_dataset``, over the merged n. Returns the JAX package's
    stats (with ``da_values``) plus ``seconds``, the run's spans."""
    dev = device_mod.resolve(device)
    cfg = cfg.resolved()
    log("Phase 1/4: loading and indexing eBWTs ... ")
    # input 1 first: a bad input 1 is reported before input 2 (cpp:1750-1758)
    with span("index") as sp:
        fm1 = _load_index(cfg.input1, cfg.term, dev)
        fm2 = _load_index(cfg.input2, cfg.term, dev)
    log(f"done. [{sp.seconds:.2f}s]")

    log("\nPhase 2-3/4: merged suffix-tree wavefront navigation.")
    res = traverse.navigate_two_bwts(fm1, fm2, cfg.K, cfg.k_right, packed,
                                     ckpt_dir=ckpt_dir,
                                     ckpt_every=ckpt_every)
    st = res.stats
    n = fm1.n + fm2.n
    log(f"Computed {st['da_values']}/{n} DA values.")
    log(f"Computed {st['lcp_values']}/{n} LCP values.")
    log(f"Found {st['n_min']} LCP minima.")
    log(f"Processed {st['leaves']} suffix-tree leaves and {st['nodes']} "
        f"nodes. [{spent('leaf_phase', 'node_phase'):.2f}s]")
    _log_phases(log)

    log("Phase 4/4: detecting SNPs and indels.")
    log(f"Output events will be stored in {cfg.output}")
    with span("cluster") as sp:
        # the DA stays on the device as a rank structure (the reference
        # scans its vector<bool> DA, cpp:1431-1432); the packed route's DA
        # is already words in its layout (pipeline.py:276-277). Built
        # first, so that its n-sized int64 temporaries are freed before
        # the anchor table is allocated.
        da_bv = ((res.da, bits.bv_counts(res.da)) if res.packed
                 else bits.bv_build(res.da))
        next_thr, cl = _anchor_and_clusters(res, n, cfg.mcov_out)
        del res
        device_mod.synchronize(dev)
    log(f"[timing] cluster detect and DA rank build (device) "
        f"{sp.seconds:.2f}s")

    with span("call_emit") as sp:
        stats = _call_and_emit_pair_mode2(fm1, fm2, cl, next_thr, da_bv,
                                          cfg)
    log(f"[timing] call+emit {sp.seconds:.2f}s")
    stats.update(st)
    stats["n_clusters"] = cl.n_clusters
    log_pair_summary(cl, log)
    return stats


def _call_and_emit_pair_mode2(fm1: FMIndex, fm2: FMIndex,
                              cl: cluster.Clusters, next_thr, da_bv,
                              cfg: Config) -> dict:
    words, counts = da_bv
    fms = (fm1, fm2)
    return call_and_emit_pair_mode2(
        cl, cfg, fm1.device,
        da_rank1=lambda i: rank.bv_rank1(words, counts, i),
        da_get=lambda i: rank.bv_get(words, i),
        range_counts=[partial(call.range_counts, fm) for fm in fms],
        consensus=[partial(call.extract_consensus_batch, fm,
                           k_left=cfg.k_left) for fm in fms],
        anchor=lambda b, e: call.first_thr_position_device(next_thr, b, e),
        dna=[partial(call.extract_dna_batch, fm, k_right=cfg.k_right)
             for fm in fms])


def call_and_emit_pair_mode2(cl: cluster.Clusters, cfg: Config, dev, *,
                             da_rank1, da_get, range_counts, consensus,
                             anchor, dna) -> dict:
    """Mode 2's calling and emission, on one device or on the mesh
    (``parallel/pipeline.py``): ``da_rank1(i)`` and ``da_get(i)`` (int64 0
    or 1) over the merged document array, ``anchor(b, e)`` over the merged
    anchor table, and a pair of walks, one per index, in ``range_counts``
    ((b, e) -> quirk, pure), ``consensus`` ((b, e)) and ``dna`` ((pos,
    found))."""
    none = emit_vec.nothing_emitted(emit_vec.PAIR_COUNTS)
    with open(cfg.output, "w") as out_f:
        if cl.n_clusters == 0:
            return none
        with span("call_emit.walks"):
            begins, ends = cl.begins, cl.ends
            # each sample's sub-range of a merged range, by DA rank (the
            # reference advances i0/i1 position by position,
            # cpp:1431-1432)
            with span("call_emit.da_rank", device=dev):
                b1 = da_rank1(begins)
                e1 = da_rank1(ends)
            b0 = begins - b1
            e0 = ends - e1
            quirk0, _ = range_counts[0](b0, e0)
            quirk1, _ = range_counts[1](b1, e1)
            passes = _pair_passes(quirk0, quirk1, cfg).cpu().numpy()
            sel = np.flatnonzero(passes)
            if len(sel) == 0:
                return none

            sel_d = torch.from_numpy(sel).to(dev)
            ctx0, support0, full0 = consensus[0](b0[sel_d], e0[sel_d])
            ctx1, support1, full1 = consensus[1](b1[sel_d], e1[sel_d])
            # the right context comes from the index that holds the anchor
            # position; each walk runs only on its own side's clusters
            pos, found = anchor(begins[sel_d], ends[sel_d])
            with span("call_emit.da_rank", device=dev):
                hit1 = da_rank1(pos)
            da_at = da_get(pos) != 0
            seq0, len0 = dna[0](pos - hit1, found & ~da_at)
            seq1, len1 = dna[1](hit1, found & da_at)
            seq = torch.where(da_at[:, None], seq1, seq0)
            seqlen = torch.where(da_at, len1, len0)
            (found, freq0, full0, freq1, full1, support0, support1, ctx0,
             ctx1, seq, seqlen) = _to_host(
                found, quirk0[sel_d] >= cfg.mcov_out, full0,
                quirk1[sel_d] >= cfg.mcov_out, full1, support0, support1,
                ctx0, ctx1, seq, seqlen)

        # every walked cluster passed _pair_passes, so the emission's own
        # both-covered test (pipeline.py:404-411) holds for all of them
        with span("call_emit.write"):
            return emit_vec.emit_pair(
                out_f, cfg, found, freq0, full0, freq1, full1, support0,
                support1, _decode_rows(ctx0, cfg.term),
                _decode_rows(ctx1, cfg.term), _decode_rows(seq, cfg.term),
                seqlen)


def mask_da0(raw: np.ndarray, da: np.ndarray, term: int) -> np.ndarray:
    """The eBWT bytes of mode 3's DA = 1 side: each byte whose document
    array bit ``da`` (0/1 uint8) is 0 becomes TERM (in ASCII, so the native
    packer packs it). The select is done in uint8 arithmetic, exact modulo
    256: np.where is ~5x slower at 116M positions."""
    t = np.uint8(term)
    return (raw - t) * da + t


@profiled
def run_two_datasets_da(cfg: Config, log=_log, device="cuda",
                        packed: bool | None = None, ckpt_dir=None,
                        ckpt_every: int = 0) -> dict:
    """Mode 3 on ``device``: one merged eBWT (``-1``) and its document array
    (``-d``). The traversal is mode 1's, and so are ``packed``, ``ckpt_dir``
    and ``ckpt_every``. Returns the JAX package's stats plus ``seconds``,
    the run's spans."""
    dev = device_mod.resolve(device)
    cfg = cfg.resolved()
    log("Phase 1/4: loading and indexing eBWT ... ")

    def da_side():
        with span("index.da_side"):
            da = packing.read_da_file(cfg.input_da, raw.size)
            # the index of the DA = 1 side; each sample's counts come from
            # two rank differences
            fm_da1 = FMIndex.from_packed(
                packing.pack_bytes(mask_da0(raw, da, cfg.term), cfg.term),
                dev)
            return fm_da1, bits.from_numpy(*packing.pack_bitvector(da),
                                           device=dev)

    # the DA side does not feed the traversal: it is built in a worker
    # thread behind phases 2-3 (pipeline.py:433-452), in a copy of this
    # context, so its span joins this run's record
    with ThreadPoolExecutor(1) as ex:
        with span("index") as sp:
            with span("index.pack"):
                raw = np.fromfile(cfg.input1, dtype=np.uint8)
                da_fut = ex.submit(contextvars.copy_context().run, da_side)
                pb = packing.pack_bytes(raw, cfg.term)
            with span("index.upload"):
                fm = FMIndex.from_packed(pb, dev)
                device_mod.synchronize(dev)
        log(f"done. [{sp.seconds:.2f}s]")

        log("\nPhase 2-3/4: suffix-tree wavefront navigation.")
        res = traverse.navigate_one_bwt(fm, cfg.K, cfg.k_right, packed,
                                        ckpt_dir=ckpt_dir,
                                        ckpt_every=ckpt_every)
        st = res.stats
        log(f"Computed {st['lcp_values']}/{fm.n} LCP values.")
        log(f"Found {st['n_min']} LCP minima.")
        _log_phases(log)

        log("Phase 4/4: detecting SNPs and indels.")
        log(f"Output events will be stored in {cfg.output}")
        with span("da_wait") as sp:
            fm_da1, da_bv = da_fut.result()
            device_mod.synchronize(dev)
    log(f"[timing] DA-side index wait {sp.seconds:.2f}s")

    with span("cluster") as sp:
        next_thr, cl = _anchor_and_clusters(res, fm.n, cfg.mcov_out)
        del res
        device_mod.synchronize(dev)
    log(f"[timing] cluster detect (device) {sp.seconds:.2f}s")

    with span("call_emit") as sp:
        stats = _call_and_emit_pair_mode3(fm, fm_da1, cl, next_thr, da_bv,
                                          cfg)
    log(f"[timing] call+emit {sp.seconds:.2f}s")
    stats.update(st)
    stats["n_clusters"] = cl.n_clusters
    log_pair_summary(cl, log)
    # the reference prints its never-incremented `events` counter here,
    # always 0 (ebwt2InDel.cpp:1577)
    log(f"\nStored to file 0 sequences clustered in "
        f"{stats['cluster_nr'] - 1} clusters.")
    return stats


def _call_and_emit_pair_mode3(fm: FMIndex, fm_da1: FMIndex,
                              cl: cluster.Clusters, next_thr, da_bv,
                              cfg: Config) -> dict:
    words, counts = da_bv
    return call_and_emit_pair_mode3(
        cl, cfg, fm.device,
        range_counts_all=lambda b, e: call.range_counts(fm, b, e),
        range_counts_da1=lambda b, e: call.range_counts(fm_da1, b, e),
        da_rank1=lambda i: rank.bv_rank1(words, counts, i),
        consensus=lambda b, e: call.extract_consensus_batch(
            fm, b, e, k_left=cfg.k_left),
        anchor=lambda b, e: call.first_thr_position_device(next_thr, b, e),
        dna=lambda p, f: call.extract_dna_batch(fm, p, f,
                                                k_right=cfg.k_right))


def call_and_emit_pair_mode3(cl: cluster.Clusters, cfg: Config, dev, *,
                             range_counts_all, range_counts_da1, da_rank1,
                             consensus, anchor, dna) -> dict:
    """Mode 3's calling and emission, on one device or on the mesh
    (``parallel/pipeline.py``): ``range_counts_all(b, e)`` over the merged
    index and ``range_counts_da1(b, e)`` over its DA = 1 side (quirk,
    pure), ``da_rank1(i)`` over the document array, and ``consensus(b,
    e)``, ``anchor(b, e)`` and ``dna(pos, found)`` over the merged
    index."""
    none = emit_vec.nothing_emitted(emit_vec.PAIR_COUNTS)
    with open(cfg.output, "w") as out_f:
        if cl.n_clusters == 0:
            return none
        with span("call_emit.walks"):
            begins, ends = cl.begins, cl.ends
            # each sample's counts with the TERM->A quirk applied per side
            # (find_variants with a DA, ebwt2InDel.cpp:1013-1030); the
            # lengths come from the DA rank
            _, pure_all = range_counts_all(begins, ends)
            _, pure1 = range_counts_da1(begins, ends)
            with span("call_emit.da_rank", device=dev):
                len1 = da_rank1(ends) - da_rank1(begins)
            pure0 = pure_all - pure1
            quirk1 = pure1.clone()
            quirk1[:, 0] += len1 - pure1.sum(1)
            quirk0 = pure0.clone()
            quirk0[:, 0] += (ends - begins - len1) - pure0.sum(1)
            passes = _pair_passes(quirk0, quirk1, cfg).cpu().numpy()
            sel = np.flatnonzero(passes)
            if len(sel) == 0:
                return none

            # both samples' left contexts come from the merged index
            # (cpp:1057-1058), so they share the consensus and its support
            sel_d = torch.from_numpy(sel).to(dev)
            sb = begins[sel_d]
            se = ends[sel_d]
            ctx, support, full = consensus(sb, se)
            pos, found = anchor(sb, se)
            seq, seqlen = dna(pos, found)
            ctx, support, full, found, freq0, freq1, seq, seqlen = _to_host(
                ctx, support, full, found, quirk0[sel_d] >= cfg.mcov_out,
                quirk1[sel_d] >= cfg.mcov_out, seq, seqlen)

        # every walked cluster passed _pair_passes (see mode 2)
        with span("call_emit.write"):
            ctx_ascii = _decode_rows(ctx, cfg.term)
            return emit_vec.emit_pair(
                out_f, cfg, found, freq0, full, freq1, full, support,
                support, ctx_ascii, ctx_ascii, _decode_rows(seq, cfg.term),
                seqlen)
