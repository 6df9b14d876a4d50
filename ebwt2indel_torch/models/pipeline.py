"""End-to-end pipelines of the three run modes: counterparts of
``ebwt2indel_tpu/models/pipeline.py``'s ``run_one_dataset`` (mode 1,
genotyping; reference ebwt2InDel.cpp:1584-1674), ``run_two_datasets``
(mode 2, two eBWTs; cpp:1344-1465) and ``run_two_datasets_da`` (mode 3, a
merged eBWT and its document array; cpp:1471-1579).

Each mode is one phase skeleton (``one_dataset``, ``two_datasets``,
``two_datasets_da``) on a placement that says where the indexes live:
``OneDevice`` here, which ``run_one_dataset``, ``run_two_datasets`` and
``run_two_datasets_da`` use, or the mesh's ``parallel/pipeline.py::
OnMesh``. The traversal's result reads its flags in their own layout
(``traverse.TraversalResult``, the mesh's ``calling.ShardedTraversal``).

Phases: pack and upload the index (fm_index.py), the leaf then node
wavefront (traverse.py), cluster detection (cluster.py), the filter,
consensus and right-context walks (call.py), and emission (emit_vec.py):
mode 1's on the device that holds the walks' results (a CUDA kernel on the
card, numpy on the CPU), modes 2 and 3's on the host. The log lines are
the JAX package's, plus timing lines; each run returns
``stats["seconds"]``, its spans (``utils/profile.py``): the wall time of
each phase, each ended by a device synchronise, and of the parts timed
inside it. ``EBWT_PROFILE=<dir>`` traces each run, each span
marked. ``stats["emit_counts"]`` holds what the emission's filters kept
and dropped (``emit_vec.SINGLE_COUNTS``, ``emit_vec.PAIR_COUNTS``; all
zero where no cluster reached emission).

The parts, each placed at its call site:

* ``index.pack``: reading the eBWT file(s) and packing them on the host;
  ``index.upload``: the upload and the phase's closing synchronise (the
  pageable copies block); ``index.da_side``: mode 3's DA-side worker,
  which runs beside phases 1-3.
* ``cluster.next_set``: the anchor table's build
  (``traverse.TraversalResult.anchor``), on the device's clock.
* ``call_emit.walks``: the calling walks, through a device synchronise
  in mode 1 and through their last device-to-host copy in modes 2 and 3;
  ``call_emit.write``: the emission and the ``.snp`` write, and within it
  ``emit_vec.py``'s ``call_emit.align`` and ``call_emit.format``. In mode
  1 on the card these are the emission's kernels through the copy of
  their counts, and the copy of the records' text, its decode and the
  write; on the CPU, and in modes 2 and 3, the host's vectorized half
  (contexts ordered, alignments, filters) and its per-record loop and the
  write;
  ``call_emit.da_rank``: the document array's rank (modes 2 and 3), on the
  device's clock.
* ``node_phase.wait`` is the traversal's (``traverse.py``).
"""

from __future__ import annotations

import contextvars
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import device as device_mod
from ..ops import bits, packing, rank
from ..utils.config import Config
from ..utils.profile import profiled, span, spent
from . import call, cluster, emit_vec, traverse
from .fm_index import FMIndex


def log_stdout(msg: str, file=None):
    """The pipelines' default ``log``: a line on stdout, flushed."""
    print(msg, file=file or sys.stdout, flush=True)


def histogram_str(hist: np.ndarray) -> str:
    """ASCII cluster-size histogram (ebwt2InDel.cpp:1454-1462)."""
    scale = max(int(hist.max()), 1)
    lines = []
    for i in range(cluster.MAX_CLUST_LEN + 1):
        pad = "   " if i < 10 else ("  " if i < 100 else " ")
        bars = "-" * ((100 * int(hist[i])) // scale)
        lines.append(f"{i}{pad}{bars} {int(hist[i])}")
    return "\n".join(lines)


class OneDevice:
    """The skeletons' placement on one device. A placement loads the
    indexes (ending with a synchronise), runs the traversal, synchronises,
    wraps an index in its calling walks (``walks``) and supplies its log
    suffixes (``note``, ``where``, ``log_loaded``, ``steps``); the mesh's
    is ``parallel/pipeline.py::OnMesh``. ``packed``, ``ckpt_dir`` and
    ``ckpt_every`` go to the traversal."""

    note = ""
    where = "device"

    def __init__(self, device, packed: bool | None, ckpt_dir,
                 ckpt_every: int):
        self.device = device_mod.resolve(device)
        self.traversal = {"packed": packed, "ckpt_dir": ckpt_dir,
                          "ckpt_every": ckpt_every}

    def synchronize(self) -> None:
        device_mod.synchronize(self.device)

    def load(self, path: str, term: int) -> FMIndex:
        """Pack an eBWT file on the host (``index.pack``) and upload it
        (``index.upload``, ended by a synchronise)."""
        with span("index.pack"):
            pb = FMIndex.pack_file(path, term)
        with span("index.upload"):
            fm = FMIndex.from_packed(pb, self.device)
            self.synchronize()
        return fm

    def load_two(self, cfg: Config) -> tuple[FMIndex, FMIndex]:
        # input 1 first: a bad input 1 is reported before input 2
        # (cpp:1750-1758)
        return self.load(cfg.input1, cfg.term), self.load(cfg.input2,
                                                          cfg.term)

    def load_merged(self, cfg: Config, ex: ThreadPoolExecutor):
        """Mode 3's merged index, and a call that waits for its DA side
        (the DA = 1 side's index and the document array's ``BitRank``),
        which ``ex`` builds beside it, in a copy of this context, so that
        its span (``index.da_side``) joins this run's record."""
        def da_side():
            with span("index.da_side"):
                da = packing.read_da_file(cfg.input_da, raw.size)
                # the index of the DA = 1 side; each sample's counts come
                # from two rank differences
                fm_da1 = FMIndex.from_packed(packing.pack_bytes(
                    packing.mask_da0(raw, da, cfg.term), cfg.term),
                    self.device)
                return fm_da1, rank.BitRank(*bits.from_numpy(
                    *packing.pack_bitvector(da), device=self.device))

        with span("index.pack"):
            raw = np.fromfile(cfg.input1, dtype=np.uint8)
            da_fut = ex.submit(contextvars.copy_context().run, da_side)
            pb = packing.pack_bytes(raw, cfg.term)
        with span("index.upload"):
            fm = FMIndex.from_packed(pb, self.device)
            self.synchronize()
        return fm, da_fut.result

    def walks(self, fm: FMIndex) -> call.Walks:
        return call.Walks.of(fm)

    def log_loaded(self, log, *indexes) -> None:
        pass

    def steps(self, st: dict) -> str:
        return ""

    def navigate_one(self, fm: FMIndex, cfg: Config):
        return traverse.navigate_one_bwt(fm, cfg.K, cfg.k_right,
                                         **self.traversal)

    def navigate_two(self, fm1: FMIndex, fm2: FMIndex, cfg: Config):
        return traverse.navigate_two_bwts(fm1, fm2, cfg.K, cfg.k_right,
                                          **self.traversal)


def _anchor_and_clusters(res, mcov_out: int):
    """The right-context anchor and the clusters of a traversal's result,
    in its own layout and placement (pipeline.py:132-142 of the JAX
    package)."""
    return res.anchor(), res.clusters(mcov_out)


def _log_phases(log, place, st: dict) -> None:
    log(f"[timing] leaf phase {spent('leaf_phase'):.2f}s, "
        f"node phase {spent('node_phase'):.2f}s{place.steps(st)}\n")


def _log_processed(log, st: dict) -> None:
    log(f"Processed {st['leaves']} suffix-tree leaves and {st['nodes']} "
        f"nodes. [{spent('leaf_phase', 'node_phase'):.2f}s]")


def _log_phase4(log, cfg: Config) -> None:
    log("Phase 4/4: detecting SNPs and indels.")
    log(f"Output events will be stored in {cfg.output}")


def _call_emit(log, st: dict, cl: cluster.Clusters, call_and_emit,
               *args) -> dict:
    """The ``call_emit`` phase: ``call_and_emit(cl, *args)``'s stats with
    the traversal's and ``n_clusters``."""
    with span("call_emit") as sp:
        stats = call_and_emit(cl, *args)
    log(f"[timing] call+emit {sp.seconds:.2f}s")
    stats.update(st)
    stats["n_clusters"] = cl.n_clusters
    return stats


def _log_summary(cl: cluster.Clusters, log, stored: str = "") -> None:
    """The closing lines and cluster histogram (the end of each of the
    reference's runs, e.g. ebwt2InDel.cpp:1584-1674): mode 1 says what it
    ``stored`` before the histogram, whose title the pair modes end with a
    blank line."""
    avg = cl.clust_size_sum / cl.n_clusters if cl.n_clusters else float("nan")
    log(f"\nDone.\nAnalyzed {cl.n_clusters} clusters.")
    log(f"Average cluster length: {avg}.\n")
    if stored:
        log(stored)
    log("Distribution of bases inside clusters (cluster length / number of "
        "bases inside clusters of that length): " + ("" if stored else "\n"))
    log(histogram_str(cl.hist))


@profiled
def run_one_dataset(cfg: Config, log=log_stdout, device="cuda",
                    packed: bool | None = None, ckpt_dir=None,
                    ckpt_every: int = 0) -> dict:
    """Mode 1 on ``device``. ``packed`` chooses the traversal's route
    (``traverse.navigate_one_bwt``; None: by ``traverse.LEAN_N``), and
    ``ckpt_dir``/``ckpt_every`` its checkpoint and resume. Returns
    the JAX package's stats (events, cluster_nr, traversal counts,
    n_clusters) plus ``seconds``, the run's spans."""
    return one_dataset(cfg, OneDevice(device, packed, ckpt_dir, ckpt_every),
                       log)


def one_dataset(cfg: Config, place, log) -> dict:
    """Mode 1's phases on a placement (``OneDevice`` or the mesh's)."""
    cfg = cfg.resolved()
    log("Phase 1/4: loading and indexing eBWT ... ")
    with span("index") as sp:
        fm = place.load(cfg.input1, cfg.term)
    log(f"done. [{sp.seconds:.2f}s]")
    place.log_loaded(log, fm)

    log(f"\nPhase 2-3/4: suffix-tree wavefront navigation{place.note}.")
    res = place.navigate_one(fm, cfg)
    st = res.stats
    log(f"Computed {st['lcp_values']}/{fm.n} LCP values.")
    log(f"Found {st['n_min']} LCP minima.")
    if "max_pending" in st:
        log(f"Max pending frontier = {st['max_pending']}")
    _log_processed(log, st)
    _log_phases(log, place, st)

    _log_phase4(log, cfg)
    with span("cluster") as sp:
        anchor, cl = _anchor_and_clusters(res, cfg.mcov_out)
        del res
        place.synchronize()
    log(f"[timing] cluster detect ({place.where}) {sp.seconds:.2f}s")

    stats = _call_emit(log, st, cl, call_and_emit_single, cfg,
                       place.walks(fm), anchor)
    _log_summary(cl, log, f"Stored to file {stats['events']} events "
                 f"clustered in {stats['cluster_nr'] - 1} clusters.\n")
    return stats


def call_and_emit_single(cl: cluster.Clusters, cfg: Config, index,
                         anchor) -> dict:
    """Mode 1's calling and emission over the walks of one index
    (``call.Walks``) and the right-context ``anchor(b, e)`` (the anchor
    position and whether it was found)."""
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
            quirk, _pure = index.range_counts(cl.begins, cl.ends)
            freq_d = quirk >= cfg.mcov_out  # TERM->A quirk included
            nfreq = freq_d.sum(1)
            passes_d = nfreq >= 2
            if cfg.max_variants_per_position > 0:
                passes_d &= nfreq <= cfg.max_variants_per_position
            passes = passes_d.cpu().numpy()
            sel = np.flatnonzero(passes)
            if len(sel) == 0:
                return none

            sel_d = torch.from_numpy(sel).to(index.device)
            sb = cl.begins[sel_d]
            se = cl.ends[sel_d]
            ctx, support, full = index.consensus(sb, se, cfg.k_left)
            pos, found = anchor(sb, se)
            seq, seqlen = index.dna(pos, found, cfg.k_right)
            freq = freq_d[sel_d]
            # the walks' device time stays in this span
            device_mod.synchronize(index.device)

        # the emission runs where the walks' results lie (emit_vec.py)
        with span("call_emit.write"):
            return emit_vec.emit_single(out_f, cfg, found, freq, full,
                                        support, ctx, seq, seqlen)


def _to_host(*tensors) -> list[np.ndarray]:
    """The walks' results on the host, copied in order (each copy waits
    for the device)."""
    return [t.cpu().numpy() for t in tensors]


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
def run_two_datasets(cfg: Config, log=log_stdout, device="cuda",
                     packed: bool | None = None, ckpt_dir=None,
                     ckpt_every: int = 0) -> dict:
    """Mode 2 on ``device``: two eBWTs (``-1``, ``-2``) merged implicitly by
    the lockstep traversal. ``packed``, ``ckpt_dir`` and ``ckpt_every`` as
    in ``run_one_dataset``, over the merged n. Returns the JAX package's
    stats (with ``da_values``) plus ``seconds``, the run's spans."""
    return two_datasets(cfg, OneDevice(device, packed, ckpt_dir, ckpt_every),
                        log)


def two_datasets(cfg: Config, place, log) -> dict:
    """Mode 2's phases on a placement (``OneDevice`` or the mesh's)."""
    cfg = cfg.resolved()
    log("Phase 1/4: loading and indexing eBWTs ... ")
    with span("index") as sp:
        fm1, fm2 = place.load_two(cfg)
    log(f"done. [{sp.seconds:.2f}s]")
    place.log_loaded(log, fm1, fm2)

    log(f"\nPhase 2-3/4: merged suffix-tree wavefront navigation"
        f"{place.note}.")
    res = place.navigate_two(fm1, fm2, cfg)
    st = res.stats
    n = fm1.n + fm2.n
    log(f"Computed {st['da_values']}/{n} DA values.")
    log(f"Computed {st['lcp_values']}/{n} LCP values.")
    log(f"Found {st['n_min']} LCP minima.")
    _log_processed(log, st)
    _log_phases(log, place, st)

    _log_phase4(log, cfg)
    with span("cluster") as sp:
        # the DA stays on the device as a rank structure (the reference
        # scans its vector<bool> DA, cpp:1431-1432). Built first, so that
        # its n-sized int64 temporaries are freed before the anchor table
        # is allocated.
        da = res.da_rank()
        anchor, cl = _anchor_and_clusters(res, cfg.mcov_out)
        del res
        place.synchronize()
    log(f"[timing] cluster detect and DA rank build ({place.where}) "
        f"{sp.seconds:.2f}s")

    stats = _call_emit(log, st, cl, call_and_emit_pair_mode2, cfg,
                       (place.walks(fm1), place.walks(fm2)), da, anchor)
    _log_summary(cl, log)
    return stats


def call_and_emit_pair_mode2(cl: cluster.Clusters, cfg: Config, indexes,
                             da, anchor) -> dict:
    """Mode 2's calling and emission over the walks of the two indexes
    (``call.Walks``), the merged document array's rank structure ``da``
    (``rank.BitRank`` or the mesh's: ``rank1(i)``, ``get(i)``) and
    ``anchor(b, e)`` over the merged anchor table."""
    none = emit_vec.nothing_emitted(emit_vec.PAIR_COUNTS)
    dev = indexes[0].device
    with open(cfg.output, "w") as out_f:
        if cl.n_clusters == 0:
            return none
        with span("call_emit.walks"):
            begins, ends = cl.begins, cl.ends
            # each sample's sub-range of a merged range, by DA rank (the
            # reference advances i0/i1 position by position,
            # cpp:1431-1432)
            with span("call_emit.da_rank", device=dev):
                b1 = da.rank1(begins)
                e1 = da.rank1(ends)
            b0 = begins - b1
            e0 = ends - e1
            quirk0, _ = indexes[0].range_counts(b0, e0)
            quirk1, _ = indexes[1].range_counts(b1, e1)
            passes = _pair_passes(quirk0, quirk1, cfg).cpu().numpy()
            sel = np.flatnonzero(passes)
            if len(sel) == 0:
                return none

            sel_d = torch.from_numpy(sel).to(dev)
            ctx0, support0, full0 = indexes[0].consensus(
                b0[sel_d], e0[sel_d], cfg.k_left)
            ctx1, support1, full1 = indexes[1].consensus(
                b1[sel_d], e1[sel_d], cfg.k_left)
            # the right context comes from the index that holds the anchor
            # position; each walk runs only on its own side's clusters
            pos, found = anchor(begins[sel_d], ends[sel_d])
            with span("call_emit.da_rank", device=dev):
                hit1 = da.rank1(pos)
            da_at = da.get(pos) != 0
            seq0, len0 = indexes[0].dna(pos - hit1, found & ~da_at,
                                        cfg.k_right)
            seq1, len1 = indexes[1].dna(hit1, found & da_at, cfg.k_right)
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
                support1, emit_vec.decode_rows(ctx0, cfg.term),
                emit_vec.decode_rows(ctx1, cfg.term),
                emit_vec.decode_rows(seq, cfg.term), seqlen)


@profiled
def run_two_datasets_da(cfg: Config, log=log_stdout, device="cuda",
                        packed: bool | None = None, ckpt_dir=None,
                        ckpt_every: int = 0) -> dict:
    """Mode 3 on ``device``: one merged eBWT (``-1``) and its document array
    (``-d``). The traversal is mode 1's, and so are ``packed``, ``ckpt_dir``
    and ``ckpt_every``. Returns the JAX package's stats plus ``seconds``,
    the run's spans."""
    return two_datasets_da(
        cfg, OneDevice(device, packed, ckpt_dir, ckpt_every), log)


def two_datasets_da(cfg: Config, place, log) -> dict:
    """Mode 3's phases on a placement (``OneDevice`` or the mesh's). The
    DA side does not feed the traversal, so the placement may build it in
    a worker thread behind phases 2-3 (pipeline.py:433-452 of the JAX
    package); ``da_wait`` waits for it."""
    cfg = cfg.resolved()
    log("Phase 1/4: loading and indexing eBWT ... ")
    with ThreadPoolExecutor(1) as ex:
        with span("index") as sp:
            fm, da_side = place.load_merged(cfg, ex)
        log(f"done. [{sp.seconds:.2f}s]")
        place.log_loaded(log, fm)

        log(f"\nPhase 2-3/4: suffix-tree wavefront navigation{place.note}.")
        res = place.navigate_one(fm, cfg)
        st = res.stats
        log(f"Computed {st['lcp_values']}/{fm.n} LCP values.")
        log(f"Found {st['n_min']} LCP minima.")
        _log_phases(log, place, st)

        _log_phase4(log, cfg)
        with span("da_wait") as sp:
            fm_da1, da = da_side()
            place.synchronize()
    log(f"[timing] DA-side index wait {sp.seconds:.2f}s")

    with span("cluster") as sp:
        anchor, cl = _anchor_and_clusters(res, cfg.mcov_out)
        del res
        place.synchronize()
    log(f"[timing] cluster detect ({place.where}) {sp.seconds:.2f}s")

    stats = _call_emit(log, st, cl, call_and_emit_pair_mode3, cfg,
                       place.walks(fm), place.walks(fm_da1), da, anchor)
    _log_summary(cl, log)
    # the reference prints its never-incremented `events` counter here,
    # always 0 (ebwt2InDel.cpp:1577)
    log(f"\nStored to file 0 sequences clustered in "
        f"{stats['cluster_nr'] - 1} clusters.")
    return stats


def call_and_emit_pair_mode3(cl: cluster.Clusters, cfg: Config, index,
                             index_da1, da, anchor) -> dict:
    """Mode 3's calling and emission over the walks of the merged index
    and of its DA = 1 side (``call.Walks``), the document array's rank
    structure ``da`` and ``anchor(b, e)`` over the merged index."""
    none = emit_vec.nothing_emitted(emit_vec.PAIR_COUNTS)
    dev = index.device
    with open(cfg.output, "w") as out_f:
        if cl.n_clusters == 0:
            return none
        with span("call_emit.walks"):
            begins, ends = cl.begins, cl.ends
            # each sample's counts with the TERM->A quirk applied per side
            # (find_variants with a DA, ebwt2InDel.cpp:1013-1030); the
            # lengths come from the DA rank
            _, pure_all = index.range_counts(begins, ends)
            _, pure1 = index_da1.range_counts(begins, ends)
            with span("call_emit.da_rank", device=dev):
                len1 = da.rank1(ends) - da.rank1(begins)
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
            ctx, support, full = index.consensus(sb, se, cfg.k_left)
            pos, found = anchor(sb, se)
            seq, seqlen = index.dna(pos, found, cfg.k_right)
            ctx, support, full, found, freq0, freq1, seq, seqlen = _to_host(
                ctx, support, full, found, quirk0[sel_d] >= cfg.mcov_out,
                quirk1[sel_d] >= cfg.mcov_out, seq, seqlen)

        # every walked cluster passed _pair_passes (see mode 2)
        with span("call_emit.write"):
            ctx_ascii = emit_vec.decode_rows(ctx, cfg.term)
            return emit_vec.emit_pair(
                out_f, cfg, found, freq0, full, freq1, full, support,
                support, ctx_ascii, ctx_ascii,
                emit_vec.decode_rows(seq, cfg.term), seqlen)
