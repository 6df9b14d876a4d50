"""The emission: the filters, the alignments and the ``.snp`` records of
the clusters that the calling walks reached.

Mode 1 (genotyping; to_file single, ebwt2InDel.cpp:1254-1330, and
distance/dH, 157-240) enters at ``emit_single``, which dispatches on the
device of the walks' tensors: a CUDA tensor runs the hand-written kernel
(``ops/emit_cuda.py``, ``csrc/emit_single.cu``), which aligns, filters and
writes every record on the card, and a CPU tensor runs
``emit_single_plain``, the numpy version (all candidate-pair alignments as
batched array comparisons, Python only for the record strings). There is no
fallback between them. Modes 2 and 3 (to_file pair) run ``emit_pair`` on
the host. Every path's bytes equal emit.SnpWriter's driven in cluster order
(enforced by the golden parity tests).
"""

from __future__ import annotations

import numpy as np

from ..utils import dna
from ..utils.profile import span
from . import emit

# emit_single's counts: clusters of two or more variants; those dropped
# because two consecutive left contexts differ at more than max_snvs (-v);
# those of the rest with fewer than two variants of support >= mcov_out
# (-m); those of the rest whose right context fails the complexity filter
# (-c); the records written; the records whose event-type alignment has
# both mismatches before the indel and an indel (D > 0, G != 0); and the
# clusters -v keeps although two consecutive left contexts differ at two
# or more SNVs (2 <= D <= max_snvs): a second variant inside the context
SINGLE_COUNTS = ("clusters", "dropped_max_snvs", "dropped_coverage",
                 "dropped_complexity", "records", "gapped", "multi_snv")
# emit_pair's: the candidate pairs that reach the distance test, those it
# rejects (D > max_snvs), the pairs written (two records each), and those
# of them whose alignment has D > 0 and G != 0
PAIR_COUNTS = ("pairs", "dropped_max_snvs", "events", "gapped")


def nothing_emitted(names: tuple[str, ...]) -> dict:
    """An emitter's result where no cluster reaches it: no record, the
    first cluster number, every count of ``names`` zero."""
    return {"events": 0, "cluster_nr": 1,
            "emit_counts": dict.fromkeys(names, 0)}


def batch_distance(a: np.ndarray, b: np.ndarray, max_gap: int):
    """Vectorized emit.distance over pairs of equal-length byte rows.

    a, b: (P, L) uint8. Returns (D (P,), G (P,)) — mismatches before the
    indel and signed indel length (positive: insertion in a).
    Tie-breaking matches the reference: first minimum gap wins; the no-indel
    alignment wins only if strictly smaller than both indel minima; on an
    a/b tie the insertion goes to b (ebwt2InDel.cpp:220-239).
    """
    P, L = a.shape
    no_indel = (a != b).sum(axis=1).astype(np.int64)
    if max_gap == 0 or P == 0:
        return no_indel, np.zeros(P, dtype=np.int64)
    gmax = min(max_gap, L)
    ab = np.empty((P, max_gap), dtype=np.int64)
    ba = np.empty((P, max_gap), dtype=np.int64)
    for g in range(1, max_gap + 1):
        if g <= gmax:
            ab[:, g - 1] = (a[:, : L - g] != b[:, g:]).sum(axis=1) + g
            ba[:, g - 1] = (a[:, g:] != b[:, : L - g]).sum(axis=1) + g
        else:  # dH of truncated-to-empty strings is 0 (reference never hits
            ab[:, g - 1] = g  # this: max_gap <= L always in practice)
            ba[:, g - 1] = g
    min_ab_idx = np.argmin(ab, axis=1)
    min_ba_idx = np.argmin(ba, axis=1)
    min_ab = ab[np.arange(P), min_ab_idx]
    min_ba = ba[np.arange(P), min_ba_idx]

    use_none = (no_indel < min_ab) & (no_indel < min_ba)
    use_a = ~use_none & (min_ab < min_ba)
    D = np.where(use_none, no_indel,
                 np.where(use_a, min_ab - (min_ab_idx + 1),
                          min_ba - (min_ba_idx + 1)))
    G = np.where(use_none, 0,
                 np.where(use_a, min_ab_idx + 1, -(min_ba_idx + 1)))
    return D.astype(np.int64), G.astype(np.int64)


def _has_run_vec(seq_ascii: np.ndarray, seqlen: np.ndarray, k: int):
    """Vectorized emit.has_run over right contexts (B, Lr)."""
    B, Lr = seq_ascii.shape
    if k > Lr:
        return np.zeros(B, dtype=bool)
    out = np.ones(B, dtype=bool)
    out &= seqlen >= k  # k > length -> not a run
    if k >= 2:
        head = seq_ascii[:, :k]
        out &= (head[:, 1:] == head[:, :-1]).all(axis=1)
    return out


def decode_rows(codes: np.ndarray, term: int) -> np.ndarray:
    """(..., L) int8 codes -> ASCII bytes for lazy per-row slicing."""
    return dna.decode_table(term)[codes.astype(np.uint8)]


def emit_single(out_f, cfg, found, freq, full, support, ctx, seq,
                seqlen) -> dict:
    """Mode 1's emission over the walks' tensors, all on one device, for
    the B clusters that passed the base-count filter: ``found`` (B,),
    ``freq`` and ``full`` (B, 4) flags, ``support`` (B, 4), the left
    contexts ``ctx`` (B, 4, L) and right contexts ``seq`` (B, R) as codes,
    ``seqlen`` (B,). Writes the records to ``out_f`` and returns {'events',
    'cluster_nr', 'emit_counts'}, the last the counts of ``SINGLE_COUNTS``.

    On a CUDA device the span ``call_emit.align`` times the kernels through
    the copy of their counts, and ``call_emit.format`` the copy of the
    records' text, its decode and the write. On the CPU the tensors go to
    ``emit_single_plain``, whose spans time its two halves."""
    if found.device.type == "cuda":
        from ..ops import emit_cuda

        with span("call_emit.align"):
            text, counts = emit_cuda.emit_single(cfg, found, freq, full,
                                                 support, ctx, seq, seqlen)
        with span("call_emit.format"):
            out_f.write(text.cpu().numpy().tobytes().decode("ascii"))
        counts = dict(zip(SINGLE_COUNTS, counts))
        return {"events": counts["records"],
                "cluster_nr": 1 + counts["clusters"], "emit_counts": counts}
    if found.device.type == "cpu":
        found, freq, full, support, ctx, seq, seqlen = (
            t.numpy() for t in (found, freq, full, support, ctx, seq,
                                seqlen))
        return emit_single_plain(
            out_f, cfg, found, np.ones(len(found), dtype=bool), freq, full,
            support, decode_rows(ctx, cfg.term), decode_rows(seq, cfg.term),
            seqlen)
    raise ValueError(f"emit_single: tensors on {found.device}")


def emit_single_plain(out_f, cfg, found, passes, freq, full, support,
                      ctx_ascii, seq_ascii, seqlen) -> dict:
    """The plain version: the vectorized equivalent of looping
    write_single_cluster over clusters in position order, over numpy arrays
    (the contexts in ASCII). Returns as ``emit_single``. The span
    ``call_emit.align`` times the vectorized half: the contexts ordered per
    cluster, every ``batch_distance`` pass and the filters;
    ``call_emit.format`` the per-record loop, the join and the write.
    """
    B = len(found)
    mcov, max_snvs, max_gap, complexity = (
        cfg.mcov_out, cfg.max_snvs, cfg.max_gap, cfg.complexity,
    )
    with span("call_emit.align"):
        var_mask = passes[:, None] & found[:, None] & freq & full  # (B,4)
        nvar = var_mask.sum(axis=1)
        counted = nvar >= 2  # these advance cluster_nr (cpp:1256,1328)

        # order variants per cluster: valid chars first, ascending (ACGT)
        order = np.argsort(~var_mask, axis=1, kind="stable")  # (B,4)
        ctxs = np.take_along_axis(ctx_ascii, order[:, :, None], axis=1)

        # good variants: support >= mcov, order preserved (cpp:1268-1272)
        good_mask = var_mask & (support >= mcov)
        good_order = np.argsort(~good_mask, axis=1, kind="stable")
        n_good = good_mask.sum(axis=1)
        gctxs = np.take_along_axis(ctx_ascii, good_order[:, :, None], axis=1)
        gsups = np.take_along_axis(support, good_order, axis=1)
        run_fail = _has_run_vec(seq_ascii, seqlen, complexity)

        # max over consecutive-pair distances (cpp:1262-1270)
        pair_valid = (np.arange(3)[None, :] < (nvar - 1)[:, None]) \
            & counted[:, None]
        a = ctxs[:, 0:3].reshape(-1, ctxs.shape[2])
        b = ctxs[:, 1:4].reshape(-1, ctxs.shape[2])
        D, _ = batch_distance(a, b, max_gap)
        max_dist = np.where(pair_valid, D.reshape(B, 3), 0).max(axis=1)
        emitting = counted & (max_dist <= max_snvs) & (n_good >= 2)

        # event-type distances: record i pairs (good[max(i-1,0)], good[1])
        # (the good_variants[1] quirk, cpp:1299-1307)
        emit_set = emitting & ~run_fail
        e_idx = np.flatnonzero(emit_set)
        td = np.zeros((B, 3, 2), dtype=np.int64)
        if len(e_idx):
            for j in range(3):
                Dj, Gj = batch_distance(gctxs[e_idx, j], gctxs[e_idx, 1],
                                        max_gap)
                td[e_idx, j, 0] = Dj
                td[e_idx, j, 1] = Gj

    with span("call_emit.format"):
        events = 0
        gapped = 0
        cluster_nr = 1
        chunks: list[str] = []
        for j in np.flatnonzero(counted):
            if emit_set[j]:
                right = seq_ascii[j, : seqlen[j]].tobytes().decode("ascii")
                id_nr = 1
                for i in range(int(n_good[j])):
                    d = (int(td[j, max(i - 1, 0), 0]),
                         int(td[j, max(i - 1, 0), 1]))
                    left_a = gctxs[j, max(i - 1, 0)].tobytes().decode("ascii")
                    left_b = gctxs[j, 1].tobytes().decode("ascii")
                    typ = emit.event_type(left_a, left_b, max_gap, d)
                    left = gctxs[j, i].tobytes().decode("ascii")
                    chunks.append(
                        f">cluster:{cluster_nr}_id:{id_nr}"
                        f"_right:{len(right)}"
                        f"_cov:{int(gsups[j, i])}_{typ}\n{left}{right}\n"
                    )
                    id_nr += 1
                    events += 1
                    gapped += d[0] > 0 and d[1] != 0
            # a cluster whose every record failed has_run writes nothing
            # and is counted all the same
            cluster_nr += 1
        out_f.write("".join(chunks))

    kept_v = counted & (max_dist <= max_snvs)
    counts = {
        "clusters": int(counted.sum()),
        "dropped_max_snvs": int((counted & ~kept_v).sum()),
        "dropped_coverage": int((kept_v & (n_good < 2)).sum()),
        "dropped_complexity": int((emitting & run_fail).sum()),
        "records": events,
        "gapped": gapped,
        "multi_snv": int((kept_v & (max_dist >= 2)).sum()),
    }
    return {"events": events, "cluster_nr": cluster_nr,
            "emit_counts": counts}


def emit_pair(out_f, cfg, found, freq0, full0, freq1, full1,
              support0, support1, ctx0_ascii, ctx1_ascii,
              seq_ascii, seqlen) -> dict:
    """Vectorized two-sample emission (to_file pair, ebwt2InDel.cpp:1146-1252)
    over compacted clusters: the cross-product of frequent chars with
    differing final characters, accepted iff the right context passes the
    complexity filter, the alignment has <= max_snvs mismatches, and both
    supports reach mcov_out. cluster_nr advances only for clusters with at
    least one accepted pair. Returns {'events', 'cluster_nr',
    'emit_counts'}, the last the counts of ``PAIR_COUNTS``; its spans as
    ``emit_single_plain``'s."""
    S = len(found)
    mcov, max_snvs, max_gap, complexity = (
        cfg.mcov_out, cfg.max_snvs, cfg.max_gap, cfg.complexity,
    )

    with span("call_emit.align"):
        combos = [(c0, c1) for c0 in range(4) for c1 in range(4)
                  if c0 != c1]
        cand0 = freq0 & full0  # (S,4)
        cand1 = freq1 & full1
        pair_ok = np.zeros((S, len(combos)), dtype=bool)
        for k, (c0, c1) in enumerate(combos):
            pair_ok[:, k] = cand0[:, c0] & cand1[:, c1]
        pair_ok &= found[:, None]

        run_fail = _has_run_vec(seq_ascii, seqlen, complexity)
        sup_ok = np.zeros_like(pair_ok)
        for k, (c0, c1) in enumerate(combos):
            sup_ok[:, k] = (support0[:, c0] >= mcov) \
                & (support1[:, c1] >= mcov)
        pre = pair_ok & sup_ok & ~run_fail[:, None]

        # a cluster with no pair left writes nothing and does not advance
        # cluster_nr; neither does one whose pairs all fail the distance test
        cl_idx, combo_idx = np.nonzero(pre)
        c0s = np.array([c0 for c0, _ in combos])[combo_idx]
        c1s = np.array([c1 for _, c1 in combos])[combo_idx]
        a = ctx0_ascii[cl_idx, c0s]
        b = ctx1_ascii[cl_idx, c1s]
        D, G = batch_distance(a, b, max_gap)
        accept = D <= max_snvs

    with span("call_emit.format"):
        events = 0
        cluster_nr = 1
        chunks: list[str] = []
        # iterate only clusters that have candidate pairs, in position order
        uniq, starts_u = np.unique(cl_idx, return_index=True)
        bounds = np.append(starts_u, len(cl_idx))
        for u in range(len(uniq)):
            p, q = bounds[u], bounds[u + 1]
            wrote = False
            id_nr = 1
            for t in range(p, q):
                if not accept[t]:
                    continue
                wrote = True
                d = (int(D[t]), int(G[t]))
                left0 = a[t].tobytes().decode("ascii")
                left1 = b[t].tobytes().decode("ascii")
                right = seq_ascii[cl_idx[t], : seqlen[cl_idx[t]]].tobytes() \
                    .decode("ascii")
                typ = emit.event_type(left0, left1, max_gap, d)
                dna0 = left0 if d[1] >= 0 else left0[-d[1]:]
                dna1 = left1 if d[1] <= 0 else left1[d[1]:]
                rlen = len(right)
                chunks.append(
                    f">cluster:{cluster_nr}_id:{id_nr}_right:{rlen}"
                    f"_cov:{int(support0[cl_idx[t], c0s[t]])}_{typ}\n"
                    f"{dna0}{right}\n"
                    f">cluster:{cluster_nr}_id:{id_nr}_right:{rlen}"
                    f"_cov:{int(support1[cl_idx[t], c1s[t]])}_{typ}\n"
                    f"{dna1}{right}\n"
                )
                id_nr += 1
                events += 1
            if wrote:
                cluster_nr += 1
        out_f.write("".join(chunks))
    counts = {"pairs": len(cl_idx), "dropped_max_snvs": int((~accept).sum()),
              "events": events,
              "gapped": int((accept & (D > 0) & (G != 0)).sum())}
    return {"events": events, "cluster_nr": cluster_nr,
            "emit_counts": counts}
