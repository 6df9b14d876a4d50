"""The plain reference of ebwt2InDel's output: the ``.snp`` bytes of modes
1, 2 and 3 worked out from the reads themselves, by sorting their suffixes
(``suffixes.py``) instead of walking an FM-index.

With the suffixes in eBWT order and the LCP array between neighbours, each
quantity the reference tool (nicolaprezza/ebwt2InDel) defines by its
suffix-tree navigation is read off directly:

* LCP thresholds: LCP[i] >= K and LCP[i] >= k_right;
* LCP minima: LCP[i - 1] > LCP[i] <= LCP[i + 1] (ebwt2InDel.cpp:357-391:
  a node's border whose left child holds two or more suffixes and which has
  two or more positions of the node after it);
* clusters: the runs of positions above K and not minima, a run that
  reaches the last position never closed, those of 2 * mcov_out or more
  positions analysed (cpp:1609-1655);
* base counts of a cluster: the bases before its suffixes, a terminator
  counted as A (include.hpp:275-289); in modes 2 and 3 per sample;
* consensus left contexts (cpp:243-319): for each base c, the suffixes of
  the cluster preceded by c, then step by step the most frequent base
  before the survivors (ties to the smaller of A < C < G < T), keeping
  those preceded by it, until k_left bases or no survivor; per sample in
  mode 2, over both samples in mode 3;
* the right context (cpp:325-342, 979-985): the k_right bases of the first
  suffix of the cluster at or above k_right, up to its read's end.

Records are written by ``snp.SnpWriter``, one cluster at a time in position
order. Nothing here imports the program or reads what it made.
"""

from __future__ import annotations

import dataclasses
import getopt

import torch

from . import snp, suffixes

BASES = "ACGT"


@dataclasses.dataclass(frozen=True)
class Params:
    """The reference tool's options, resolved as its CLI resolves them
    (ebwt2InDel.cpp:1740-1746: 0 means the default)."""

    K: int = 16
    k_left: int = 31
    k_right: int = 30
    max_gap: int = 10
    max_snvs: int = 2
    mcov_out: int = 3
    complexity: int = 20
    max_variants_per_position: int = 0

    @staticmethod
    def from_argv(argv: list[str]) -> "Params":
        flags = {"-k": "K", "-L": "k_left", "-R": "k_right", "-g": "max_gap",
                 "-v": "max_snvs", "-m": "mcov_out", "-c": "complexity",
                 "-q": "max_variants_per_position"}
        opts, _ = getopt.getopt(argv, "h1:2:v:L:R:m:g:k:t:o:d:c:q:")
        given = {flags[f]: int(v) for f, v in opts if f in flags}
        if any(f == "-t" and v != str(ord("#")) for f, v in opts):
            raise ValueError("the reference reads '#' terminators only")
        d = Params()
        k_right = given.get("k_right") or d.k_right
        return Params(
            K=given.get("K") or d.K,
            k_left=given.get("k_left") or d.k_left,
            k_right=k_right,
            max_gap=given.get("max_gap") or d.max_gap,
            max_snvs=given.get("max_snvs") or d.max_snvs,
            mcov_out=given.get("mcov_out") or d.mcov_out,
            complexity=given.get("complexity") or max(k_right - 10, 0),
            max_variants_per_position=given.get(
                "max_variants_per_position", 0),
        )


def clusters(lcp: torch.Tensor, p: Params, split_at_minima: bool = True):
    """(begin, end) of the analysed clusters, in position order."""
    n = lcp.shape[0]
    mask = lcp >= p.K
    if split_at_minima and n >= 3:
        mid = lcp[1:-1]
        minima = (lcp[:-2] > mid) & (lcp[2:] >= mid)
        mask[1:-1] &= ~minima
    prev = torch.zeros_like(mask)
    prev[1:] = mask[:-1]
    nxt = torch.zeros_like(mask)
    nxt[:-1] = mask[1:]
    end_at = mask & ~nxt
    end_at[-1] = False
    ends = torch.nonzero(end_at).flatten() + 1
    starts = torch.nonzero(mask & ~prev).flatten()[:ends.shape[0]]
    keep = (ends - starts) >= 2 * p.mcov_out
    return starts[keep], ends[keep]


def _counts(sym: torch.Tensor, of: torch.Tensor | None, b, e):
    """(B, 5) counts of symbols 0..4 in [b, e), of the positions ``of``
    marks (all where None)."""
    out = []
    for k in range(5):
        hit = sym == k
        if of is not None:
            hit &= of
        cs = torch.cat([hit.new_zeros(1, dtype=torch.int64),
                        torch.cumsum(hit, 0)])
        out.append(cs[e] - cs[b])
    return torch.stack(out, 1)


def _quirk(counts: torch.Tensor) -> torch.Tensor:
    """A, C, G, T counts with the terminators counted as A."""
    q = counts[:, 1:].clone()
    q[:, 0] += counts[:, 0]
    return q


def _pair_passes(q0, q1, p: Params) -> torch.Tensor:
    """Both samples frequent somewhere, within -q, and not the same single
    base (ebwt2InDel.cpp:870-880, 921)."""
    f0 = q0 >= p.mcov_out
    f1 = q1 >= p.mcov_out
    n0 = f0.sum(1)
    n1 = f1.sum(1)
    ok = (n0 > 0) & (n1 > 0)
    if p.max_variants_per_position > 0:
        q = p.max_variants_per_position
        ok &= (n0 <= q) & (n1 <= q)
    return ok & ~((n0 == 1) & (n1 == 1) & ((f0 & f1).sum(1) == 1))


def _consensus(left: torch.Tensor, group: torch.Tensor, n_groups: int,
               k_left: int):
    """Consensus left contexts of groups of suffixes. ``left`` (M, k_left)
    holds the bases before each suffix, nearest first (4 past its read's
    start); ``group`` (M,) its group, whose first base is left[:, 0].
    Returns (ctx (G, k_left) codes in genomic order, support (G,), full
    (G,))."""
    dev = left.device
    support = torch.bincount(group, minlength=n_groups)
    alive = support > 0
    ctx = torch.zeros((n_groups, k_left), dtype=torch.int64, device=dev)
    ctx[:, 0] = torch.arange(n_groups, device=dev) % 4
    length = torch.ones(n_groups, dtype=torch.int64, device=dev)
    row = torch.ones(left.shape[0], dtype=torch.bool, device=dev)
    for s in range(1, k_left):
        ch = left[:, s]
        on = row & (ch < 4)
        cnt = torch.zeros((n_groups, 4), dtype=torch.int64, device=dev)
        cnt.index_put_((group[on], ch[on]),
                       torch.ones_like(ch[on]), accumulate=True)
        best = torch.argmax(cnt, 1)  # the first maximum: A < C < G < T
        alive &= cnt.gather(1, best[:, None])[:, 0] > 0
        row &= (ch == best[group]) & alive[group]
        ctx[:, s] = torch.where(alive, best, ctx[:, s])
        length += alive.long()
    return ctx.flip(1), support, length == k_left


def _text(codes) -> str:
    return "".join(BASES[c] for c in codes)


def snp_bytes(reads1: torch.Tensor, reads2: torch.Tensor, mode: int,
              p: Params, split_at_minima: bool = True) -> bytes:
    """The ``.snp`` of mode 1 (both read sets as one collection), 2 (the
    sets as two eBWTs) or 3 (their merged eBWT and document array).
    ``split_at_minima=False`` leaves the LCP minima out of the clusters:
    the control, which breaks the tool's clustering."""
    reads = torch.cat([reads1, reads2])
    R1 = reads1.shape[0]
    L = reads.shape[1]
    order = suffixes.sort_suffixes(reads)
    lcp = suffixes.lcp(reads, order)
    b, e = clusters(lcp, p, split_at_minima)
    sym = suffixes.bwt_codes(reads, order)
    second = (order // (L + 1)) >= R1

    if mode == 1:
        quirk = _quirk(_counts(sym, None, b, e))
        freq = quirk >= p.mcov_out
        nfreq = freq.sum(1)
        ok = nfreq >= 2
        if p.max_variants_per_position > 0:
            ok &= nfreq <= p.max_variants_per_position
        freq = [freq]
    else:
        q0 = _quirk(_counts(sym, ~second, b, e))
        q1 = _quirk(_counts(sym, second, b, e))
        ok = _pair_passes(q0, q1, p)
        freq = [q0 >= p.mcov_out, q1 >= p.mcov_out]
    sel = torch.nonzero(ok).flatten()
    b, e = b[sel], e[sel]
    freq = [f[sel] for f in freq]
    S = sel.shape[0]

    # the suffixes of the selected clusters, and the bases before each
    size = e - b
    cl = torch.repeat_interleave(torch.arange(S, device=b.device), size)
    pos = torch.repeat_interleave(b, size) + \
        torch.arange(cl.shape[0], device=b.device) - \
        torch.repeat_interleave(torch.cumsum(size, 0) - size, size)
    sid = order[pos]
    r, o = sid // (L + 1), sid % (L + 1)
    back = o[:, None] - torch.arange(1, p.k_left + 1, device=b.device)
    left = torch.where(back >= 0, reads[r[:, None], back.clamp_min(0)].long(),
                       4)
    per_sample = 2 if mode == 2 else 1
    sample = second[pos].long() if mode == 2 else torch.zeros_like(cl)
    on = left[:, 0] < 4
    group = (cl * per_sample + sample) * 4 + left[:, 0]
    ctx, support, full = _consensus(left[on], group[on], S * per_sample * 4,
                                    p.k_left)
    ctx = ctx.reshape(S, per_sample, 4, p.k_left)
    support = support.reshape(S, per_sample, 4)
    full = full.reshape(S, per_sample, 4)

    # right context: the first suffix of the cluster at or above k_right
    big = torch.full((S,), lcp.shape[0], dtype=torch.int64, device=b.device)
    at = lcp[pos] >= p.k_right
    anchor = big.scatter_reduce(0, cl[at], pos[at], "amin")
    found = anchor < big
    asid = order[anchor.clamp_max(lcp.shape[0] - 1)]
    ar, ao = asid // (L + 1), asid % (L + 1)
    rlen = torch.clamp(L - ao, max=p.k_right)
    fwd = (ao[:, None] + torch.arange(p.k_right, device=b.device)).clamp_max(
        L - 1)
    right = reads[ar[:, None], fwd]

    ctx, support, full, found, rlen, right = (
        t.cpu().tolist() for t in (ctx, support, full, found, rlen, right))
    freq = [f.cpu().tolist() for f in freq]
    return _emit(mode, p, ctx, support, full, freq, found, rlen, right)


def _emit(mode, p: Params, ctx, support, full, freq, found, rlen,
          right) -> bytes:
    import io

    out = io.StringIO()
    w = snp.SnpWriter(out, complexity=p.complexity, max_snvs=p.max_snvs,
                      mcov_out=p.mcov_out, max_gap=p.max_gap)
    for j in range(len(found)):
        if not found[j]:
            continue
        rc = _text(right[j][:rlen[j]])
        if mode == 1:
            w.write_single_cluster([
                snp.VariantSingle(_text(ctx[j][0][c]), rc, support[j][0][c])
                for c in range(4) if freq[0][j][c] and full[j][0][c]])
            continue
        s1 = 1 if mode == 2 else 0  # mode 3: both samples share one
        w.write_pair_cluster([
            snp.VariantPair(_text(ctx[j][0][c0]), _text(ctx[j][s1][c1]), rc,
                            support[j][0][c0], support[j][s1][c1])
            for c0 in range(4) for c1 in range(4)
            if c0 != c1 and freq[0][j][c0] and full[j][0][c0]
            and freq[1][j][c1] and full[j][s1][c1]])
    return out.getvalue().encode("ascii")
