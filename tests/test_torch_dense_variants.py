"""Variants as dense and as close together as two divergent strains have
them: SNPs at 0.01 and indels at 0.002, planted 6 bp apart at least, so
that a 31-base left context or a 30-base right context often holds a
second variant. Every other input of the tests plants them 60 bp apart.

In modes 1, 2 and 3 the port's ``.snp`` (``cli.main`` on the CPU) must be
the plain reference's (``portbench/reference/calls.py``) byte for byte,
and in mode 1 on the first seed the JAX package's too. Each run must have
dropped a cluster or pair for its left contexts' distance (``-v``) and
written a record whose alignment holds both mismatches and an indel, by
the emission's counts (``[emit] counts``). Then ``emit_vec``'s counts on inputs built by
hand, and ``emit_single_plain`` and ``emit_pair`` against the port's
record-by-record ``SnpWriter`` on random inputs (the kernel's test,
``test_torch_emit_cuda.py``, runs the same random inputs on the card)."""

import io
import json

import numpy as np
import pytest

from ebwt2indel_tpu.models import pipeline as jpipeline
from ebwt2indel_tpu.utils.config import Config as JConfig
from ebwt2indel_torch import cli
from ebwt2indel_torch.models import emit, emit_vec
from ebwt2indel_torch.utils.config import Config
from portbench import gen
from portbench.reference import calls
from tests.test_torch_emit_cuda import BASES, near, single_trial
from tests.test_torch_hosttools import two_torch_threads  # noqa: F401

# portbench/configs/ecoli25x-hivar-single.json at 20 kbp
RECIPE = {"genome_length": 20000, "coverage": 25, "read_length": 100,
          "error_rate": 0.001, "snp_rate": 0.01, "indel_rate": 0.002,
          "max_indel": 5, "min_variant_spacing": 6}
SEEDS = (3, 2**31 + 11)
ARGV = {1: ["-1", "{reads}"], 2: ["-1", "{a}", "-2", "{b}"],
        3: ["-1", "{merged}", "-d", "{da}"]}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Per seed: the two read sets and every input file of the three
    modes."""
    made = {}
    for seed in SEEDS:
        d = tmp_path_factory.mktemp(f"dense_{seed}")
        r1, r2 = gen.make_reads(RECIPE, seed, "cpu")
        paths = gen.write_inputs({"reads", "a", "b", "merged", "da"}, r1, r2,
                                 str(d))
        made[seed] = (r1, r2, paths, d)
    return made


def _counts(out: str) -> dict:
    line = [ln for ln in out.splitlines() if ln.startswith("[emit] counts ")]
    assert len(line) == 1
    return json.loads(line[0][len("[emit] counts "):])


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("mode", [1, 2, 3])
def test_close_variants_match_reference(inputs, capsys, mode, seed):
    r1, r2, paths, d = inputs[seed]
    out = str(d / f"m{mode}.snp")
    argv = [a.format(**paths) for a in ARGV[mode]] + ["-o", out]
    assert cli.main(argv, device="cpu") == 0
    counts = _counts(capsys.readouterr().out)
    got = open(out, "rb").read()
    assert got == calls.snp_bytes(r1, r2, mode, calls.Params.from_argv(argv))
    if mode == 1 and seed == SEEDS[0]:  # its compiles take 15-25 s
        jout = str(d / "m1_jax.snp")
        jpipeline.run_one_dataset(JConfig(input1=paths["reads"], output=jout),
                                  log=lambda *a, **k: None)
        assert got == open(jout, "rb").read()
    if mode == 1:
        assert tuple(counts) == emit_vec.SINGLE_COUNTS
        assert counts["records"] == got.count(b">")
    else:
        assert tuple(counts) == emit_vec.PAIR_COUNTS
        assert 2 * counts["events"] == got.count(b">")
    # the dense-context rules ran: the -v filter and a gapped alignment,
    # and in mode 1 clusters whose contexts hold a second SNP
    assert counts["dropped_max_snvs"] > 0 and counts["gapped"] > 0
    assert mode != 1 or counts["multi_snv"] > 0


def _cfg(**kw):
    return Config(**{"k_left": 12, "k_right": 8, "K": 4, **kw}).resolved()


def _codes(s: str) -> np.ndarray:
    return np.frombuffer(s.encode(), np.uint8)


def test_emit_single_counts_by_hand():
    """Six clusters of two variants each: contexts three apart (dropped
    by -v), one variant under -m (too few good variants), a right context
    that starts with a run (complexity), a SNP, an indel beside a SNP (two
    gapped records), and two SNPs in one context (kept by -v)."""
    cfg = _cfg(max_snvs=2, mcov_out=3, max_gap=2, complexity=3)
    a = "ACGTTGCAAGTA"
    far = "ACCTTGCATGTC"  # three mismatches, and worse shifted
    snp = a[:-1] + "C"
    two = "ACGATGCAAGTC"  # a second SNP ten bases before the last
    gap = "TT" + a[:5] + "C" + a[6:-2]  # a's last two bases inserted, a SNP
    assert emit.distance(a, far, 2)[0] == 3
    assert emit.distance(a, snp, 2) == (1, 0)
    assert emit.distance(a, gap, 2) == (1, 2)
    assert emit.distance(a, two, 2) == (2, 0)
    pairs = [(a, far), (a, snp), (a, snp), (a, snp), (a, gap), (a, two)]
    B = len(pairs)
    ctx = np.full((B, 4, 12), ord("A"), np.uint8)
    for j, (x, y) in enumerate(pairs):
        ctx[j, 0], ctx[j, 2] = _codes(x), _codes(y)
    freq = np.zeros((B, 4), bool)
    freq[:, [0, 2]] = True
    support = np.where(freq, 5, 0)
    support[1, 2] = 2  # under -m
    seq = np.stack([_codes(s) for s in ["ACGTACGT"] * 2 + ["GGGGACGT"]
                    + ["ACGTACGT"] * 3])
    args = (np.ones(B, bool), np.ones(B, bool), freq, np.ones((B, 4), bool),
            support, ctx, seq, np.full(B, 8))
    buf = io.StringIO()
    got = emit_vec.emit_single_plain(buf, cfg, *args)
    assert got["emit_counts"] == {
        "clusters": 6, "dropped_max_snvs": 1, "dropped_coverage": 1,
        "dropped_complexity": 1, "records": 6, "gapped": 2, "multi_snv": 1}
    text = buf.getvalue()
    assert got["events"] == text.count(">") == 6
    assert got["cluster_nr"] == 7
    assert text.count("_INDEL_event:") == 2  # the gapped cluster's records
    want = io.StringIO()
    writer = emit.SnpWriter(want, complexity=3, max_snvs=2, mcov_out=3,
                            max_gap=2)
    for j in range(B):
        writer.write_single_cluster([
            emit.VariantSingle(ctx[j, c].tobytes().decode(), "GGGGACGT"
                               if j == 2 else "ACGTACGT", int(support[j, c]))
            for c in (0, 2)])
    assert text == want.getvalue()


def _expected_single(cfg, variants):
    """emit_single's counts by the record-by-record rules
    (ebwt2InDel.cpp:1254-1330)."""
    c = dict.fromkeys(emit_vec.SINGLE_COUNTS, 0)
    for vs in variants:
        if len(vs) < 2:
            continue
        c["clusters"] += 1
        dist = [emit.distance(x.left_context, y.left_context, cfg.max_gap)
                for x, y in zip(vs, vs[1:])]
        good = [v for v in vs if v.support >= cfg.mcov_out]
        max_dist = max(d[0] for d in dist)
        if max_dist > cfg.max_snvs:
            c["dropped_max_snvs"] += 1
            continue
        c["multi_snv"] += max_dist >= 2
        if len(good) < 2:
            c["dropped_coverage"] += 1
        elif emit.has_run(vs[0].right_context, cfg.complexity):
            c["dropped_complexity"] += 1
        else:
            for i in range(len(good)):
                d = emit.distance(good[max(i - 1, 0)].left_context,
                                  good[1].left_context, cfg.max_gap)
                c["records"] += 1
                c["gapped"] += d[0] > 0 and d[1] != 0
    return c


@pytest.mark.parametrize("trial", range(6))
def test_emit_single_matches_writer(trial):
    (cfg, found, passes, freq, full, support, ctx, seq,
     seqlen) = single_trial(trial)
    B = len(found)
    buf = io.StringIO()
    got = emit_vec.emit_single_plain(buf, cfg, found, passes, freq, full,
                                     support, ctx, seq, seqlen)
    want = io.StringIO()
    writer = emit.SnpWriter(want, complexity=cfg.complexity,
                            max_snvs=cfg.max_snvs, mcov_out=cfg.mcov_out,
                            max_gap=cfg.max_gap)
    variants = []
    for j in range(B):
        right = seq[j, :seqlen[j]].tobytes().decode()
        variants.append([
            emit.VariantSingle(ctx[j, c].tobytes().decode(), right,
                               int(support[j, c]))
            for c in range(4)
            if found[j] and passes[j] and freq[j, c] and full[j, c]])
        writer.write_single_cluster(variants[-1])
    assert buf.getvalue() == want.getvalue()
    assert (got["events"], got["cluster_nr"]) == (writer.events,
                                                  writer.cluster_nr)
    assert got["emit_counts"] == _expected_single(cfg, variants)


@pytest.mark.parametrize("trial", range(6))
def test_emit_pair_matches_writer(trial):
    rng = np.random.default_rng(0xFA1 + trial)
    S, L, Lr = int(rng.integers(1, 60)), 12, 8
    cfg = _cfg(mcov_out=int(rng.integers(1, 5)),
               max_snvs=int(rng.integers(1, 4)),
               max_gap=int(rng.integers(1, 4)),
               complexity=int(rng.integers(1, 5)))
    found = rng.random(S) < 0.9
    freq0, freq1 = rng.random((2, S, 4)) < 0.5
    full0, full1 = rng.random((2, S, 4)) < 0.9
    support0, support1 = rng.integers(0, 8, (2, S, 4))
    ctx0 = np.stack([np.tile(rng.choice(BASES, L), (4, 1))
                     for _ in range(S)])
    ctx1 = np.stack([near(rng, c, range(4)) for c in ctx0])
    seq = rng.choice(BASES[:2], (S, Lr))
    seqlen = rng.integers(0, Lr + 1, S)
    buf = io.StringIO()
    got = emit_vec.emit_pair(buf, cfg, found, freq0, full0, freq1, full1,
                             support0, support1, ctx0, ctx1, seq, seqlen)
    want = io.StringIO()
    writer = emit.SnpWriter(want, complexity=cfg.complexity,
                            max_snvs=cfg.max_snvs, mcov_out=cfg.mcov_out,
                            max_gap=cfg.max_gap)
    counts = dict.fromkeys(emit_vec.PAIR_COUNTS, 0)
    for j in range(S):
        right = seq[j, :seqlen[j]].tobytes().decode()
        vs = [emit.VariantPair(ctx0[j, c0].tobytes().decode(),
                               ctx1[j, c1].tobytes().decode(), right,
                               int(support0[j, c0]), int(support1[j, c1]))
              for c0 in range(4) for c1 in range(4)
              if found[j] and c0 != c1 and freq0[j, c0] and full0[j, c0]
              and freq1[j, c1] and full1[j, c1]]
        writer.write_pair_cluster(vs)
        for v in vs:
            if emit.has_run(right, cfg.complexity) or \
                    min(v.support_0, v.support_1) < cfg.mcov_out:
                continue
            d = emit.distance(v.left_context_0, v.left_context_1,
                              cfg.max_gap)
            counts["pairs"] += 1
            if d[0] > cfg.max_snvs:
                counts["dropped_max_snvs"] += 1
            else:
                counts["events"] += 1
                counts["gapped"] += d[0] > 0 and d[1] != 0
    assert buf.getvalue() == want.getvalue()
    assert got["cluster_nr"] == writer.cluster_nr
    assert got["emit_counts"] == counts
    assert 2 * got["events"] == buf.getvalue().count(">")


def test_emit_on_no_cluster_writes_nothing():
    cfg = _cfg()
    none4 = np.zeros((0, 4), bool)
    buf = io.StringIO()
    got = emit_vec.emit_single_plain(
        buf, cfg, np.zeros(0, bool), np.zeros(0, bool), none4, none4,
        np.zeros((0, 4), np.int64), np.zeros((0, 4, 12), np.uint8),
        np.zeros((0, 8), np.uint8), np.zeros(0, np.int64))
    assert got == {"events": 0, "cluster_nr": 1, "emit_counts":
                   dict.fromkeys(emit_vec.SINGLE_COUNTS, 0)}
    got = emit_vec.emit_pair(buf, cfg, np.zeros(0, bool), none4, none4,
                             none4, none4, np.zeros((0, 4), np.int64),
                             np.zeros((0, 4), np.int64),
                             np.zeros((0, 4, 12), np.uint8),
                             np.zeros((0, 4, 12), np.uint8),
                             np.zeros((0, 8), np.uint8),
                             np.zeros(0, np.int64))
    assert got == {"events": 0, "cluster_nr": 1, "emit_counts":
                   dict.fromkeys(emit_vec.PAIR_COUNTS, 0)}
    assert buf.getvalue() == ""
