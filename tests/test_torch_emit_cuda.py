"""Mode 1's emission on the card (``ops/emit_cuda.py``,
``csrc/emit_single.cu``) against its plain version
(``emit_vec.emit_single_plain``) and the record-by-record
``emit.SnpWriter``: the same text, events, cluster numbers and counts.

The ``cuda`` tests need a card (a CUDA kernel has no CPU mode) and skip
without one. On the card:

    python -m pytest tests/test_torch_emit_cuda.py -m cuda

The CPU tests check the dispatch: the entry, ``emit_vec.emit_single``,
sends CPU tensors to the plain version, and the kernel's wrapper refuses
them. The file imports nothing from ``tests`` and nothing of JAX, so it
also collects on the card's machine."""

import io

import numpy as np
import pytest
import torch

from ebwt2indel_torch.models import emit, emit_vec
from ebwt2indel_torch.ops import emit_cuda
from ebwt2indel_torch.utils import dna
from ebwt2indel_torch.utils.config import Config

BASES = np.frombuffer(b"ACGT", np.uint8)
CODES = dna.code_table()


def cfg_of(**kw) -> Config:
    return Config(**{"k_left": 12, "k_right": 8, "K": 4, **kw}).resolved()


def near(rng, ctx, rows):
    """Contexts near ``ctx``: a few substitutions, sometimes shifted by an
    indel at the right end."""
    out = ctx.copy()
    for r in rows:
        x = out[r]
        if rng.random() < 0.3:
            g = int(rng.integers(1, 3))
            x[:] = np.concatenate([rng.choice(BASES, g), x[:-g]])
        for _ in range(int(rng.integers(0, 4))):
            x[rng.integers(0, len(x))] = rng.choice(BASES)
    return out


def single_trial(trial: int):
    """A randomized emission input: (cfg, found, passes, freq, full,
    support, ctx, seq, seqlen), contexts in ASCII."""
    rng = np.random.default_rng(0xC0DE + trial)
    B, L, Lr = int(rng.integers(1, 80)), 12, 8
    cfg = cfg_of(mcov_out=int(rng.integers(1, 5)),
                 max_snvs=int(rng.integers(1, 4)),
                 max_gap=int(rng.integers(1, 4)),
                 complexity=int(rng.integers(1, 5)))
    found = rng.random(B) < 0.9
    passes = rng.random(B) < 0.9
    freq = rng.random((B, 4)) < 0.6
    full = rng.random((B, 4)) < 0.9
    support = rng.integers(0, 8, (B, 4))
    ctx = np.stack([near(rng, np.tile(rng.choice(BASES, L), (4, 1)),
                         range(4)) for _ in range(B)])
    seq = rng.choice(BASES[:2], (B, Lr))
    seqlen = rng.integers(0, Lr + 1, B)
    return cfg, found, passes, freq, full, support, ctx, seq, seqlen


def _codes(trial):
    """``single_trial``'s input as the walks give it: passes folded into
    found (every cluster the emission sees passed), contexts as codes."""
    cfg, found, passes, freq, full, support, ctx, seq, seqlen = trial
    return cfg, (found & passes, freq, full, support,
                 CODES[ctx].astype(np.int8), CODES[seq].astype(np.int8),
                 seqlen)


def run_entry(cfg, arrays, device):
    """``emit_vec.emit_single`` on tensors on ``device``: (text, result)."""
    buf = io.StringIO()
    ts = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
          for a in arrays]
    got = emit_vec.emit_single(buf, cfg, *ts)
    return buf.getvalue(), got


def run_plain(cfg, arrays):
    found, freq, full, support, ctx, seq, seqlen = arrays
    buf = io.StringIO()
    got = emit_vec.emit_single_plain(
        buf, cfg, found, np.ones(len(found), bool), freq, full, support,
        emit_vec.decode_rows(ctx, cfg.term),
        emit_vec.decode_rows(seq, cfg.term), seqlen)
    return buf.getvalue(), got


def run_writer(cfg, arrays):
    """The record-by-record writer in cluster order: (text, events,
    cluster_nr)."""
    found, freq, full, support, ctx, seq, seqlen = arrays
    ctx = emit_vec.decode_rows(ctx, cfg.term)
    seq = emit_vec.decode_rows(seq, cfg.term)
    out = io.StringIO()
    w = emit.SnpWriter(out, complexity=cfg.complexity, max_snvs=cfg.max_snvs,
                       mcov_out=cfg.mcov_out, max_gap=cfg.max_gap)
    for j in range(len(found)):
        right = seq[j, :seqlen[j]].tobytes().decode()
        w.write_single_cluster([
            emit.VariantSingle(ctx[j, c].tobytes().decode(), right,
                               int(support[j, c]))
            for c in range(4) if found[j] and freq[j, c] and full[j, c]])
    return out.getvalue(), w.events, w.cluster_nr


def clusters(seed, B, L, R, *, p_full=0.9, runs=False, **kw):
    """B random clusters of contexts of L bases and right contexts of R as
    codes, and a config drawn from ``seed`` with ``kw`` on top."""
    rng = np.random.default_rng(seed)
    cfg = cfg_of(k_left=L, k_right=R, **{
        "mcov_out": int(rng.integers(1, 5)),
        "max_snvs": int(rng.integers(1, 4)),
        "max_gap": int(rng.integers(1, 4)),
        "complexity": int(rng.integers(1, 5)), **kw})
    if kw.get("max_gap") == 0:  # resolution reads 0 as the default
        cfg.max_gap = 0
    ctx = np.stack([near(rng, np.tile(rng.choice(BASES, L), (4, 1)),
                         range(4)) for _ in range(B)]) if B else \
        np.zeros((0, 4, L), np.uint8)
    seq = rng.choice(BASES[:2], (B, R))
    if runs:
        seq[:] = BASES[0]
    return cfg, (rng.random(B) < 0.9, rng.random((B, 4)) < 0.6,
                 rng.random((B, 4)) < p_full, rng.integers(0, 8, (B, 4)),
                 CODES[ctx].astype(np.int8), CODES[seq].astype(np.int8),
                 rng.integers(0, R + 1, B))


def _run_failing_then_written():
    """Two counted clusters: the first's every record fails has_run, the
    second is written, as cluster 2."""
    cfg = cfg_of(max_snvs=2, mcov_out=1, max_gap=2, complexity=3)
    a = CODES[np.frombuffer(b"ACGTTGCAAGTA", np.uint8)].astype(np.int8)
    ctx = np.zeros((2, 4, 12), np.int8)
    ctx[:, 0], ctx[:, 2] = a, a
    ctx[:, 2, -1] = 1  # a SNP at the last base
    freq = np.zeros((2, 4), bool)
    freq[:, [0, 2]] = True
    seq = CODES[np.frombuffer(b"GGGGACGTACGTACGT", np.uint8)] \
        .astype(np.int8).reshape(2, 8)
    return cfg, (np.ones(2, bool), freq, np.ones((2, 4), bool),
                 np.full((2, 4), 5), ctx, seq, np.full(2, 8))


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the emission kernel runs only on "
                    "the card")


def _check_on_card(cfg, arrays):
    before = emit_cuda.LAUNCHES["emit_single"]
    text, got = run_entry(cfg, arrays, "cuda")
    torch.cuda.synchronize()
    want, plain = run_plain(cfg, arrays)
    assert text == want
    assert got == plain
    assert emit_cuda.LAUNCHES["emit_single"] == before + (len(arrays[0]) > 0)
    wtext, events, cluster_nr = run_writer(cfg, arrays)
    assert text == wtext
    assert (got["events"], got["cluster_nr"]) == (events, cluster_nr)
    return text, got


@pytest.mark.cuda
@pytest.mark.parametrize("trial", range(6))
def test_kernel_matches_plain_and_writer(trial):
    """The six randomized trials of
    ``test_torch_dense_variants.py::test_emit_single_matches_writer``."""
    _needs_cuda()
    _check_on_card(*_codes(single_trial(trial)))


EDGES = {
    "k_left_12": dict(L=12, R=8),
    "k_left_31": dict(L=31, R=30),
    "k_left_32": dict(L=32, R=30),
    "k_left_40": dict(L=40, R=30),  # past the 32-base packed word
    "max_gap_0": dict(L=12, R=8, max_gap=0),
    "max_gap_L": dict(L=12, R=8, max_gap=12),
    "max_gap_above_L": dict(L=12, R=8, max_gap=20),
    "complexity_above_k_right": dict(L=12, R=8, complexity=9),
    "every_right_context_a_run": dict(L=12, R=8, complexity=2, runs=True),
    "contexts_not_full": dict(L=31, R=30, p_full=0.3),
    "nothing_counted": dict(L=12, R=8, p_full=0.0),
    "no_passing_cluster": dict(L=12, R=8, B=0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("edge", sorted(EDGES))
def test_kernel_edges(edge):
    _needs_cuda()
    kw = dict(EDGES[edge])
    L, R, B = kw.pop("L"), kw.pop("R"), kw.pop("B", 60)
    for seed in range(3):
        _check_on_card(*clusters(seed, B, L, R, **kw))


@pytest.mark.cuda
def test_kernel_counts_a_cluster_whose_records_all_fail_has_run():
    _needs_cuda()
    text, got = _check_on_card(*_run_failing_then_written())
    assert got["emit_counts"]["dropped_complexity"] == 1
    assert got["cluster_nr"] == 3
    assert text.startswith(">cluster:2_id:1_") and ">cluster:1_" not in text


@pytest.mark.cuda
def test_kernel_cluster_numbers_cross_digit_widths():
    """101,000 counted clusters: cluster numbers of 4, 5 and 6 digits."""
    _needs_cuda()
    rng = np.random.default_rng(5)
    B, L, R = 101_000, 12, 8
    cfg = cfg_of(mcov_out=2, max_snvs=3, max_gap=1, complexity=5)
    freq = rng.random((B, 4)) < 0.7
    freq[:, :2] = True
    ctx = np.repeat(rng.integers(0, 4, (B, 1, L)), 4, 1).astype(np.int8)
    ctx[:, :, -1] = np.arange(4)
    arrays = (np.ones(B, bool), freq, np.ones((B, 4), bool),
              rng.integers(1, 200_000, (B, 4)), ctx,
              rng.integers(0, 4, (B, R)).astype(np.int8),
              rng.integers(0, R + 1, B))
    text, got = _check_on_card(cfg, arrays)
    assert got["cluster_nr"] == B + 1
    for nr in (9_999, 10_000, 99_999, 100_000):
        assert f">cluster:{nr}_id:1_" in text


def test_entry_sends_cpu_tensors_to_the_plain_version(monkeypatch):
    cfg, arrays = _codes(single_trial(0))
    calls = []
    plain = emit_vec.emit_single_plain

    def recorded(*a):
        calls.append(a)
        return plain(*a)

    monkeypatch.setattr(emit_vec, "emit_single_plain", recorded)
    text, got = run_entry(cfg, arrays, "cpu")
    assert len(calls) == 1
    ctx_ascii = calls[0][7]  # (out_f, cfg, found, passes, ..., ctx_ascii
    assert isinstance(ctx_ascii, np.ndarray) and \
        set(np.unique(ctx_ascii)) <= set(BASES)
    monkeypatch.setattr(emit_vec, "emit_single_plain", plain)
    assert (text, got) == run_plain(cfg, arrays)
    assert (text, got["events"], got["cluster_nr"]) == run_writer(cfg, arrays)


def test_kernel_wrapper_refuses_cpu_tensors():
    cfg, arrays = _codes(single_trial(0))
    ts = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    before = emit_cuda.LAUNCHES["emit_single"]
    with pytest.raises(ValueError, match="CUDA device"):
        emit_cuda.emit_single(cfg, *ts)
    assert emit_cuda.LAUNCHES["emit_single"] == before
