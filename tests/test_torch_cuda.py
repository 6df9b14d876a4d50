"""Tests of the port that need an NVIDIA GPU: the CUDA rank kernel against
its plain PyTorch version, modes 1, 2 and 3 on the card against the same
mode on the CPU, and the bit-packed route against the dense route.
A CUDA kernel has no CPU mode, so without a card these skip. On the card:

    python -m pytest tests/test_torch_cuda.py -m cuda

The file imports nothing from ``tests``, so it also collects where another
package of that name is installed."""

import numpy as np
import pytest
import torch

from ebwt2indel_torch.models import pipeline, traverse
from ebwt2indel_torch.ops import packing, rank, rank_cuda
from ebwt2indel_torch.tools import ebwt, genhuge, simulate
from ebwt2indel_torch.utils.config import Config

pytestmark = pytest.mark.cuda


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the rank kernel runs only on the "
                    "card")


def test_rank_kernel_matches_plain_on_card(rng):
    """Exact equality with the plain version, edge positions included, and
    one launch counted per call."""
    _needs_cuda()
    n = 200_003
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    codes[rng.random(n) < 0.03] = 4
    blocks = torch.from_numpy(packing.pack_codes(codes).blocks.view(np.int32))
    qs = torch.from_numpy(np.concatenate(
        [rng.integers(0, n + 1, size=100_000), [0, 127, 128, n - 1, n]]))
    before = rank_cuda.LAUNCHES["rank_decode"]
    got = rank.parallel_rank(blocks.cuda(), qs.cuda())
    torch.cuda.synchronize()
    assert rank_cuda.LAUNCHES["rank_decode"] == before + 1
    assert torch.equal(got.cpu(), rank.parallel_rank_plain(blocks, qs))


def test_mode1_cuda_matches_cpu(tmp_path, rng):
    """The .snp of mode 1 on the card is byte-identical to the CPU's."""
    _needs_cuda()
    genome = simulate.random_genome(rng, 20_000)
    hap2, _ = simulate.plant_variants(rng, genome, snp_rate=0.004,
                                      indel_rate=0.001)
    reads = simulate.sample_reads(rng, genome, 8, 100) + \
        simulate.sample_reads(rng, hap2, 8, 100)
    path = tmp_path / "r.ebwt"
    path.write_text(ebwt.ebwt_of_reads(reads))
    outs = {}
    for dev in ("cuda", "cpu"):
        out = tmp_path / f"{dev}.snp"
        pipeline.run_one_dataset(Config(input1=str(path), output=str(out)),
                                 log=lambda *a, **k: None, device=dev)
        outs[dev] = out.read_bytes()
    assert outs["cuda"] == outs["cpu"] and outs["cpu"]


def _pair_reads(rng):
    genome = simulate.random_genome(rng, 20_000)
    hap2, _ = simulate.plant_variants(rng, genome, snp_rate=0.004,
                                      indel_rate=0.001)
    return (simulate.sample_reads(rng, genome, 8, 100),
            simulate.sample_reads(rng, hap2, 8, 100))


def _cuda_vs_cpu(run, cfg_of, tmp_path):
    outs, stats = {}, {}
    for dev in ("cuda", "cpu"):
        out = tmp_path / f"{dev}.snp"
        stats[dev] = run(cfg_of(str(out)), log=lambda *a, **k: None,
                         device=dev)
        outs[dev] = out.read_bytes()
    assert outs["cuda"] == outs["cpu"] and outs["cpu"]
    for k in ("leaves", "nodes", "lcp_values", "n_min", "n_clusters",
              "events", "cluster_nr"):
        assert stats["cuda"][k] == stats["cpu"][k], k
    return stats


def test_mode3_cuda_matches_cpu(tmp_path, rng):
    """The .snp of mode 3 on the card is byte-identical to the CPU's."""
    _needs_cuda()
    bwt, da = ebwt.ebwt_and_da_of_two(*_pair_reads(rng))
    (tmp_path / "m.ebwt").write_text(bwt)
    (tmp_path / "m.da").write_text(da)
    _cuda_vs_cpu(pipeline.run_two_datasets_da,
                 lambda out: Config(input1=str(tmp_path / "m.ebwt"),
                                    input_da=str(tmp_path / "m.da"),
                                    output=out), tmp_path)


def test_mode2_cuda_matches_cpu(tmp_path, rng):
    """The .snp of mode 2 on the card is byte-identical to the CPU's, and
    the traversal's DA count agrees."""
    _needs_cuda()
    reads1, reads2 = _pair_reads(rng)
    (tmp_path / "a.ebwt").write_text(ebwt.ebwt_of_reads(reads1))
    (tmp_path / "b.ebwt").write_text(ebwt.ebwt_of_reads(reads2))
    st = _cuda_vs_cpu(pipeline.run_two_datasets,
                      lambda out: Config(input1=str(tmp_path / "a.ebwt"),
                                         input2=str(tmp_path / "b.ebwt"),
                                         output=out), tmp_path)
    assert st["cuda"]["da_values"] == st["cpu"]["da_values"]


def test_mode1_packed_matches_dense_on_card(tmp_path, monkeypatch):
    """At 4M positions the bit-packed route writes the dense route's .snp
    on the card, with the stats equal; slices of 2^20 positions make its
    passes cross slice boundaries."""
    _needs_cuda()
    path = tmp_path / "r.ebwt"
    n = genhuge.build(200_000, str(path), coverage=20, log=lambda *a: None)
    assert n > 4_000_000
    monkeypatch.setattr(traverse, "LEAN_SLICE", 1 << 20)
    outs, stats = {}, {}
    for packed in (True, False):
        out = tmp_path / f"{packed}.snp"
        stats[packed] = pipeline.run_one_dataset(
            Config(input1=str(path), output=str(out)),
            log=lambda *a, **k: None, device="cuda", packed=packed)
        outs[packed] = out.read_bytes()
    assert outs[True] == outs[False] and outs[True]
    for k in ("leaves", "nodes", "lcp_values", "n_min", "n_clusters",
              "events", "cluster_nr"):
        assert stats[True][k] == stats[False][k], k
