"""The port's piece-parallel driver (ebwt2indel_torch/tools/pebwt2indel.py,
on the CPU) against the JAX package's: the same chop, context sort and
split, and a byte-identical ``variants.snp``. The JAX tool's spawned JAX
workers take about 40 s on this input, so the JAX side runs its own chop,
sort, split and ``pipeline.run_one_dataset`` in this process on the same
pieces, and concatenates in piece order as its ``run`` does."""

import numpy as np
import pytest

from ebwt2indel_tpu.models import pipeline as jpipeline
from ebwt2indel_tpu.models import traverse as jtraverse
from ebwt2indel_tpu.tools import ebwt as jebwt
from ebwt2indel_tpu.tools import pebwt2indel as jpeb
from ebwt2indel_tpu.tools import simulate as jsim
from ebwt2indel_tpu.utils.config import Config
from ebwt2indel_torch.tools import pebwt2indel
from tests.test_torch_hosttools import two_torch_threads  # noqa: F401

READ_LEN = 100


@pytest.fixture(scope="module")
def reads_fasta(tmp_path_factory):
    """Reads of a 12 kbp genome and a second haplotype, some longer than a
    piece (chopped, remainder dropped) and some with an N."""
    d = tmp_path_factory.mktemp("torch_pebwt2indel")
    rng = np.random.default_rng(0xA10)
    genome = jsim.random_genome(rng, 12_000)
    hap2, _ = jsim.plant_variants(rng, genome, snp_rate=0.003,
                                  indel_rate=0.0005)
    reads = jsim.sample_reads(rng, genome, 8, READ_LEN) + \
        jsim.sample_reads(rng, hap2, 8, READ_LEN)
    reads += [genome[500:760], "N" * 3 + genome[900:1097]]
    path = d / "reads.fa"
    jebwt.write_fasta_reads(str(path), reads)
    return d, path


def _jax_pieces(path, threads):
    reads = jpeb._chop_reads(jebwt.read_fasta(str(path)), READ_LEN)
    reads.sort(key=jpeb._context_key)
    p = max(threads, 2)
    per = (len(reads) + p - 2) // (p - 1)  # as jpeb.run (:79-81)
    return [reads[i: i + per] for i in range(0, len(reads), per)]


def test_chop_sort_split_match_jax(reads_fasta):
    _, path = reads_fasta
    reads = jebwt.read_fasta(str(path))
    chopped = pebwt2indel._chop_reads(reads, READ_LEN)
    assert chopped == jpeb._chop_reads(reads, READ_LEN)
    assert all(len(r) == READ_LEN and "N" not in r for r in chopped)
    assert sorted(chopped, key=pebwt2indel._context_key) == \
        sorted(chopped, key=jpeb._context_key)


def test_variants_snp_matches_jax(reads_fasta, monkeypatch):
    """Three workers give two pieces (``per = ceil(len / 2)``)."""
    d, path = reads_fasta
    pieces = _jax_pieces(path, 3)
    assert len(pieces) == 2
    want = b""
    monkeypatch.setattr(jtraverse, "CHUNK", 4096)  # changes no result
    for i, piece in enumerate(pieces):
        bwt = d / f"jax{i}.ebwt"
        bwt.write_text(jebwt.ebwt_of_reads(piece))
        snp = d / f"jax{i}.snp"
        jpipeline.run_one_dataset(
            Config(input1=str(bwt), output=str(snp), mcov_out=3),
            log=lambda *a, **k: None)
        want += snp.read_bytes()

    out = d / "torch"
    logged = []
    final = pebwt2indel.run(str(path), 3, READ_LEN, str(out), 3,
                            device="cpu", log=logged.append)
    assert open(final, "rb").read() == want and want
    assert any("2 pieces" in m for m in logged)
    # the pieces' eBWT and .snp files are removed
    assert sorted(p.name for p in out.iterdir()) == ["variants.snp"]


def test_main_writes_run_output(reads_fasta, capsys):
    d, path = reads_fasta
    assert pebwt2indel.main([str(path), "2", str(READ_LEN), str(d / "cli"),
                             "--device", "cpu"]) == 0
    run = pebwt2indel.run(str(path), 2, READ_LEN, str(d / "run"), 3,
                          device="cpu", log=lambda *a: None)
    assert "1 pieces" in capsys.readouterr().out
    assert (d / "cli" / "variants.snp").read_bytes() == \
        open(run, "rb").read()
