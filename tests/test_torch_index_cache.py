"""The index cache of the port (``EBWT_INDEX_CACHE``; ``save_packed``,
``load_packed`` and ``pack_file_cached`` of ebwt2indel_torch/ops/packing.py)
against the JAX package's, on the CPU: each package reads the other's
``<input>.idx.npz`` sidecar with equal arrays and dtypes; a warm call packs
nothing; a stale or corrupt sidecar is repacked and rewritten; and
``cli.main`` with the switch set writes the JAX package's .snp in modes 1
and 2, reading a sidecar the JAX package wrote and writing one of its own.
Everything compared is integer or bytes, so the tolerance is 0."""

import os

import numpy as np
import pytest

from ebwt2indel_tpu.models import pipeline as jpipeline
from ebwt2indel_tpu.models import traverse as jtraverse
from ebwt2indel_tpu.ops import packing as jpacking
from ebwt2indel_tpu.utils.config import Config as JConfig
from ebwt2indel_torch import cli
from ebwt2indel_torch.ops import packing
from ebwt2indel_torch.tools import ebwt, simulate
from tests.test_rank import random_codes

_FIELDS = ("blocks", "block_counts", "F", "counts")


def _assert_same(got, want):
    for k in _FIELDS:
        g, w = getattr(got, k), getattr(want, k)
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    assert (got.n, got.term) == (want.n, want.term)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_each_package_reads_the_others_sidecar(tmp_path, writer):
    codes = random_codes(np.random.default_rng(7), 5000, p_term=0.03)
    pb = packing.pack_codes(codes)
    jpb = jpacking.pack_codes(codes)
    _assert_same(pb, jpb)
    path = str(tmp_path / "x.idx")
    if writer == "jax":
        jpacking.save_packed(jpb, path)
        got = packing.load_packed(path + ".npz")
    else:
        packing.save_packed(pb, path)
        got = jpacking.load_packed(path + ".npz")
    assert os.listdir(tmp_path) == ["x.idx.npz"]
    _assert_same(got, pb)


@pytest.fixture
def ebwt_file(tmp_path):
    path = tmp_path / "r.ebwt"
    rng = np.random.default_rng(3)
    path.write_text(ebwt.ebwt_of_reads(simulate.sample_reads(
        rng, simulate.random_genome(rng, 2000), 6, 60)))
    return path


def _no_pack(*a, **k):
    raise AssertionError("packed although a valid sidecar exists")


def test_warm_call_does_not_pack(ebwt_file, monkeypatch):
    cold = packing.pack_file_cached(str(ebwt_file))
    assert os.path.isfile(str(ebwt_file) + ".idx.npz")
    _assert_same(cold, packing.pack_file(str(ebwt_file)))
    monkeypatch.setattr(packing, "pack_file", _no_pack)
    _assert_same(packing.pack_file_cached(str(ebwt_file)), cold)


def _sidecar(path) -> str:
    return str(path) + ".idx.npz"


def test_stale_sidecar_is_repacked(ebwt_file):
    """An input newer than its sidecar is packed again and the sidecar
    rewritten: here the input changed under an older sidecar."""
    packing.pack_file_cached(str(ebwt_file))
    old = os.path.getmtime(_sidecar(ebwt_file))
    ebwt_file.write_text(ebwt_file.read_text()[::-1])
    os.utime(ebwt_file, (old + 10, old + 10))
    got = packing.pack_file_cached(str(ebwt_file))
    want = packing.pack_file(str(ebwt_file))
    _assert_same(got, want)
    _assert_same(packing.load_packed(_sidecar(ebwt_file)), want)


@pytest.mark.parametrize("damage", ["garbage", "truncated", "other term"])
def test_corrupt_sidecar_is_repacked(ebwt_file, damage):
    """A sidecar that does not load, or holds another terminator's index,
    is packed again and rewritten, newer than its input or not."""
    want = packing.pack_file(str(ebwt_file))
    if damage == "garbage":
        open(_sidecar(ebwt_file), "wb").write(b"not an npz file")
    elif damage == "truncated":
        packing.save_packed(want, _sidecar(ebwt_file))
        data = open(_sidecar(ebwt_file), "rb").read()
        open(_sidecar(ebwt_file), "wb").write(data[:len(data) // 2])
    else:
        other = packing.pack_codes(np.zeros(want.n, np.uint8), ord("$"))
        packing.save_packed(other, _sidecar(ebwt_file))
    _assert_same(packing.pack_file_cached(str(ebwt_file)), want)
    _assert_same(packing.load_packed(_sidecar(ebwt_file)), want)
    assert sorted(os.listdir(ebwt_file.parent)) == ["r.ebwt",
                                                    "r.ebwt.idx.npz"]


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_index_cache")
    rng = np.random.default_rng(0x1DC)
    genome = simulate.random_genome(rng, 1500)
    hap2, _ = simulate.plant_variants(rng, genome, snp_rate=0.004,
                                      indel_rate=0.001)
    reads = {"a": simulate.sample_reads(rng, genome, 6, 60),
             "b": simulate.sample_reads(rng, hap2, 6, 60)}
    reads["m"] = reads["a"] + reads["b"]  # mode 1's input
    for name, r in reads.items():
        (d / f"{name}.ebwt").write_text(ebwt.ebwt_of_reads(r))
    return d


@pytest.mark.parametrize("mode", [1, 2])
def test_cli_with_the_cache_writes_the_jax_snp(pair, mode, tmp_path,
                                               monkeypatch, capsys):
    """The JAX package's run with EBWT_INDEX_CACHE=1 writes the sidecars and
    its .snp; the port's CLI reads those sidecars (it packs nothing) and
    writes the same bytes; without sidecars it writes its own, which hold
    the JAX package's index, and again the same bytes."""
    d = tmp_path
    inputs = ["m"] if mode == 1 else ["a", "b"]
    for k in inputs:
        (d / f"{k}.ebwt").write_bytes((pair / f"{k}.ebwt").read_bytes())
    args = ["-1", str(d / f"{inputs[0]}.ebwt")] + \
        (["-2", str(d / "b.ebwt")] if mode == 2 else [])
    monkeypatch.setenv("EBWT_INDEX_CACHE", "1")
    cfg = JConfig(input1=args[1], output=str(d / "jax.snp"),
                  input2=str(d / "b.ebwt") if mode == 2 else None)
    with monkeypatch.context() as mp:
        mp.setattr(jtraverse, "CHUNK", 4096)
        run = jpipeline.run_one_dataset if mode == 1 else \
            jpipeline.run_two_datasets
        run(cfg, log=lambda *a, **k: None)
    want = (d / "jax.snp").read_bytes()
    assert want
    jax_idx = {k: jpacking.load_packed(_sidecar(d / f"{k}.ebwt"))
               for k in inputs}

    with monkeypatch.context() as mp:
        mp.setattr(packing, "pack_file", _no_pack)
        assert cli.main(args + ["-o", str(d / "warm.snp")],
                        device="cpu") == 0
    assert (d / "warm.snp").read_bytes() == want
    for k in inputs:
        os.remove(_sidecar(d / f"{k}.ebwt"))
    assert cli.main(args + ["-o", str(d / "cold.snp")], device="cpu") == 0
    assert (d / "cold.snp").read_bytes() == want
    for k in inputs:
        _assert_same(packing.load_packed(_sidecar(d / f"{k}.ebwt")),
                     jax_idx[k])
    capsys.readouterr()
