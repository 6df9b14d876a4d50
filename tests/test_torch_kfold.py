"""The k-fold input: every read of a collection repeated k times in place.

Its eBWT is the 1-fold eBWT with every byte repeated k times (terminators
are distinct and ordered by read index, so the k copies of a suffix tie only
among themselves and keep their order), and so is the document array of a
merged pair. The suffix tree's work (leaves, nodes, minima, the largest
pending frontier) stays at the base input's from k = 2 on, while every
n-sized pass grows with k. ``chip_smoke.py`` uses this to put 2,206,844,243
positions (the 116M E. coli-scale inputs at k = 19), past 2^31, through
modes 1, 3 and 2 on the card, on one device and on the 4-shard mesh.

Here, on the CPU and at a few hundred thousand positions:

* (a) the identity, for k = 2 and 3, in the port's ``tools/ebwt.py`` and
  the JAX package's alike: ``ebwt_of_reads`` and both outputs of
  ``ebwt_and_da_of_two``;
* (b) the port on the CPU against the JAX package on a k = 3 input of a
  3,000 bp genome: the same .snp bytes and stats in modes 1, 3 and 2;
* (c) the stats invariant that ``chip_smoke.py`` holds at k = 19 against
  k = 2, here at k = 5 against k = 2, in the three modes: equal leaves,
  nodes, n_min and max_pending, and LCP values (mode 2: DA values too)
  equal to n;
* (d) the port's 4-shard mesh on the CPU against its single device on the
  k = 3 input, in the three modes;
* (e) ``traverse.add_at``, the windowed ``index_add_`` that every n-sized
  add goes through (a single ``index_add_`` into 2^31 elements or more
  does not launch on CUDA): with a window of 100 elements it adds what one
  ``index_add_`` adds, and with one of 16,384 the packed route and the
  mesh write the default run's .snp on the k = 3 input.

A true past-2^31 input needs at least 2 GB for each n-sized byte vector
(the flags, the document array) and 8.8 GB for each int32 delta vector, so
the coordinate range itself is shown on the card only (``chip_smoke.py``'s
``past2g31_*`` and ``mesh4_past2g31_*`` phases).
"""

import os

import numpy as np
import pytest

from ebwt2indel_tpu.models import pipeline as jpipeline
from ebwt2indel_tpu.models import traverse as jtraverse
from ebwt2indel_tpu.tools import ebwt as jebwt
from ebwt2indel_tpu.utils.config import Config as JConfig
import torch

from ebwt2indel_torch.models import pipeline, traverse
from ebwt2indel_torch.parallel import mesh
from ebwt2indel_torch.parallel import pipeline as ppipe
from ebwt2indel_torch.tools import ebwt, simulate
from ebwt2indel_torch.utils.config import Config
from tests.test_torch_hosttools import two_torch_threads  # noqa: F401

_QUIET = {"log": lambda *a, **k: None}
_STATS = ("events", "cluster_nr", "leaves", "nodes", "lcp_values", "n_min",
          "n_clusters")
_SAME = ("leaves", "nodes", "n_min", "max_pending")
_BUILDERS = {"torch": ebwt, "jax": jebwt}


@pytest.fixture(scope="module", autouse=True)
def _small_jax_chunks():
    """A smaller JAX chunk changes none of its results (the traversal's
    writes do not depend on visit order) and keeps the JAX legs short."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtraverse, "CHUNK", 4096)
        yield


def _repeat(reads: list, k: int) -> list:
    return [r for r in reads for _ in range(k)]


@pytest.fixture(scope="module")
def reads():
    """Two haplotypes of a 3,000 bp genome, 8x of 80 bp reads each."""
    rng = np.random.default_rng(0xEB38)
    genome = simulate.random_genome(rng, 3000)
    hap2, _ = simulate.plant_variants(rng, genome, snp_rate=0.004,
                                      indel_rate=0.001)
    return (simulate.sample_reads(rng, genome, 8, 80),
            simulate.sample_reads(rng, hap2, 8, 80))


@pytest.fixture(scope="module")
def kfold(reads, tmp_path_factory):
    """``kfold(k)``: the directory of the k-fold inputs of the three modes
    (``reads.ebwt``; ``merged.ebwt`` and ``merged.da``; ``a.ebwt`` and
    ``b.ebwt``), built on first use."""
    root = tmp_path_factory.mktemp("kfold")
    made = {}

    def make(k: int) -> dict:
        if k not in made:
            d = root / f"k{k}"
            d.mkdir()
            r1, r2 = (_repeat(r, k) for r in reads)
            (d / "reads.ebwt").write_text(ebwt.ebwt_of_reads(r1 + r2))
            (d / "a.ebwt").write_text(ebwt.ebwt_of_reads(r1))
            (d / "b.ebwt").write_text(ebwt.ebwt_of_reads(r2))
            bwt, da = ebwt.ebwt_and_da_of_two(r1, r2)
            (d / "merged.ebwt").write_text(bwt)
            (d / "merged.da").write_text(da)
            made[k] = d
        return made[k]

    return make


def _files(d, mode: int) -> dict:
    if mode == 1:
        return {"input1": str(d / "reads.ebwt")}
    if mode == 3:
        return {"input1": str(d / "merged.ebwt"),
                "input_da": str(d / "merged.da")}
    return {"input1": str(d / "a.ebwt"), "input2": str(d / "b.ebwt")}


_RUN = {1: pipeline.run_one_dataset, 3: pipeline.run_two_datasets_da,
        2: pipeline.run_two_datasets}
_JRUN = {1: jpipeline.run_one_dataset, 3: jpipeline.run_two_datasets_da,
         2: jpipeline.run_two_datasets}
_MESH = {1: ppipe.run_one_dataset_sharded,
         3: ppipe.run_two_datasets_da_sharded,
         2: ppipe.run_two_datasets_sharded}


def _run(d, mode: int, out: str) -> tuple[dict, bytes]:
    st = _RUN[mode](Config(output=str(d / out), **_files(d, mode)),
                    device="cpu", **_QUIET)
    return st, (d / out).read_bytes()


@pytest.mark.parametrize("pkg", sorted(_BUILDERS))
@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("what", ["reads", "pair"])
def test_kfold_ebwt_is_repeated_bytes(reads, pkg, k, what):
    """(a) The k-fold eBWT (and document array) is the 1-fold one with
    every byte repeated k times."""
    b = _BUILDERS[pkg]
    r1, r2 = reads
    if what == "reads":
        one = [b.ebwt_of_reads(r1 + r2)]
        got = [b.ebwt_of_reads(_repeat(r1 + r2, k))]
    else:
        one = list(b.ebwt_and_da_of_two(r1, r2))
        got = list(b.ebwt_and_da_of_two(_repeat(r1, k), _repeat(r2, k)))
    for x, y in zip(one, got):
        want = np.repeat(np.frombuffer(x.encode(), np.uint8), k)
        assert np.array_equal(np.frombuffer(y.encode(), np.uint8), want)


@pytest.mark.parametrize("mode", [1, 3, 2])
def test_kfold_port_matches_jax(kfold, mode):
    """(b) The port (CPU) and the JAX package write the same .snp bytes and
    stats on the k = 3 input."""
    d = kfold(3)
    st, got = _run(d, mode, f"torch{mode}.snp")
    jst = _JRUN[mode](JConfig(output=str(d / f"jax{mode}.snp"),
                              **_files(d, mode)), **_QUIET)
    assert got == (d / f"jax{mode}.snp").read_bytes() and got
    for key in _STATS + (("da_values",) if mode == 2 else ()):
        assert st[key] == jst[key], key


@pytest.mark.parametrize("mode", [1, 3, 2])
def test_kfold_stats_invariant(kfold, mode):
    """(c) From k = 2 on the suffix tree's counts do not move with k, and
    every position gets its LCP value (mode 2: its DA value)."""
    runs = {}
    for k in (2, 5):
        d = kfold(k)
        st, snp = _run(d, mode, f"inv{mode}.snp")
        files = _files(d, mode)
        n = sum(os.path.getsize(files[x]) for x in ("input1", "input2")
                if x in files)
        assert st["lcp_values"] == n and snp
        if mode == 2:
            assert st["da_values"] == n
        runs[k] = st
    for key in _SAME:
        assert runs[5][key] == runs[2][key], key


@pytest.mark.parametrize("mode", [1, 3, 2])
def test_kfold_mesh_matches_single_device(kfold, mode):
    """(d) The 4-shard mesh on the CPU writes the single device's .snp and
    stats on the k = 3 input."""
    d = kfold(3)
    st, want = _run(d, mode, f"one{mode}.snp")
    out = d / f"mesh{mode}.snp"
    mst = _MESH[mode](Config(output=str(out), **_files(d, mode)),
                      mesh.Mesh(4, device="cpu"), **_QUIET)
    assert out.read_bytes() == want and want
    for key in _STATS + (("da_values",) if mode == 2 else ()):
        assert mst[key] == st[key], key


@pytest.mark.parametrize("dtype", [torch.int32, torch.uint8])
def test_add_at_windows_match_index_add(monkeypatch, dtype):
    """(e) Window by window, ``add_at`` adds what one ``index_add_`` does,
    repeated positions and both ends of each window included."""
    monkeypatch.setattr(traverse, "ADD_WINDOW", 100)
    rng = np.random.default_rng(8)
    n = 1037
    idx = torch.from_numpy(np.concatenate(
        [rng.integers(0, n, 5000), [0, 99, 100, 101, 999, 1000, n - 1]]))
    val = torch.from_numpy(rng.integers(1, 4, idx.shape[0])).to(dtype)
    got = torch.zeros(n, dtype=dtype)
    traverse.add_at(got, idx, val)
    want = torch.zeros(n, dtype=dtype).index_add_(0, idx, val)
    assert torch.equal(got, want)


@pytest.mark.parametrize("mode", [1, 3, 2])
def test_kfold_windowed_adds_match(kfold, monkeypatch, mode):
    """(e) With 16,384-element windows (a few per vector, on each shard too)
    the packed route (the one taken past 2^31) and the 4-shard mesh write
    the default run's .snp."""
    d = kfold(3)
    _, want = _run(d, mode, f"default{mode}.snp")
    monkeypatch.setattr(traverse, "ADD_WINDOW", 16384)
    out = d / f"windowed{mode}.snp"
    _RUN[mode](Config(output=str(out), **_files(d, mode)), device="cpu",
               packed=True, **_QUIET)
    assert out.read_bytes() == want and want
    _MESH[mode](Config(output=str(out), **_files(d, mode)),
                mesh.Mesh(4, device="cpu"), **_QUIET)
    assert out.read_bytes() == want
