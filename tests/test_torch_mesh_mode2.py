"""Mode 2 on the port's position mesh: the lockstep pair frontier
(navigate_two_bwts_sharded) against the port's single-device
navigate_two_bwts and the JAX package's navigate_two_bwts_frontier_device
on its 8-device virtual CPU mesh; the routed side-2 rank against the
sharded rank; the .snp of run_two_datasets_sharded at S = 1, 3 and 8
against the JAX package's run_two_datasets_sharded and the port's
run_two_datasets; an unbalanced pair and a deep one against the single
device; and the refusal of n1 + n2 >= CAP. Every comparison is exact
(integers and bytes, tolerance 0)."""

import numpy as np
import pytest
import torch

from ebwt2indel_tpu.ops import packing as jpacking
from ebwt2indel_tpu.parallel import frontier as jfrontier
from ebwt2indel_tpu.parallel import pipeline as jppipe
from ebwt2indel_tpu.parallel import shard as jshard
from ebwt2indel_tpu.utils.config import Config as JConfig
from ebwt2indel_torch import cli
from ebwt2indel_torch.models import fm_index, pipeline, traverse
from ebwt2indel_torch.ops import packing
from ebwt2indel_torch.parallel import frontier, mesh, shard
from ebwt2indel_torch.parallel import pipeline as ppipe
from ebwt2indel_torch.tools import ebwt, simulate
from ebwt2indel_torch.utils import dna
from ebwt2indel_torch.utils.config import Config

_QUIET = {"log": lambda *a, **k: None}
_STATS = ("events", "cluster_nr", "leaves", "nodes", "lcp_values", "n_min",
          "da_values", "n_clusters")
_NAV = ("leaves", "nodes", "lcp_values", "n_min", "da_values")
K, K_RIGHT = 20, 30  # Config's defaults


def _reads(seed, genome_len, coverage, read_len):
    rng = np.random.default_rng(seed)
    genome = simulate.random_genome(rng, genome_len)
    hap2, _ = simulate.plant_variants(rng, genome, snp_rate=0.004,
                                      indel_rate=0.001)
    return (simulate.sample_reads(rng, genome, coverage, read_len),
            simulate.sample_reads(rng, hap2, coverage, read_len))


def _write_pair(d, reads1, reads2) -> dict:
    paths = {"input1": str(d / "a.ebwt"), "input2": str(d / "b.ebwt")}
    for key, reads in (("input1", reads1), ("input2", reads2)):
        open(paths[key], "w").write(ebwt.ebwt_of_reads(reads))
    return paths


def _packs(paths):
    return [packing.pack_file(paths[k]) for k in ("input1", "input2")]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The JAX mesh tests' mode-2 input (5,000 bp, 8x of 80 bp reads per
    haplotype): the port's single-device flags and .snp, and the JAX
    package's 8-device frontier flags and mesh .snp."""
    d = tmp_path_factory.mktemp("torch_mesh2")
    paths = _write_pair(d, *_reads(0x2E5, 5000, 8, 80))
    pb1, pb2 = _packs(paths)
    one_nav = traverse.navigate_two_bwts(
        fm_index.FMIndex.from_packed(pb1, "cpu"),
        fm_index.FMIndex.from_packed(pb2, "cpu"), K, K_RIGHT, packed=False)
    jm = jshard.make_mesh(8)
    jflags = jfrontier.navigate_two_bwts_frontier_device(
        *[jshard.shard_fm(jpacking.pack_codes(
            dna.str_to_codes(open(paths[k]).read())), jm)
          for k in ("input1", "input2")], K, K_RIGHT)[:4]
    one = str(d / "one.snp")
    stats = pipeline.run_two_datasets(Config(output=one, **paths),
                                      device="cpu", **_QUIET)
    jout = str(d / "jax_mesh.snp")
    jppipe.run_two_datasets_sharded(JConfig(output=jout, **paths), jm,
                                    **_QUIET)
    return {"paths": paths, "dir": d, "packs": (pb1, pb2), "nav": one_nav,
            "jflags": [np.asarray(f) for f in jflags],
            "one": open(one, "rb").read(), "jax": open(jout, "rb").read(),
            "stats": stats}


def _sharded_flags(pb1, pb2, S, K_=K, k_right=K_RIGHT):
    m = mesh.Mesh(S, device="cpu")
    *flags, st = frontier.navigate_two_bwts_sharded(
        shard.shard_fm(pb1, m), shard.shard_fm(pb2, m), K_, k_right)
    n = pb1.n + pb2.n
    out = []
    for f in flags:
        g = torch.cat([f[s] for s in sorted(f)])
        assert not g[n:].any()
        assert g.shape[0] == frontier.merged_local_n(n, S) * S
        out.append(g[:n].numpy())
    return out, st


def _assert_equals_single(flags, st, nav):
    for name, g in zip(("thr_K", "thr_R", "minima", "da"), flags):
        np.testing.assert_array_equal(g, getattr(nav, name).numpy(), name)
    for k in _NAV:
        assert st[k] == nav.stats[k], k


@pytest.mark.parametrize("S", [1, 3, 8])
def test_pair_frontier_matches_jax_and_single_device(data, S):
    """thr_K, thr_R, minima and da gathered and cut to n, and the counts,
    equal the single device's dense flags and the JAX frontier's."""
    pb1, pb2 = data["packs"]
    flags, st = _sharded_flags(pb1, pb2, S)
    _assert_equals_single(flags, st, data["nav"])
    n = pb1.n + pb2.n
    for g, j in zip(flags, data["jflags"]):
        np.testing.assert_array_equal(g, j[:n].astype(np.uint8))
    assert st["leaf_steps"] > 0 and st["node_steps"] > 0
    assert (st["comm_bytes_per_step"] > 0) == (S > 1)


@pytest.mark.parametrize("S", [3, 8])
def test_routed_rank_matches_sharded_rank(data, S):
    """Narrow side-2 coordinate rows (k = 2 and k = 6, spanning at most
    two blocks, the shard edges among them) held by every shard, each
    decoded by its owner after the route, equal the sharded rank."""
    pb2 = data["packs"][1]
    m = mesh.Mesh(S, device="cpu")
    sfm = shard.shard_fm(pb2, m)
    rng = np.random.default_rng(S)
    edges = [min(k * sfm.local_n + d, pb2.n) for k in range(S)
             for d in (-1, 0, 1) if k * sfm.local_n + d >= 0]
    for k in (2, 6):
        coords = {}
        for s in m.local:
            first = np.concatenate([edges, rng.integers(0, pb2.n + 1, 300)])
            step = rng.integers(0, 100, (first.size, k))
            step[:, 0] = 0
            c = np.minimum(first[:, None] + step.cumsum(1), pb2.n)
            c = c[((c[:, -1] >> 7) - (c[:, 0] >> 7)) <= 1]
            coords[s] = torch.from_numpy(c)
        got = frontier._routed_rank(sfm, coords)
        for s, c in coords.items():
            assert torch.equal(got[s], shard.sharded_parallel_rank(sfm, c))


@pytest.mark.parametrize("S", [1, 3, 8])
def test_mode2_sharded_snp_matches_jax_and_single_device(data, S):
    out = str(data["dir"] / f"mesh{S}.snp")
    st = ppipe.run_two_datasets_sharded(
        Config(output=out, **data["paths"]), mesh.Mesh(S, device="cpu"),
        **_QUIET)
    got = open(out, "rb").read()
    assert data["jax"] == data["one"] and len(got) > 0
    assert got == data["one"]
    for k in _STATS:
        assert st[k] == data["stats"][k], k
    assert set(st["seconds"]) == {"index", "leaf_phase", "node_phase",
                                  "cluster", "call_emit", "call_emit.walks",
                                  "call_emit.write", "call_emit.da_rank",
                                  "call_emit.align", "call_emit.format"}


@pytest.mark.parametrize("S,small", [(8, 1), (3, 2)])
def test_unbalanced_pair_matches_single_device(tmp_path, S, small):
    """A handful of reads against the full set (n1 << n2, then n2 << n1):
    the three partitions differ widely, and the flags, counts and .snp
    equal the single device's."""
    reads1, reads2 = _reads(0xB1 + small, 4000, 8, 80)
    if small == 1:
        reads1 = reads1[:6]
    else:
        reads2 = reads2[:6]
    paths = _write_pair(tmp_path, reads1, reads2)
    pb1, pb2 = _packs(paths)
    assert min(pb1.n, pb2.n) * 50 < max(pb1.n, pb2.n)
    nav = traverse.navigate_two_bwts(
        fm_index.FMIndex.from_packed(pb1, "cpu"),
        fm_index.FMIndex.from_packed(pb2, "cpu"), K, K_RIGHT, packed=False)
    _assert_equals_single(*_sharded_flags(pb1, pb2, S), nav)
    one, got = str(tmp_path / "one.snp"), str(tmp_path / "mesh.snp")
    pipeline.run_two_datasets(Config(output=one, **paths), device="cpu",
                              **_QUIET)
    ppipe.run_two_datasets_sharded(Config(output=got, **paths),
                                   mesh.Mesh(S, device="cpu"), **_QUIET)
    assert open(got, "rb").read() == open(one, "rb").read()


def test_deep_pair_matches_single_device(tmp_path):
    """3x of 520 bp reads (tests/test_torch_traverse_pair.py's deep input,
    whose reads pass the depth where the JAX frontier falls back): the
    pair frontier's flags and counts equal the single device's through a
    node phase more than 400 mesh steps deep."""
    paths = _write_pair(tmp_path, *_reads(0xD1, 1500, 3, 520))
    pb1, pb2 = _packs(paths)
    nav = traverse.navigate_two_bwts(
        fm_index.FMIndex.from_packed(pb1, "cpu"),
        fm_index.FMIndex.from_packed(pb2, "cpu"), K, K_RIGHT, packed=False)
    flags, st = _sharded_flags(pb1, pb2, 3)
    _assert_equals_single(flags, st, nav)
    assert st["node_steps"] > 400


def test_merged_cap_refused(data, monkeypatch, capsys):
    """n1 + n2 >= CAP, each input under it: the frontier raises CAP_MESSAGE
    before it allocates, the pipeline before it loads, and the CLI exits 1
    with the message."""
    pb1, pb2 = data["packs"]
    monkeypatch.setattr(packing, "CAP", pb1.n + pb2.n)
    m = mesh.Mesh(2, device="cpu")
    sfm1, sfm2 = shard.shard_fm(pb1, m), shard.shard_fm(pb2, m)

    def no_alloc(*a, **k):
        raise AssertionError("allocated past the cap")

    monkeypatch.setattr(frontier, "_drive", no_alloc)
    monkeypatch.setattr(shard, "shard_fm_from_file", no_alloc)
    with pytest.raises(ValueError, match="32-bit block counters"):
        frontier.navigate_two_bwts_sharded(sfm1, sfm2, K, K_RIGHT)
    out = data["dir"] / "cap.snp"
    with pytest.raises(ValueError, match="32-bit block counters"):
        ppipe.run_two_datasets_sharded(Config(output=str(out),
                                              **data["paths"]), m, **_QUIET)
    monkeypatch.setenv("EBWT_MESH", "2")
    assert cli.main(["-1", data["paths"]["input1"], "-2",
                     data["paths"]["input2"], "-o", str(out)],
                    device="cpu") == 1
    assert packing.CAP_MESSAGE in capsys.readouterr().out
    assert not out.exists()
