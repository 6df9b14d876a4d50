"""Mode 3 on the port's position mesh: the sharded document-array rank
structure (bv_build/bv_rank1/bv_get_sharded) against the JAX package's on
its 8-device virtual CPU mesh and against the port's single-device one; the
DA = 1 side's masked loader against sharding the single device's masked
bytes; and the .snp of run_two_datasets_da_sharded at S = 1, 3 and 8
against the JAX package's run_two_datasets_da_sharded and the port's
run_two_datasets_da. Every comparison is exact (integers and bytes,
tolerance 0)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ebwt2indel_tpu.parallel import calling as jcalling
from ebwt2indel_tpu.parallel import pipeline as jppipe
from ebwt2indel_tpu.parallel import shard as jshard
from ebwt2indel_tpu.utils.config import Config as JConfig
from ebwt2indel_torch.models import pipeline
from ebwt2indel_torch.ops import bits, packing, rank
from ebwt2indel_torch.parallel import calling, mesh, shard
from ebwt2indel_torch.parallel import pipeline as ppipe
from ebwt2indel_torch.tools import ebwt, simulate
from ebwt2indel_torch.utils.config import Config

_QUIET = {"log": lambda *a, **k: None}
_STATS = ("events", "cluster_nr", "leaves", "nodes", "lcp_values", "n_min",
          "n_clusters")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The JAX mesh tests' mode-3 input (5,000 bp, 8x of 80 bp reads per
    haplotype), with the port's single-device .snp and the JAX package's
    8-device mesh .snp."""
    d = tmp_path_factory.mktemp("torch_mesh3")
    rng = np.random.default_rng(0x3E5)
    genome = simulate.random_genome(rng, 5000)
    hap2, _ = simulate.plant_variants(rng, genome, snp_rate=0.004,
                                      indel_rate=0.001)
    bwt, da = ebwt.ebwt_and_da_of_two(simulate.sample_reads(rng, genome, 8, 80),
                                      simulate.sample_reads(rng, hap2, 8, 80))
    paths = {"input1": str(d / "merged.ebwt"), "input_da": str(d / "merged.da")}
    open(paths["input1"], "w").write(bwt)
    open(paths["input_da"], "w").write(da)
    one = str(d / "one.snp")
    stats = pipeline.run_two_datasets_da(Config(output=one, **paths),
                                         device="cpu", **_QUIET)
    jout = str(d / "jax_mesh.snp")
    jppipe.run_two_datasets_da_sharded(JConfig(output=jout, **paths),
                                       jshard.make_mesh(8), **_QUIET)
    return {"paths": paths, "dir": d, "one": open(one, "rb").read(),
            "jax": open(jout, "rb").read(), "stats": stats}


def _local_n(n, S):
    return -(-(n // 128 + 1) // S) * 128  # the port's index partition


def _parts(x: np.ndarray, L: int, S: int) -> dict:
    pad = np.zeros(L * S, np.uint8)
    pad[:len(x)] = x
    return {s: torch.from_numpy(pad[s * L:(s + 1) * L].copy())
            for s in range(S)}


@pytest.mark.parametrize("S", [1, 3, 8])
@pytest.mark.parametrize("n", [5000, 1024])
def test_bv_sharded_matches_jax_and_single_device(S, n):
    """bv_rank1 and bv_get of the sharded DA at the shard edges (0, each
    L - 1, L and (s + 1) * L, n) and at random positions equal the JAX
    package's bv_rank1_sharded/bv_get_sharded and the single device's
    rank.bv_rank1/bv_get."""
    rng = np.random.default_rng(10 * S + n)
    x = (rng.random(n) < 0.4).astype(np.uint8)
    L = _local_n(n, S)
    edges = [0, L - 1, L, n] + [k * L + d for k in range(1, S)
                                for d in (-1, 0) if k * L <= n]
    q = np.array([i for i in edges if 0 <= i <= n]
                 + list(rng.integers(0, n + 1, 500)), np.int64)
    bv = calling.bv_build_sharded(mesh.Mesh(S, device="cpu"),
                                  _parts(x, L, S), local_n=L)
    r = calling.bv_rank1_sharded(bv, torch.from_numpy(q)).numpy()
    g = calling.bv_get_sharded(bv, torch.from_numpy(np.minimum(q, n - 1)))

    words, counts = bits.bv_build(torch.from_numpy(x))
    np.testing.assert_array_equal(
        r, rank.bv_rank1(words, counts, torch.from_numpy(q)).numpy())
    np.testing.assert_array_equal(
        g.numpy(), rank.bv_get(words, torch.from_numpy(np.minimum(q, n - 1)))
        .numpy())
    np.testing.assert_array_equal(r, np.concatenate([[0], np.cumsum(x)])[q])

    jm = jshard.make_mesh(S)
    jL = -(-(n + 2) // S)  # the JAX pipeline's partition
    pad = np.zeros(jL * S, bool)
    pad[:n] = x
    jda = jax.device_put(pad, NamedSharding(jm, P(jshard.AXIS)))
    cs, tot = jcalling.bv_build_sharded(jm, jda)
    jr = jcalling.bv_rank1_sharded(jm, cs, tot, jnp.asarray(q, jnp.int32),
                                   local_n=jL)
    jg = jcalling.bv_get_sharded(jm, jda, jnp.asarray(np.minimum(q, n - 1),
                                                      jnp.int32), local_n=jL)
    np.testing.assert_array_equal(r, np.asarray(jr))
    np.testing.assert_array_equal(g.numpy() != 0, np.asarray(jg))


@pytest.mark.parametrize("S", [3, 8])
def test_masked_loader_matches_single_device_bytes(data, S):
    """The DA = 1 side built range by range (load_da_side) equals sharding
    the single device's masked bytes, shard by shard; its DA rank equals
    the single device's at every position."""
    raw = np.fromfile(data["paths"]["input1"], np.uint8)
    da_bytes = np.fromfile(data["paths"]["input_da"], np.uint8)
    n = raw.size
    m = mesh.Mesh(S, device="cpu")
    sfm, bv = ppipe.load_da_side(m, raw, da_bytes, ord("#"))
    da = packing.read_da_file(data["paths"]["input_da"], n)
    want = shard.shard_fm(packing.pack_bytes(
        packing.mask_da0(raw, da, ord("#"))), m)
    assert (sfm.rows, sfm.n) == (want.rows, want.n)
    for s in range(S):
        assert torch.equal(sfm.blocks[s], want.blocks[s]), s
        assert torch.equal(sfm.block_counts[s], want.block_counts[s]), s
    assert torch.equal(sfm.bounds, want.bounds)
    assert torch.equal(sfm.F, want.F)
    assert bv.local_n == sfm.local_n
    words, counts = bits.from_numpy(*packing.pack_bitvector(da),
                                    device="cpu")
    q = torch.arange(n + 1)
    assert torch.equal(calling.bv_rank1_sharded(bv, q),
                       rank.bv_rank1(words, counts, q))
    assert torch.equal(calling.bv_get_sharded(bv, q[:n]),
                       rank.bv_get(words, q[:n]))


@pytest.mark.parametrize("S", [1, 3, 8])
def test_mode3_sharded_snp_matches_jax_and_single_device(data, S):
    out = str(data["dir"] / f"mesh{S}.snp")
    st = ppipe.run_two_datasets_da_sharded(
        Config(output=out, **data["paths"]), mesh.Mesh(S, device="cpu"),
        **_QUIET)
    got = open(out, "rb").read()
    assert data["jax"] == data["one"] and len(got) > 0
    assert got == data["one"]
    for k in _STATS:
        assert st[k] == data["stats"][k], k
    assert set(st["seconds"]) == {"index", "leaf_phase", "node_phase",
                                  "da_wait", "cluster", "call_emit",
                                  "call_emit.walks", "call_emit.write",
                                  "call_emit.align", "call_emit.format",
                                  "call_emit.da_rank"}
    assert st["leaf_steps"] > 0 and st["node_steps"] > 0
