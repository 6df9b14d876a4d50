"""The port's position mesh (ebwt2indel_torch/parallel/) against the JAX
package's on the 8-device virtual CPU mesh of tests/conftest.py, on the same
numpy inputs: sharded rank and select, the sharded loader, the frontier
traversal's flags and stats, and the clusters and anchor table. Every
comparison is exact (integers and bytes, tolerance 0)."""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ebwt2indel_tpu.ops import packing as jpacking
from ebwt2indel_tpu.parallel import calling as jcalling
from ebwt2indel_tpu.parallel import frontier as jfrontier
from ebwt2indel_tpu.parallel import shard as jshard
from ebwt2indel_tpu.utils import dna
from ebwt2indel_torch.models import fm_index, traverse
from ebwt2indel_torch.ops import packing, rank
from ebwt2indel_torch.parallel import calling, frontier, mesh, shard
from tests import oracle
from tests.test_rank import random_codes


def _mesh(S):
    return mesh.Mesh(S, device="cpu")


def _jax_select(jm, jsfm, r, c):
    @partial(jax.shard_map, mesh=jm,
             in_specs=(P(jshard.AXIS, None), P(jshard.AXIS, None), P(), P(),
                       P()), out_specs=P(), check_vma=False)
    def run(b, cnt, bounds, r_, c_):
        return jax.lax.psum(
            jshard.local_select(b, cnt, bounds, jsfm.rows, r_, c_),
            jshard.AXIS)

    return np.asarray(jax.jit(run)(jsfm.blocks, jsfm.block_counts,
                                   jsfm.bounds, jnp.asarray(r, jnp.int32),
                                   jnp.asarray(c, jnp.int32)))


# n = 300 packs 3 block rows: at S = 8 five trailing shards hold no row of
# the input; "skew" puts every query inside shard 0's range
@pytest.mark.parametrize("S", [1, 3, 8])
@pytest.mark.parametrize("n,skew", [(20000, False), (20000, True),
                                    (300, False)])
def test_sharded_rank_and_select_match_jax(S, n, skew):
    rng = np.random.default_rng(1000 * S + n + skew)
    codes = random_codes(rng, n)
    pb = packing.pack_codes(codes)
    sfm = shard.shard_fm(pb, _mesh(S))
    jm = jshard.make_mesh(S)
    jsfm = jshard.shard_fm(jpacking.pack_codes(codes), jm)
    assert sfm.rows == jsfm.rows
    hi = min(sfm.local_n, n) if skew else n + 1
    q = np.concatenate([rng.integers(0, hi, size=700), [0, n]])
    got = shard.sharded_parallel_rank(sfm, torch.from_numpy(q)).numpy()
    want = np.asarray(jax.jit(jshard.sharded_parallel_rank(jm, jsfm.rows))(
        jsfm.blocks, jnp.asarray(q, jnp.int32)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, rank.parallel_rank_plain(
        torch.from_numpy(pb.blocks.view(np.int32)), torch.from_numpy(q)))

    totals = pb.counts[:4]
    c = rng.choice(np.flatnonzero(totals), size=500)
    r = (rng.random(500) * totals[c]).astype(np.int64)
    if skew:  # ranks held by shard 0 alone
        r = np.minimum(r, np.maximum(sfm.bounds[1].numpy()[c] - 1, 0))
    got = shard.sharded_select(sfm, torch.from_numpy(r),
                               torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(got, _jax_select(jm, jsfm, r, c))
    for k in range(0, 500, 50):
        assert got[k] == oracle.select_oracle(codes, int(r[k]), int(c[k]))


@pytest.mark.parametrize("S,n", [(3, 5000), (8, 700), (8, 1024)])
def test_loader_matches_jax(tmp_path, S, n):
    """Rows, counters, bounds and F of the sharded loader equal the JAX
    loader's (its uint32 views widened), and equal the port's sharding of
    an index packed in full; each shard's halo is its right neighbour's
    first row."""
    rng = np.random.default_rng(n)
    path = str(tmp_path / "in.ebwt")
    with open(path, "w") as f:
        f.write(dna.codes_to_str(random_codes(rng, n, p_term=0.04)))
    sfm = shard.shard_fm_from_file(path, _mesh(S))
    full = shard.shard_fm(packing.pack_file(path), _mesh(S))
    jsfm = jshard.shard_fm_from_file(path, jshard.make_mesh(S))
    rows = jsfm.rows
    assert (sfm.rows, sfm.n, sfm.local_bytes) == (rows, n, jsfm.local_bytes)
    jb = np.asarray(jsfm.blocks)
    jc = packing.widen_u32(np.asarray(jsfm.block_counts))
    for s in range(S):
        for x in (sfm, full):
            b = x.blocks[s].numpy().view(np.uint32)
            np.testing.assert_array_equal(b[:rows], jb[s * rows:(s + 1) * rows])
            if s + 1 < S:
                np.testing.assert_array_equal(b[rows], jb[(s + 1) * rows])
            np.testing.assert_array_equal(x.block_counts[s].numpy(),
                                          jc[s * rows:(s + 1) * rows])
    ranges = packing.shard_row_ranges(n, S)
    assert ranges == jpacking.shard_row_ranges(n, S)
    for lo, hi in ranges:  # each range alone, counters local to it
        got = packing.pack_file_range(path, lo, hi, n)
        want = jpacking.pack_file_range(path, lo, hi, n)
        np.testing.assert_array_equal(got.rows, want.rows)
        np.testing.assert_array_equal(got.row_counts, want.row_counts)
        np.testing.assert_array_equal(got.totals, want.totals)
        assert (got.row_lo, got.n_rows) == (want.row_lo, want.n_rows)
    for x in (sfm, full):
        np.testing.assert_array_equal(
            x.bounds.numpy(), packing.widen_u32(np.asarray(jsfm.bounds)))
        np.testing.assert_array_equal(
            x.F.numpy(), packing.widen_u32(np.asarray(jsfm.F)))


def _gather(flags: dict, n: int) -> np.ndarray:
    return torch.cat([flags[s] for s in sorted(flags)]).numpy()[:n]


def _reads_codes(seed, n_reads, length):
    rng = np.random.default_rng(seed)
    genome = "".join(rng.choice(list("ACGT"), size=400))
    reads = oracle.random_reads(rng, n_reads, length, mutate_from=genome)
    return dna.str_to_codes(oracle.ebwt_from_reads(reads))


def _random_codes(seed, n, p_term):
    return random_codes(np.random.default_rng(seed), n, p_term=p_term)


@pytest.mark.parametrize("codes,K,k_right", [
    (_reads_codes(11, 60, 45), 5, 8),
    # one block row per shard: borders spill across shard edges and the
    # wide nodes of the top levels span three shards and more
    (_random_codes(12, 900, 0.06), 2, 4),
])
def test_frontier_matches_jax_and_single_device(codes, K, k_right,
                                                monkeypatch):
    """thr_K, thr_R, minima and the counts (leaves, nodes, LCP values,
    minima) of the frontier-sharded traversal at S = 8 equal the JAX
    package's navigate_one_bwt_frontier_device and the port's single-device
    navigate_one_bwt; at S = 3 they equal them too."""
    pb = packing.pack_codes(codes)
    n = pb.n
    fm = fm_index.FMIndex.from_packed(pb, device="cpu")
    one = traverse.navigate_one_bwt(fm, K, k_right)
    jsfm = jshard.shard_fm(jpacking.pack_codes(codes), jshard.make_mesh(8))
    jK, jR, jM, (_, (st_l, st_n)) = \
        jfrontier.navigate_one_bwt_frontier_device(jsfm, K, k_right)
    want_stats = {"leaves": int(st_l[0]), "nodes": int(st_n[0]),
                  "lcp_values": 1 + int(st_l[1]) + int(st_n[1]),
                  "n_min": int(st_n[2])}
    for k, v in want_stats.items():
        assert one.stats[k] == v, k

    seen = {"spills": 0, "span": 0}
    real_shift, real_gather = mesh.Mesh.shift, frontier._gather_wide

    def shift(self, parts, step):
        seen["spills"] += sum(int(p.shape[0]) for p in parts.values())
        return real_shift(self, parts, step)

    def gather(sfm, wide):
        W = real_gather(sfm, wide)
        if W.shape[0]:
            own = (W[:, :2] >> 7) // sfm.rows if W.shape[1] == 3 else \
                (W[:, [0, 5]] >> 7) // sfm.rows
            seen["span"] = max(seen["span"], int((own[:, 1] - own[:, 0])
                                                 .max()) + 1)
        return W

    monkeypatch.setattr(mesh.Mesh, "shift", shift)
    monkeypatch.setattr(frontier, "_gather_wide", gather)
    for S in (8, 3):
        sfm = shard.shard_fm(pb, _mesh(S))
        tK, tR, tM, st = frontier.navigate_one_bwt_sharded(sfm, K, k_right)
        for name, got, jx, single in (("thr_K", tK, jK, one.thr_K),
                                      ("thr_R", tR, jR, one.thr_R),
                                      ("minima", tM, jM, one.minima)):
            g = _gather(got, n)
            np.testing.assert_array_equal(g, np.asarray(jx)[:n], name)
            np.testing.assert_array_equal(g, single.numpy(), name)
            assert not torch.cat(list(got.values()))[n:].any(), name
        for k, v in want_stats.items():
            assert st[k] == v, (S, k)
    if n < 1000:
        assert seen["spills"] > 0 and seen["span"] >= 3, seen


def _shard_flags(x: np.ndarray, L: int, S: int) -> dict:
    pad = np.zeros(L * S, x.dtype)
    pad[:len(x)] = x
    return {s: torch.from_numpy(pad[s * L:(s + 1) * L].copy())
            for s in range(S)}


def _jax_sharded(jm, x: np.ndarray, local_n: int):
    pad = np.zeros(local_n * jm.devices.size, bool)
    pad[:len(x)] = x
    return jax.device_put(pad, NamedSharding(jm, P(jshard.AXIS)))


@pytest.mark.parametrize("S,n", [(8, 3000), (3, 1500)])
def test_clusters_and_anchor_table_match_jax(S, n):
    """find_clusters_sharded, next_set_table_sharded and
    first_thr_position_sharded equal the JAX package's: runs that cross
    shard edges, minima inside runs, and a run still open at n-1 (never
    closed)."""
    rng = np.random.default_rng(n)
    thr_K = np.repeat(rng.random(n // 10) < 0.6, 10)[:n]
    thr_K[rng.random(n) < 0.1] ^= True
    thr_K[n - 7:] = True
    minima = rng.random(n) < 0.03
    minima[n - 7:] = False
    thr_R = rng.random(n) < 0.02
    L = -(-(n // 128 + 1) // S) * 128  # the port's partition
    jm = jshard.make_mesh(S)
    jL = -(-(n + 2) // S)  # the JAX pipeline's partition
    m = _mesh(S)

    cl = calling.find_clusters_sharded(
        m, _shard_flags(thr_K.astype(np.uint8), L, S),
        _shard_flags(minima.astype(np.uint8), L, S), local_n=L, n=n,
        mcov_out=3)
    jcl = jcalling.find_clusters_sharded(
        jm, _jax_sharded(jm, thr_K, jL), _jax_sharded(jm, minima, jL),
        local_n=jL, n=n, mcov_out=3)
    np.testing.assert_array_equal(cl.begins.numpy(), np.asarray(jcl.begins))
    np.testing.assert_array_equal(cl.ends.numpy(), np.asarray(jcl.ends))
    np.testing.assert_array_equal(cl.hist, np.asarray(jcl.hist))
    assert (cl.n_clusters, cl.clust_size_sum, cl.n_closed) == \
        (jcl.n_clusters, jcl.clust_size_sum, jcl.n_closed)
    assert cl.n_clusters > 10

    ns = calling.next_set_table_sharded(
        m, _shard_flags(thr_R.astype(np.uint8), L, S), local_n=L, n=n)
    jns = jcalling.next_set_table_sharded(jm, _jax_sharded(jm, thr_R, jL),
                                          local_n=jL, n=n)
    np.testing.assert_array_equal(_gather(ns, n), np.asarray(jns)[:n])

    pos, found = calling.first_thr_position_sharded(
        m, ns, cl.begins, cl.ends, local_n=L)
    jpos, jfound = jcalling.first_thr_position_sharded(
        jm, jns, jnp.asarray(jcl.begins), jnp.asarray(jcl.ends), local_n=jL)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(found.numpy(), np.asarray(jfound))
