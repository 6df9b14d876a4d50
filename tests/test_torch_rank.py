"""The port's rank / access / select (ebwt2indel_torch/ops/rank.py) against
the JAX package (ebwt2indel_tpu/ops/rank.py), its Pallas rank kernel run in
interpret mode, and the numpy oracles. Integer results must be equal
(tolerance 0). The CUDA kernel's own tests are in test_torch_cuda.py."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ebwt2indel_tpu.ops import packing as jpacking
from ebwt2indel_tpu.ops import rank as jrank
from ebwt2indel_tpu.ops import rank_pallas
from ebwt2indel_torch.models.fm_index import FMIndex
from ebwt2indel_torch.ops import packing, rank, rank_cuda
from tests import oracle
from tests.test_rank import random_codes


def _both(codes):
    """The same codes packed by both packages; the port's blocks on CPU."""
    jpb = jpacking.pack_codes(codes)
    pb = packing.pack_codes(codes)
    np.testing.assert_array_equal(pb.blocks, jpb.blocks)
    np.testing.assert_array_equal(pb.block_counts, jpb.block_counts)
    np.testing.assert_array_equal(pb.F, jpb.F)
    return jpb, torch.from_numpy(pb.blocks.view(np.int32)), \
        torch.from_numpy(pb.block_counts.astype(np.int64))


@pytest.mark.parametrize("n", [1, 127, 128, 129, 4096, 10000])
def test_parallel_rank_matches_jax_and_oracle(rng, n):
    codes = random_codes(rng, n)
    jpb, blocks, _ = _both(codes)
    qs = np.unique(np.concatenate(
        [rng.integers(0, n + 1, size=min(300, n + 1)), [0, n, n // 2]]))
    got = rank.parallel_rank(blocks, torch.from_numpy(qs)).numpy()
    want = np.asarray(jrank.parallel_rank(jnp.asarray(jpb.blocks),
                                          jnp.asarray(qs.astype(np.int32))))
    np.testing.assert_array_equal(got, want)
    for q, row in zip(qs[:60], got[:60]):
        np.testing.assert_array_equal(row, oracle.rank_oracle(codes, int(q)))


@pytest.mark.parametrize("n,q,p_term", [(5000, 512, 0.05), (3000, 100, 0.3)])
def test_parallel_rank_matches_pallas_interpret(rng, n, q, p_term):
    codes = random_codes(rng, n, p_term=p_term)
    jpb, blocks, _ = _both(codes)
    qs = rng.integers(0, n + 1, q)
    got = rank.parallel_rank(blocks, torch.from_numpy(qs)).numpy()
    want = np.asarray(rank_pallas.parallel_rank_pallas(
        jnp.asarray(jpb.blocks), jnp.asarray(qs.astype(np.int32)),
        interpret=True))
    np.testing.assert_array_equal(got, want)


def test_parallel_rank_any_shape_and_popcount(rng):
    codes = random_codes(rng, 2000, p_term=0.1)
    _, blocks, _ = _both(codes)
    qs = torch.from_numpy(rng.integers(0, 2001, size=(7, 6)))
    got = rank.parallel_rank(blocks, qs)
    assert got.shape == (7, 6, 4) and got.dtype == torch.int64
    flat = rank.parallel_rank(blocks, qs.reshape(-1)).reshape(7, 6, 4)
    assert torch.equal(got, flat)
    words = rng.integers(0, 2**32, size=1000, dtype=np.uint64)
    want = [bin(int(w)).count("1") for w in words]
    got_pc = rank.popcount32(torch.from_numpy(words.astype(np.int64)))
    assert got_pc.tolist() == want


def test_access_matches_jax(rng):
    n = 3000
    codes = random_codes(rng, n, p_term=0.2)
    jpb, blocks, _ = _both(codes)
    idx = np.arange(n)
    got = rank.access(blocks, torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, codes)
    want = np.asarray(jrank.access(jnp.asarray(jpb.blocks),
                                   jnp.asarray(idx.astype(np.int32))))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,p_term", [(5000, 0.05), (700, 0.4)])
def test_select_matches_jax_and_oracle(rng, n, p_term):
    codes = random_codes(rng, n, p_term=p_term)
    jpb, blocks, counts = _both(codes)
    rs, cs = [], []
    for c in range(4):
        tot = int((codes == c).sum())
        r = np.unique(np.concatenate(
            [rng.integers(0, tot, size=min(80, tot)), [0, tot - 1]]))
        rs.append(r)
        cs.append(np.full(len(r), c))
    r = np.concatenate(rs)
    c = np.concatenate(cs)
    got = rank.select(blocks, counts, torch.from_numpy(r),
                      torch.from_numpy(c)).numpy()
    want = np.asarray(jrank.select(
        jnp.asarray(jpb.blocks), jnp.asarray(jpb.block_counts),
        jnp.asarray(r.astype(np.int32)), jnp.asarray(c.astype(np.int32))))
    np.testing.assert_array_equal(got, want)
    for k in range(0, len(r), 7):
        assert got[k] == oracle.select_oracle(codes, int(r[k]), int(c[k]))


def test_parallel_rank_refuses_mixed_devices(rng):
    _, blocks, _ = _both(random_codes(rng, 300))
    with pytest.raises(ValueError):
        rank_cuda.rank_decode(blocks, torch.zeros(3, dtype=torch.int64))



def test_counters_past_2_31_widen_unsigned(rng):
    """The 32-bit block counters are uint32 patterns, and a counter at or
    past 2^31 is reachable below the packer's CAP (a merged input whose
    second collection passes 2^31 positions). Shifted by 2^31 + 12345, in
    block words 12-15 and in block_counts alike, the plain rank and select
    answer the unshifted question offset by the same constant, and select
    agrees with JAX's, which compares unsigned (rank.py:348)."""
    off = 2**31 + 12345
    n = 3000
    codes = random_codes(rng, n, p_term=0.1)
    pb = packing.pack_codes(codes)
    big = dataclasses.replace(
        pb, blocks=pb.blocks.copy(),
        block_counts=(pb.block_counts + np.int64(off)).astype(np.uint32)
        .view(np.int32))
    big.blocks[:, 12:16] += np.uint32(off)
    base = FMIndex.from_packed(pb, device="cpu")
    fm = FMIndex.from_packed(big, device="cpu")
    assert fm.block_counts.min() >= off

    qs = torch.arange(n + 1)
    assert torch.equal(rank.parallel_rank_plain(fm.blocks, qs),
                       rank.parallel_rank_plain(base.blocks, qs) + off)

    r = np.concatenate([np.arange(int((codes == c).sum())) for c in range(4)])
    c = np.concatenate([np.full(int((codes == c).sum()), c)
                        for c in range(4)])
    tr, tc = torch.from_numpy(r), torch.from_numpy(c)
    want = rank.select(base.blocks, base.block_counts, tr, tc)
    np.testing.assert_array_equal(want.numpy(),
                                  np.flatnonzero(codes < 4)[np.argsort(
                                      codes[codes < 4], kind="stable")])
    got = rank.select(fm.blocks, fm.block_counts, tr + off, tc)
    assert torch.equal(got, want)
    jgot = jrank.select(jnp.asarray(big.blocks),
                        jnp.asarray(big.block_counts),
                        jnp.asarray((r + off).astype(np.uint32)
                                    .view(np.int32)),
                        jnp.asarray(c.astype(np.int32)))
    np.testing.assert_array_equal(np.asarray(jgot), want.numpy())
