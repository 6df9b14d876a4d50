"""The port's traversal (ebwt2indel_torch/models/traverse.py) against the JAX
package's navigate_one_bwt on the identical index: thr_K, thr_R and minima
byte-equal, and the stats equal (max_pending depends on visit order and is
exempt)."""

import numpy as np
import pytest
import torch

from ebwt2indel_tpu.models import fm_index as jfm
from ebwt2indel_tpu.models import traverse as jtraverse
from ebwt2indel_tpu.ops import packing as jpacking
from ebwt2indel_tpu.utils import dna
from ebwt2indel_torch.models import fm_index as fm
from ebwt2indel_torch.models import traverse
from tests import oracle

_STATS = ("leaves", "nodes", "lcp_values", "n_min")


def _indexes(reads):
    codes = dna.str_to_codes(oracle.ebwt_from_reads(reads))
    jf = jfm.FMIndex.from_packed(jpacking.pack_codes(codes))
    tf = fm.FMIndex.from_numpy(np.asarray(jf.blocks),
                               np.asarray(jf.block_counts), np.asarray(jf.F),
                               jf.n, jf.term, device="cpu")
    return jf, tf, codes


def _assert_same(got, want):
    for name in ("thr_K", "thr_R", "minima"):
        g = getattr(got, name)
        assert g.dtype == torch.uint8
        np.testing.assert_array_equal(g.numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    for k in _STATS:
        assert got.stats[k] == want.stats[k], k


@pytest.mark.parametrize("seed,n_reads,length,K,k_right", [
    (1, 8, 20, 5, 8), (3, 40, 30, 5, 8), (5, 60, 45, 6, 4),
])
def test_navigate_one_bwt_matches_jax(seed, n_reads, length, K, k_right):
    rng = np.random.default_rng(seed)
    genome = "".join(rng.choice(list("ACGT"), size=200))
    reads = oracle.random_reads(rng, n_reads, length, mutate_from=genome)
    jf, tf, codes = _indexes(reads)
    got = traverse.navigate_one_bwt(tf, K, k_right)
    want = jtraverse.navigate_one_bwt(jf, K, k_right)
    _assert_same(got, want)
    # and the brute-force LCP oracle (position 0 is never written)
    lcp, _, _ = oracle.sa_of_bwt(codes)
    exp_K, exp_R = oracle.lcp_threshold_oracle(lcp, K, k_right)
    exp_K[0] = exp_R[0] = 0
    np.testing.assert_array_equal(got.thr_K.numpy(), exp_K)
    np.testing.assert_array_equal(got.thr_R.numpy(), exp_R)


def test_matches_jax_int32_per_field_leaf_path(rng, monkeypatch):
    """The JAX package's exact int32-per-field leaf layout, which it takes
    when leaves are deeper than its 16-bit lane (forced here as
    tests/test_traverse.py:60-90 forces it), is the layout the port always
    uses: the flags must agree with it too."""
    genome = "".join(rng.choice(list("ACGT"), size=200))
    reads = oracle.random_reads(rng, 20, 25, mutate_from=genome)
    jf, tf, _ = _indexes(reads)
    monkeypatch.setattr(jtraverse, "_LANE_SAFE_DEPTH", 0)
    want = jtraverse.navigate_one_bwt(jf, 5, 8)
    _assert_same(traverse.navigate_one_bwt(tf, 5, 8), want)


def test_small_chunks_give_the_same_flags(rng, monkeypatch):
    """Chunking is an execution detail: tiny chunks split the FIFO's pending
    tensors at every step and must not change a flag or a count."""
    genome = "".join(rng.choice(list("ACGT"), size=300))
    reads = oracle.random_reads(rng, 30, 40, mutate_from=genome)
    _, tf, _ = _indexes(reads)
    want = traverse.navigate_one_bwt(tf, 5, 8)
    monkeypatch.setattr(traverse, "CHUNK", 7)
    got = traverse.navigate_one_bwt(tf, 5, 8)
    for name in ("thr_K", "thr_R", "minima"):
        assert torch.equal(getattr(got, name), getattr(want, name))
    for k in _STATS:
        assert got.stats[k] == want.stats[k]
