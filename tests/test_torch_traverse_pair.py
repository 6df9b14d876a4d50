"""The port's lockstep two-index traversal (ebwt2indel_torch/models/
traverse.py::navigate_two_bwts) against the JAX package's on the identical
pair of indexes: thr_K, thr_R, minima and da byte-equal, and the stats
equal (max_pending depends on visit order and is exempt). Tolerance 0."""

import numpy as np
import pytest
import torch

from ebwt2indel_tpu.models import fm_index as jfm
from ebwt2indel_tpu.models import traverse as jtraverse
from ebwt2indel_tpu.ops import packing as jpacking
from ebwt2indel_tpu.tools import ebwt as jebwt
from ebwt2indel_tpu.tools import simulate as jsim
from ebwt2indel_tpu.utils import dna
from ebwt2indel_torch.models import fm_index as fm
from ebwt2indel_torch.models import traverse
from tests.test_parity import _make_pair_inputs

_STATS = ("leaves", "nodes", "lcp_values", "n_min", "da_values")
_FLAGS = ("thr_K", "thr_R", "minima", "da")


def _index_pair(reads1, reads2):
    out = []
    for reads in (reads1, reads2):
        codes = dna.str_to_codes(jebwt.ebwt_of_reads(reads))
        jf = jfm.FMIndex.from_packed(jpacking.pack_codes(codes))
        tf = fm.FMIndex.from_numpy(np.asarray(jf.blocks),
                                   np.asarray(jf.block_counts),
                                   np.asarray(jf.F), jf.n, jf.term,
                                   device="cpu")
        out.append((jf, tf))
    return out


def _deep_reads():
    """Reads longer than the JAX package's tri-lane safe depth (480), so its
    navigate_two_bwts reruns the leaf-pair phase in another layout."""
    rng = np.random.default_rng(0xD1)
    genome = jsim.random_genome(rng, 1500)
    hap2, _ = jsim.plant_variants(rng, genome, snp_rate=0.004,
                                  indel_rate=0.001)
    return (jsim.sample_reads(rng, genome, 3, 520),
            jsim.sample_reads(rng, hap2, 3, 520))


@pytest.fixture(scope="module", params=["parity", "deep"])
def pair(request, tmp_path_factory):
    if request.param == "parity":
        reads = _make_pair_inputs(None, np.random.default_rng(0xEB37))
    else:
        reads = _deep_reads()
    (jf1, tf1), (jf2, tf2) = _index_pair(*reads)
    # the JAX queue pays a whole chunk per step on the CPU, and the deep
    # input takes ~520 steps; its chunk size changes no result
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtraverse, "CHUNK", 4096)
        want = jtraverse.navigate_two_bwts(jf1, jf2, 20, 30)
    return request.param, (tf1, tf2), want


def test_navigate_two_bwts_matches_jax(pair):
    name, (tf1, tf2), want = pair
    got = traverse.navigate_two_bwts(tf1, tf2, 20, 30)
    for f in _FLAGS:
        g = getattr(got, f)
        assert g.dtype == torch.uint8 and g.shape == (tf1.n + tf2.n,)
        np.testing.assert_array_equal(g.numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    for k in _STATS:
        assert got.stats[k] == want.stats[k], k
    if name == "deep":
        assert got.stats["da_values"] > 0
        # the input does reach the depth where the JAX package changes its
        # leaf-pair layout
        assert max(len(r) for r in _deep_reads()[0]) > \
            jtraverse._LANE3_SAFE_DEPTH
    # the DA marks exactly the second collection's share of the positions
    assert int(got.da.sum()) == tf2.n


def test_small_chunks_give_the_same_pair_flags(pair, monkeypatch):
    """Chunking is an execution detail: tiny chunks split the FIFO's pending
    tensors at every step and change no flag and no count."""
    _, (tf1, tf2), want = pair
    monkeypatch.setattr(traverse, "CHUNK", 61)
    got = traverse.navigate_two_bwts(tf1, tf2, 20, 30)
    for f in _FLAGS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    for k in _STATS:
        assert got.stats[k] == want.stats[k], k
