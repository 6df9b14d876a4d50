"""The port's FM-index (ebwt2indel_torch/models/fm_index.py) against the JAX
package's, on the identical index: the port's FMIndex is made with
``from_numpy`` from the JAX FMIndex's own arrays. Integer results must be
equal (tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ebwt2indel_tpu.models import fm_index as jfm
from ebwt2indel_tpu.ops import packing as jpacking
from ebwt2indel_tpu.tools import ebwt as jebwt
from ebwt2indel_tpu.tools import simulate as jsim
from ebwt2indel_tpu.utils import dna
from ebwt2indel_torch.models import fm_index as fm
from ebwt2indel_torch.ops import packing


@pytest.fixture(scope="module")
def index():
    rng = np.random.default_rng(0xF1)
    genome = jsim.random_genome(rng, 3000)
    reads = jsim.sample_reads(rng, genome, 8, 60)
    codes = dna.str_to_codes(jebwt.ebwt_of_reads(reads))
    jf = jfm.FMIndex.from_packed(jpacking.pack_codes(codes))
    tf = fm.FMIndex.from_numpy(np.asarray(jf.blocks),
                               np.asarray(jf.block_counts), np.asarray(jf.F),
                               jf.n, jf.term, device="cpu")
    return jf, tf, codes


def _j(x):
    return jnp.asarray(np.asarray(x).astype(np.int32))


def test_from_numpy_matches_from_packed(index):
    jf, tf, codes = index
    pf = fm.FMIndex.from_packed(packing.pack_codes(codes), device="cpu")
    for a, b in ((tf.blocks, pf.blocks), (tf.block_counts, pf.block_counts),
                 (tf.F, pf.F)):
        assert torch.equal(a, b)
    assert (tf.n, tf.term) == (pf.n, pf.term) == (jf.n, jf.term)
    assert tf.blocks.dtype == torch.int32 and tf.F.dtype == torch.int64
    np.testing.assert_array_equal(tf.root().numpy(), jf.root())
    np.testing.assert_array_equal(tf.first_leaf().numpy(), jf.first_leaf())


def test_f_char_and_fl_match_jax(index):
    jf, tf, codes = index
    i = np.arange(tf.n)
    c = fm.f_char(tf, torch.from_numpy(i)).numpy()
    np.testing.assert_array_equal(c, np.asarray(jfm.f_char(jf, _j(i))))
    ok = i[c != 4]  # FL is defined where F(i) is not TERM
    got = fm.fl(tf, torch.from_numpy(ok)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jfm.fl(jf, _j(ok))))
    # FL is a bijection from the non-TERM F rows onto the non-TERM L rows
    np.testing.assert_array_equal(np.sort(got), np.flatnonzero(codes != 4))


def test_lf_range_matches_jax(index, rng):
    jf, tf, _ = index
    a = rng.integers(0, tf.n + 1, size=(2, 500))
    first, second = a.min(0), a.max(0)
    lo, hi = fm.lf_range(tf, torch.from_numpy(first), torch.from_numpy(second))
    jlo, jhi = jfm.lf_range(jf, _j(first), _j(second))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    nlo, nhi = jfm.lf_range_narrow(jf, _j(first), _j(second), budget=64)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(nlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(nhi))


def test_extend_node_matches_jax_narrow(index, rng):
    jf, tf, _ = index
    C = 400
    # sorted 6-boundary tuples: most inside a node-sized span, some wide
    base = rng.integers(0, tf.n, size=C)
    span = np.where(rng.random(C) < 0.2, 2000, 40)
    coords = np.sort(base[:, None] + rng.integers(0, span[:, None],
                                                  size=(C, 6)), axis=1)
    coords = np.minimum(coords, tf.n)
    nodes = np.concatenate([coords, rng.integers(0, 50, size=(C, 1))], 1)
    got = fm.extend_node(tf, torch.from_numpy(nodes)).numpy()
    want = np.asarray(jfm.extend_node_narrow(jf, _j(nodes), budget=64))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got,
                                  np.asarray(jfm.extend_node(jf, _j(nodes))))
    np.testing.assert_array_equal(
        fm.node_num_children(torch.from_numpy(got)).numpy(),
        np.asarray(jfm.node_num_children(jnp.asarray(want))))
