"""The port's document-array rank structure against the JAX package's:
``pack_bitvector`` (host), ``bits.bv_build`` (device), ``rank.bv_rank1`` and
``rank.bv_get``, on random bit vectors, at every position 0..n. Integer
results must be equal (tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ebwt2indel_tpu.ops import bits as jbits
from ebwt2indel_tpu.ops import packing as jpacking
from ebwt2indel_tpu.ops import rank as jrank
from ebwt2indel_torch.ops import bits, packing, rank

SIZES = [1, 127, 128, 129, 100_003]


def _bits(n):
    rng = np.random.default_rng(n)
    return (rng.random(n) < 0.4).astype(np.uint8)


@pytest.mark.parametrize("n", SIZES)
def test_pack_bitvector_matches_jax(n):
    b = _bits(n)
    words, counts = packing.pack_bitvector(b)
    jwords, jcounts = jpacking.pack_bitvector(b)
    assert words.dtype == np.uint32 and counts.dtype == np.int32
    np.testing.assert_array_equal(words, jwords)
    np.testing.assert_array_equal(counts, jcounts)


@pytest.mark.parametrize("n", SIZES)
def test_bv_build_matches_jax_and_pack_bitvector(n):
    b = _bits(n)
    words, counts = bits.bv_build(torch.from_numpy(b))
    assert words.dtype == torch.int32 and counts.dtype == torch.int64
    pw, pc = packing.pack_bitvector(b)
    np.testing.assert_array_equal(words.numpy(), pw.view(np.int32))
    np.testing.assert_array_equal(counts.numpy(), pc)
    # JAX's bv_build has ceil(n / 128) blocks; the port keeps one more, so
    # that a rank at n is always in range
    jw, jc = (np.asarray(x) for x in jbits.bv_build(jnp.asarray(b)))
    np.testing.assert_array_equal(words.numpy()[:jw.size], jw.view(np.int32))
    np.testing.assert_array_equal(counts.numpy()[:jc.size], jc)
    assert not words.numpy()[jw.size:].any()


def _structures(b):
    """(name, port (words, counts), JAX (words, counts)) for the same
    structure in both packages: pack_bitvector's and JAX bv_build's."""
    pw, pc = jpacking.pack_bitvector(b)
    jw, jc = (np.asarray(x) for x in jbits.bv_build(jnp.asarray(b)))
    for name, (w, c) in (("pack_bitvector", (pw, pc)), ("bv_build", (jw, jc))):
        yield name, bits.from_numpy(w, c, device="cpu"), (jnp.asarray(w),
                                                          jnp.asarray(c))


@pytest.mark.parametrize("n", SIZES)
def test_bv_rank1_and_bv_get_match_jax(n):
    b = _bits(n)
    i = np.arange(n + 1)
    truth = np.concatenate([[0], np.cumsum(b, dtype=np.int64)])
    ti, ji = torch.from_numpy(i), jnp.asarray(i.astype(np.int32))
    for name, (w, c), (jw, jc) in _structures(b):
        got = rank.bv_rank1(w, c, ti)
        assert got.dtype == torch.int64, name
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jrank.bv_rank1(jw, jc, ji)),
                                      err_msg=name)
        got_bit = rank.bv_get(w, ti)
        np.testing.assert_array_equal(got_bit.numpy(),
                                      np.asarray(jrank.bv_get(jw, ji)),
                                      err_msg=name)
        # JAX bv_build's structure ends at ceil(n / 128) blocks, so only
        # pack_bitvector's answers position n when n is a block multiple
        ok = i < n if name == "bv_build" and n % 128 == 0 else i <= n
        np.testing.assert_array_equal(got.numpy()[ok], truth[ok],
                                      err_msg=name)
        np.testing.assert_array_equal(got_bit.numpy()[:n], b, err_msg=name)
    # the port's own device structure answers every position 0..n
    w, c = bits.bv_build(torch.from_numpy(b))
    np.testing.assert_array_equal(rank.bv_rank1(w, c, ti).numpy(), truth)
    np.testing.assert_array_equal(rank.bv_get(w, ti[:n]).numpy(), b)


def test_read_da_file_and_from_numpy(tmp_path):
    p = tmp_path / "x.da"
    p.write_text("0110100111")
    got = packing.read_da_file(str(p), 8)
    np.testing.assert_array_equal(got, jpacking.read_da_file(str(p), 8))
    assert got.tolist() == [0, 1, 1, 0, 1, 0, 0, 1]
    with pytest.raises(ValueError):
        bits.from_numpy(np.zeros((2, 4), np.uint32), np.zeros(2), "cpu")


def test_from_numpy_counts_past_2_31_widen_unsigned():
    """bits.from_numpy reads 32-bit counts as uint32 patterns: counts
    shifted past 2^31 rank as the unshifted ones offset by the shift."""
    off = 2**31 + 12345
    b = _bits(1000)
    words, counts = packing.pack_bitvector(b)
    big = (counts + np.int64(off)).astype(np.uint32).view(np.int32)
    w, c = bits.from_numpy(words, big, device="cpu")
    assert c.dtype == torch.int64 and c.min() >= off
    i = torch.arange(1001)
    want = rank.bv_rank1(*bits.from_numpy(words, counts, device="cpu"), i)
    assert torch.equal(rank.bv_rank1(w, c, i), want + off)
