"""The port's calling walks (ebwt2indel_torch/models/call.py) against the JAX
package's (ebwt2indel_tpu/models/call.py) on the identical index. Integer
results must be equal (tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ebwt2indel_tpu.models import call as jcall
from ebwt2indel_tpu.models import fm_index as jfm
from ebwt2indel_tpu.ops import packing as jpacking
from ebwt2indel_tpu.tools import ebwt as jebwt
from ebwt2indel_tpu.tools import simulate as jsim
from ebwt2indel_tpu.utils import dna
from ebwt2indel_torch.models import call
from ebwt2indel_torch.models import fm_index as fm
from ebwt2indel_torch.ops import bits, scan, scan_cuda


@pytest.fixture(scope="module")
def index():
    rng = np.random.default_rng(0xCA11)
    genome = jsim.random_genome(rng, 2500)
    hap2, _ = jsim.plant_variants(rng, genome, snp_rate=0.01,
                                  indel_rate=0.002)
    reads = jsim.sample_reads(rng, genome, 5, 60) + \
        jsim.sample_reads(rng, hap2, 5, 60)
    codes = dna.str_to_codes(jebwt.ebwt_of_reads(reads))
    jf = jfm.FMIndex.from_packed(jpacking.pack_codes(codes))
    tf = fm.FMIndex.from_numpy(np.asarray(jf.blocks),
                               np.asarray(jf.block_counts), np.asarray(jf.F),
                               jf.n, jf.term, device="cpu")
    return jf, tf


def _ranges(rng, n, B, width=12):
    b = rng.integers(0, n - width, size=B)
    return b, b + rng.integers(1, width, size=B)


def _j(x):
    return jnp.asarray(np.asarray(x).astype(np.int32))


def _t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.int64))


def test_range_counts_matches_jax(index, rng):
    jf, tf = index
    b, e = _ranges(rng, tf.n, 600, width=300)
    quirk, pure = call.Walks.of(tf).range_counts(_t(b), _t(e))
    jq, jp = jcall.range_counts(jf, _j(b), _j(e))
    np.testing.assert_array_equal(quirk.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(pure.numpy(), np.asarray(jp))
    # TERM counts as A: the quirk counts sum to the range length
    np.testing.assert_array_equal(quirk.sum(1).numpy(), e - b)


def test_consensus_with_ties_matches_jax(index, rng):
    jf, tf = index
    b, e = _ranges(rng, tf.n, 800)
    # the data must hold argmax ties: two characters share the top count
    lo, hi = fm.lf_range(tf, _t(b), _t(e))
    cnt = (hi - lo).sort(dim=1, descending=True).values
    assert bool(((cnt[:, 0] == cnt[:, 1]) & (cnt[:, 0] > 0)).any())
    for k_left in (2, 9):
        ctx, sup, full = call.Walks.of(tf).consensus(_t(b), _t(e), k_left)
        jctx, jsup, jfull = jcall.extract_consensus_batch(
            jf, _j(b), _j(e), k_left=k_left)
        np.testing.assert_array_equal(ctx.numpy(), np.asarray(jctx))
        np.testing.assert_array_equal(sup.numpy(), np.asarray(jsup))
        np.testing.assert_array_equal(full.numpy(), np.asarray(jfull))
    assert ctx.dtype == torch.int8 and ctx.shape == (800, 4, 9)


def test_extract_dna_matches_jax(index, rng):
    jf, tf = index
    starts = rng.integers(0, tf.n, size=700)
    active = rng.random(700) < 0.8
    seq, ln = call.Walks.of(tf).dna(_t(starts), torch.from_numpy(active),
                                    25)
    jseq, jln = jcall.extract_dna_batch(jf, _j(starts), jnp.asarray(active),
                                        k_right=25)
    np.testing.assert_array_equal(seq.numpy(), np.asarray(jseq))
    np.testing.assert_array_equal(ln.numpy(), np.asarray(jln))
    assert (ln.numpy()[~active] == 0).all() and ln.numpy().max() > 0


@pytest.mark.parametrize("p", [0.0, 0.02, 0.5])
def test_next_set_table_and_anchor_match_jax(rng, p):
    n = 3000
    thr_R = (rng.random(n) < p).astype(np.uint8)
    got = scan.next_set(torch.from_numpy(thr_R))
    want = np.asarray(jcall.next_set_table(jnp.asarray(thr_R)))
    np.testing.assert_array_equal(got.numpy(), want)
    b = rng.integers(0, n - 50, size=400)
    e = b + rng.integers(1, 50, size=400)
    pos, found = call.first_thr_position_device(got, _t(b), _t(e))
    jpos, jfound = jcall.first_thr_position_device(jnp.asarray(want), _j(b),
                                                   _j(e))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(found.numpy(), np.asarray(jfound))
    hpos, hfound = jcall.first_thr_position(thr_R, b, e)
    np.testing.assert_array_equal(pos.numpy(), hpos)
    np.testing.assert_array_equal(found.numpy(), hfound)


_TILE = 4096  # positions per block of csrc/next_set.cu


def _next_set_brute(flags, base, n):
    """out[i] = base + the smallest j >= i with flags[j] set and
    base + j < n, else n: one position at a time from the right."""
    out = np.empty(len(flags), np.int64)
    nxt = n
    for i in range(len(flags) - 1, -1, -1):
        if flags[i] and base + i < n:
            nxt = base + i
        out[i] = nxt
    return out


def _flags(kind, size, rng):
    if kind == "random":
        return (rng.random(size) < 0.3).astype(np.uint8)
    f = np.zeros(size, np.uint8)
    if kind == "all":
        f[:] = 1
    elif kind == "first":
        f[0] = 1
    elif kind == "last":
        f[-1] = 1
    return f


# (flags, size, base, n): n None is base + size; sizes around one tile
_NEXT_SET_CASES = {
    "n1_set": ("all", 1, 0, None),
    "n1_unset": ("none", 1, 0, None),
    "all_zero": ("none", 1000, 0, None),
    "all_set": ("all", 1000, 0, None),
    "only_first": ("first", 1000, 0, None),
    "only_last": ("last", 1000, 0, None),
    "tile_minus_1": ("random", _TILE - 1, 0, None),
    "tile": ("random", _TILE, 0, None),
    "tile_plus_1": ("random", _TILE + 1, 0, None),
    "mesh_shard": ("random", 1000, 3000, 3500),
    "mesh_shard_past_n": ("all", 1000, 3000, 2000),
}


@pytest.mark.parametrize("case", sorted(_NEXT_SET_CASES) + ["packed_blocks"])
def test_next_set_plain_matches_brute_force(rng, case):
    """The next-set op's plain version (the CPU path of ``scan.next_set``)
    against a loop over positions: edge sizes, the mesh form (``base``,
    and ``n`` below ``base + len``) and the packed route's block table."""
    if case == "packed_blocks":
        # blocks with several set bits, with none, and the last position
        n = 5 * 128 + 77
        f = np.zeros(n, np.uint8)
        f[[130, 131, 400, n - 1]] = 1
        want = _next_set_brute(f, 0, n)
        nb = n // 128 + 1
        padded = torch.zeros(nb * 128, dtype=torch.uint8)
        padded[:n] = torch.from_numpy(f)
        words, T = call._anchor_from_words(bits.pack_bits(padded), n)
        want_T = [int(want[128 * b]) if 128 * b < n else n
                  for b in range(nb)] + [n]
        assert T.dtype == torch.int64 and T.tolist() == want_T
        return
    kind, size, base, n = _NEXT_SET_CASES[case]
    f = _flags(kind, size, rng)
    n = base + size if n is None else n
    want = _next_set_brute(f, base, n)
    for dtype in (torch.uint8, torch.bool):
        got = scan.next_set(torch.from_numpy(f).to(dtype), base, n)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)
    if base == 0 and n == size:
        np.testing.assert_array_equal(
            scan.next_set(torch.from_numpy(f)).numpy(), want)


def test_next_set_refuses_other_devices():
    """The CUDA wrapper refuses a CPU tensor (the CPU takes the plain
    version through ``scan.next_set``, never the kernel), and
    ``scan.next_set`` a device it has no path for."""
    with pytest.raises(ValueError):
        scan_cuda.next_set(torch.zeros(3, dtype=torch.uint8))
    with pytest.raises(ValueError):
        scan.next_set(torch.zeros(3, dtype=torch.uint8, device="meta"))
