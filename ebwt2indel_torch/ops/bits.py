"""Bit-packed 0/1 vectors on the device (counterpart of
``ebwt2indel_tpu/ops/bits.py``, plus the word packers of
``ebwt2indel_tpu/models/traverse.py``, ``_pack_bits_u32`` and
``_unpack_bits_u32``).

* ``pack_bits`` / ``unpack_bits``: (L,) 0/1 <-> (ceil(L/32),) words.
* ``bv_build`` / ``bv_counts``: the rank-1 structure over a 0/1 vector.
  Mode 2 builds it from the document array that its traversal produces (or,
  on the bit-packed route, adds the counts to the words the traversal
  already packed), and ``ops.rank.bv_rank1`` / ``bv_get`` query it.

Layout, as ``ops/packing.py::pack_bitvector`` makes it on the host: FLAT
words, four 32-bit words per 128-position block, LSB-first, held as int32
storage of the uint32 bit patterns; and int64 exclusive per-block counts.
There are n // 128 + 1 blocks, so a rank at position n stays in range.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import device as device_mod
from . import packing
from .rank import popcount32

BLOCK = 128
WPB = 4  # words per block
_LOW32 = 0xFFFFFFFF


def _bit_weights(device) -> torch.Tensor:
    """(32,) int32 weights 2^j as int32 bit patterns (2^31 is INT32_MIN)."""
    w = torch.ones(32, dtype=torch.int64, device=device) << torch.arange(
        32, dtype=torch.int64, device=device)
    return (w - ((w >> 31) << 32)).to(torch.int32)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(L,) 0/1 tensor -> (ceil(L/32),) int32 words, position p at bit
    p & 31 of word p >> 5, pad bits 0. Each word is a sum of distinct
    powers of two, so the int32 sum never carries into another bit."""
    L = bits.shape[0]
    pad = -L % 32
    b = bits.to(torch.int32)
    if pad:
        b = torch.cat([b, b.new_zeros(pad)])
    return (b.view(-1, 32) * _bit_weights(bits.device)).sum(
        1, dtype=torch.int32)


def unpack_bits(words: torch.Tensor, L: int) -> torch.Tensor:
    """Inverse of ``pack_bits``: (W,) int32 or int64 words -> (L,) uint8
    0/1, L <= 32 * W. A right shift then ``& 1`` reads bit j whatever the
    sign of the word."""
    sh = torch.arange(32, dtype=words.dtype, device=words.device)
    return ((words[:, None] >> sh) & 1).to(torch.uint8).view(-1)[:L]


def bv_build(bits: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(n,) 0/1 uint8 tensor -> (words (nb*4,) int32, counts (nb,) int64)
    on its device."""
    n = bits.shape[0]
    nb = n // BLOCK + 1
    padded = torch.zeros(nb * BLOCK, dtype=torch.int64, device=bits.device)
    padded[:n] = bits != 0
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = (padded.view(-1, 32) << shifts).sum(1)  # in [0, 2^32)
    words = words - ((words >> 31) << 32)  # the int32 bit pattern
    per_block = padded.view(nb, BLOCK).sum(1)
    counts = torch.cumsum(per_block, 0) - per_block
    return words.to(torch.int32), counts


def bv_counts(words: torch.Tensor) -> torch.Tensor:
    """Exclusive per-block counts (int64) of words already in the
    ``bv_build`` layout (ebwt2indel_tpu/ops/bits.py:66): the bit-packed
    route's document array arrives as words and needs only these."""
    pc = popcount32(words.to(torch.int64) & _LOW32)
    per_block = pc.view(-1, WPB).sum(1)
    return torch.cumsum(per_block, 0) - per_block


def from_numpy(words, counts, device="cuda") -> tuple[torch.Tensor,
                                                      torch.Tensor]:
    """Upload a (words, counts) pair given as numpy: ``pack_bitvector``'s,
    or a JAX ``bv_build``'s (``np.asarray`` of each), so both packages can
    query the identical structure. 32-bit counts are uint32 bit patterns
    and widen unsigned, so a count past 2^31 stays positive."""
    dev = device_mod.resolve(device)
    words = np.asarray(words)
    if words.dtype not in (np.uint32, np.int32) or words.ndim != 1:
        raise ValueError("words must be a flat array of 32-bit words")
    # torch.tensor copies: the arrays may be read-only views (JAX's)
    return (torch.tensor(words.view(np.int32), device=dev),
            torch.tensor(packing.widen_u32(counts), device=dev))
