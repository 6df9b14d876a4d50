"""The rank-1 structure over a 0/1 vector on the device (counterpart of
``ebwt2indel_tpu/ops/bits.py::bv_build``): mode 2 builds it from the document
array that its traversal produces, and ``ops.rank.bv_rank1`` / ``bv_get``
query it.

Layout, as ``ops/packing.py::pack_bitvector`` makes it on the host: FLAT
words, four 32-bit words per 128-position block, LSB-first, held as int32
storage of the uint32 bit patterns; and int64 exclusive per-block counts.
There are n // 128 + 1 blocks, so a rank at position n stays in range.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import device as device_mod

BLOCK = 128


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


def from_numpy(words, counts, device="cuda") -> tuple[torch.Tensor,
                                                      torch.Tensor]:
    """Upload a (words, counts) pair given as numpy: ``pack_bitvector``'s,
    or a JAX ``bv_build``'s (``np.asarray`` of each), so both packages can
    query the identical structure."""
    dev = device_mod.resolve(device)
    words = np.asarray(words)
    if words.dtype not in (np.uint32, np.int32) or words.ndim != 1:
        raise ValueError("words must be a flat array of 32-bit words")
    # torch.tensor copies: the arrays may be read-only views (JAX's)
    return (torch.tensor(words.view(np.int32), device=dev),
            torch.tensor(np.asarray(counts), dtype=torch.int64, device=dev))
