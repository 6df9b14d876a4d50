"""The next-set table of a flag vector, the right-context anchor of calling
(counterpart of the ``jax.lax.cummin(reverse=True)`` scans of
``ebwt2indel_tpu/models/call.py`` and ``parallel/calling.py``):

    next_set(flags, base, n)[i] = base + (the smallest j >= i with
        flags[j] != 0 and base + j < n), or n where there is none.

The dense route's table is ``next_set(thr_R)`` (base 0, n = len); a shard of
the position mesh passes its first global position as ``base``; the packed
route runs it over its blocks' "has a set bit" flags.

``next_set`` dispatches on the device of its flags: a CUDA tensor goes to
the hand-written kernel (``ops/scan_cuda.py``, ``csrc/next_set.cu``) and a
CPU tensor to ``next_set_plain``, the kernel's plain PyTorch version. There
is no fallback between them. Positions are int64 throughout.
"""

from __future__ import annotations

import torch


def next_set_plain(flags: torch.Tensor, base: int = 0,
                   n: int | None = None) -> torch.Tensor:
    """The plain version: a cumulative minimum over the flipped vector of
    set positions."""
    n = base + flags.shape[0] if n is None else n
    pos = torch.arange(base, base + flags.shape[0], dtype=torch.int64,
                       device=flags.device)
    idx = torch.where((flags != 0) & (pos < n), pos, n)
    del pos
    return torch.cummin(idx.flip(0), dim=0).values.flip(0)


def next_set(flags: torch.Tensor, base: int = 0,
             n: int | None = None) -> torch.Tensor:
    """The (len,) int64 next-set table of the 1-D byte flags ``flags``
    (uint8 or bool); ``n`` defaults to ``base + len``. A CUDA tensor
    launches the kernel (or raises); a CPU tensor runs the plain version."""
    if flags.device.type == "cuda":
        from . import scan_cuda

        return scan_cuda.next_set(flags, base, n)
    if flags.device.type == "cpu":
        return next_set_plain(flags, base, n)
    raise ValueError(f"next_set: flags on {flags.device}")
