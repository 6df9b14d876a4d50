"""Binding of the CUDA rank kernel (``csrc/rank_decode.cu``), built with
the port's other kernels into one library by ``ops/kernels.py``.

``rank_decode`` is the wrapper: it checks its tensors, allocates the output,
launches on PyTorch's current stream, raises if the launch failed, and adds
one to ``LAUNCHES["rank_decode"]`` and its query count to
``QUERIES["rank_decode"]``.
"""

from __future__ import annotations

import torch

from . import kernels

LAUNCHES = {"rank_decode": 0}
QUERIES = {"rank_decode": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = QUERIES[k] = 0


def rank_decode(blocks: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """parallel_rank on the card: int32 (n_blocks, 16) blocks and int64
    positions of any shape -> int64 [..., 4] counts of A,C,G,T."""
    if blocks.device.type != "cuda" or i.device != blocks.device:
        raise ValueError(f"rank_decode: blocks on {blocks.device} and "
                         f"positions on {i.device}; both must be on one "
                         "CUDA device")
    if blocks.dtype != torch.int32 or blocks.dim() != 2 or \
            blocks.shape[1] != 16 or not blocks.is_contiguous():
        raise ValueError("rank_decode: blocks must be a contiguous int32 "
                         f"(n_blocks, 16) tensor, got {blocks.dtype} "
                         f"{tuple(blocks.shape)}")
    if blocks.data_ptr() % 16:
        raise ValueError("rank_decode: blocks must be 16-byte aligned")
    if i.dtype != torch.int64:
        raise ValueError(f"rank_decode: positions must be int64, "
                         f"got {i.dtype}")
    shape = i.shape
    pos = i.reshape(-1)
    if not pos.is_contiguous():
        pos = pos.contiguous()
    out = torch.empty((pos.shape[0], 4), dtype=torch.int64,
                      device=blocks.device)
    if pos.shape[0] == 0:
        return out.reshape(shape + (4,))
    lib = kernels.load()
    with torch.cuda.device(blocks.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rank_decode(blocks.data_ptr(), blocks.shape[0],
                              pos.data_ptr(), out.data_ptr(), pos.shape[0],
                              stream)
    if err != 0:
        raise RuntimeError(f"rank_decode: kernel launch failed "
                           f"(cudaError {err})")
    LAUNCHES["rank_decode"] += 1
    QUERIES["rank_decode"] += pos.shape[0]
    return out.reshape(shape + (4,))
