"""Binding of the CUDA node step (``csrc/node_step.cu``), built with the
port's other kernels into one library by ``ops/kernels.py``.

``node_step`` is the wrapper: it checks its tensors before it loads the
library, allocates the kernel's scratch (one int64 a block of 256 nodes and
character, and the total), launches the count and the scan on PyTorch's
current stream, reads the number of children kept (the step's one wait on
the card), allocates the children at that size, launches the writer, raises
if a launch failed, and adds one to ``LAUNCHES["node_step"]`` per step.
"""

from __future__ import annotations

import contextlib

import torch

from . import kernels

LAUNCHES = {"node_step": 0}
WIDTH = 7  # a node row: the 6 boundaries and the depth


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(blocks, F, chunk, flags, stats) -> None:
    if chunk.dtype != torch.int64 or chunk.dim() != 2 or \
            chunk.shape[1] != WIDTH:
        raise ValueError(f"node_step: the chunk must be int64 (C, {WIDTH}), "
                         f"got {chunk.dtype} {tuple(chunk.shape)}")
    if not chunk.is_contiguous():
        raise ValueError("node_step: the chunk must be contiguous")
    if flags.dtype != torch.uint8 or flags.dim() != 1 or \
            not flags.is_contiguous():
        raise ValueError("node_step: flags must be a contiguous (n,) uint8 "
                         f"vector, got {flags.dtype} {tuple(flags.shape)}")
    if stats.dtype != torch.int64 or stats.dim() != 1 or \
            stats.shape[0] < 3 or not stats.is_contiguous():
        raise ValueError("node_step: stats must be a contiguous int64 vector "
                         f"of >= 3 counts, got {stats.dtype} "
                         f"{tuple(stats.shape)}")
    if F.dtype != torch.int64 or tuple(F.shape) != (4,) or \
            not F.is_contiguous():
        raise ValueError(f"node_step: F must be int64 (4,), got {F.dtype} "
                         f"{tuple(F.shape)}")
    if blocks.dtype != torch.int32 or blocks.dim() != 2 or \
            blocks.shape[1] != 16 or not blocks.is_contiguous():
        raise ValueError("node_step: blocks must be a contiguous int32 "
                         f"(n_blocks, 16) tensor, got {blocks.dtype} "
                         f"{tuple(blocks.shape)}")
    dev = chunk.device
    if dev.type != "cuda" or any(t.device != dev for t in (blocks, F, flags,
                                                           stats)):
        raise ValueError("node_step: blocks, F, the chunk, flags and stats "
                         f"must all lie on one CUDA device, the chunk on "
                         f"{dev}")
    if blocks.data_ptr() % 16:
        raise ValueError("node_step: blocks must be 16-byte aligned")


def node_step(blocks: torch.Tensor, F: torch.Tensor, chunk: torch.Tensor,
              flags: torch.Tensor, stats: torch.Tensor, K: int, k_right: int,
              wait=contextlib.nullcontext) -> torch.Tensor:
    """``traverse._node_body_plain`` on the card: stores the border flags of
    the (C, 7) nodes of ``chunk`` into ``flags``, adds the nodes, LCP values
    and minima to ``stats[0:3]``, and returns the kept children (M, 7) in
    its char-major order. ``wait()`` is entered around the read of M."""
    _check(blocks, F, chunk, flags, stats)
    dev, C = chunk.device, chunk.shape[0]
    if C == 0:
        return torch.empty((0, WIDTH), dtype=torch.int64, device=dev)
    lib = kernels.load()
    scratch = torch.empty(lib.node_step_scratch_len(C), dtype=torch.int64,
                          device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.node_step_count(blocks.data_ptr(), blocks.shape[0],
                                  chunk.data_ptr(), C, flags.data_ptr(),
                                  flags.shape[0], stats.data_ptr(), K,
                                  k_right, scratch.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"node_step: count launch failed "
                               f"(cudaError {err})")
        with wait():
            kept = int(scratch[-1])
        out = torch.empty((kept, WIDTH), dtype=torch.int64, device=dev)
        if kept:
            err = lib.node_step_write(blocks.data_ptr(), blocks.shape[0],
                                      F.data_ptr(), chunk.data_ptr(), C,
                                      scratch.data_ptr(), out.data_ptr(),
                                      stream)
            if err != 0:
                raise RuntimeError(f"node_step: write launch failed "
                                   f"(cudaError {err})")
    LAUNCHES["node_step"] += 1
    return out
