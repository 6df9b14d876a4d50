"""Binding of the CUDA next-set kernel (``csrc/next_set.cu``), built with
the port's other kernels into one library by ``ops/kernels.py``.

``next_set`` is the wrapper: it checks its flags, allocates the int64 table
and the kernel's scratch (8 B per tile of 4,096 positions), launches on
PyTorch's current stream, raises if a launch failed, and adds one to
``LAUNCHES["next_set"]`` per table built.
"""

from __future__ import annotations

import torch

from . import kernels

LAUNCHES = {"next_set": 0}
_FLAG_DTYPES = (torch.uint8, torch.bool)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def next_set(flags: torch.Tensor, base: int = 0,
             n: int | None = None) -> torch.Tensor:
    """``scan.next_set`` on the card: (len,) byte flags -> (len,) int64."""
    if flags.device.type != "cuda":
        raise ValueError(f"next_set: flags on {flags.device}; they must be "
                         "on a CUDA device")
    if flags.dtype not in _FLAG_DTYPES or flags.dim() != 1 or \
            not flags.is_contiguous():
        raise ValueError("next_set: flags must be a contiguous 1-D uint8 "
                         f"or bool tensor, got {flags.dtype} "
                         f"{tuple(flags.shape)}")
    length = flags.shape[0]
    base = int(base)
    n = base + length if n is None else int(n)
    if base < 0 or n < 0:
        raise ValueError(f"next_set: base {base} and n {n} must be >= 0")
    out = torch.empty(length, dtype=torch.int64, device=flags.device)
    if length == 0:
        return out
    lib = kernels.load()
    scratch = torch.empty(lib.next_set_scratch_len(length),
                          dtype=torch.int64, device=flags.device)
    with torch.cuda.device(flags.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.next_set(flags.data_ptr(), length, base, n,
                           scratch.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"next_set: kernel launch failed "
                           f"(cudaError {err})")
    LAUNCHES["next_set"] += 1
    return out
