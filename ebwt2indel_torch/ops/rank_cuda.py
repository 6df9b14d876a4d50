"""Binding of the CUDA rank kernel (``csrc/rank_decode.cu``).

The kernel is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface under ``build/kernels/`` (gitignored) at first use,
keyed by a hash of its source, and loaded with ctypes. Nothing is built or
imported from CUDA when this module is imported.

``rank_decode`` is the wrapper: it checks its tensors, allocates the output,
launches on PyTorch's current stream, raises if the launch failed, and adds
one to ``LAUNCHES["rank_decode"]`` and its query count to
``QUERIES["rank_decode"]``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "rank_decode.cu"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

LAUNCHES = {"rank_decode": 0}
QUERIES = {"rank_decode": 0}

_lock = threading.Lock()
_lib = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = QUERIES[k] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("rank_decode: nvcc not found (needs the CUDA toolkit)")


def build() -> Path:
    """Compile the kernel library if this source has not been built yet;
    returns its path."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    out = BUILD_DIR / f"librank_decode_{digest}.so"
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE}:\n{r.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.rank_decode.restype = ctypes.c_int
            lib.rank_decode.argtypes = [
                ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
            ]
            _lib = lib
        return _lib


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
    lib = _load()
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
