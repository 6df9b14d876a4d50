"""ctypes bindings for the repository's C++ host libraries (``native/``):
the multithreaded eBWT packer (``packer.cpp``) and the SA-IS suffix sorter
(``saca.cpp``).

Each library is compiled with ``g++`` from the checkout's sources into
``build/native/`` (gitignored) at first use, keyed by a hash of its source,
and loaded with ctypes. Building raises ``NativeUnavailable`` when there is
no compiler; callers then take their numpy path, which gives the same
result.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..utils import dna

REPO = Path(__file__).resolve().parents[2]
_SRC_DIR = REPO / "native"
_BUILD_DIR = REPO / "build" / "native"
_CXXFLAGS = ["-O3", "-fstrict-aliasing", "-std=c++17",
             "-fPIC", "-pthread", "-shared"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


class NativeUnavailable(RuntimeError):
    """The C++ library could not be built or loaded here."""


def _build(name: str) -> Path:
    src = _SRC_DIR / f"{name}.cpp"
    if not src.is_file():
        raise NativeUnavailable(f"missing source {src}")
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    out = _BUILD_DIR / f"lib{name}_{digest}.so"
    if out.is_file():
        return out
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise NativeUnavailable("no C++ compiler found")
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    r = subprocess.run([cxx, *_CXXFLAGS, "-o", str(tmp), str(src)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise NativeUnavailable(f"{cxx} failed on {src}:\n{r.stderr}")
    os.replace(tmp, out)
    return out


def _load(name: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        try:
            lib = ctypes.CDLL(str(_build(name)))
        except OSError as e:
            raise NativeUnavailable(str(e)) from e
        if name == "packer":
            lib.pack_ascii.restype = ctypes.c_int64
            lib.pack_ascii.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint8,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int,
            ]
        else:
            for fn in (lib.sais_int32, lib.sais_int64):
                fn.restype = ctypes.c_int64
                fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_int64, ctypes.c_int64]
        _libs[name] = lib
        return lib


def pack_bytes(data: np.ndarray, term: int = dna.DEFAULT_TERM):
    """Pack raw ASCII bytes into a PackedBwt. Raises ValueError with the
    reference's message on a forbidden character (dna_string.hpp:90-96)."""
    from . import packing

    lib = _load("packer")
    if data.dtype != np.uint8 or not data.flags.c_contiguous:
        data = np.ascontiguousarray(data, dtype=np.uint8)
    n = int(data.shape[0])
    if n >= packing.CAP:
        raise ValueError(packing.CAP_MESSAGE)
    n_blocks = n // packing.BLOCK + 1
    blocks = np.zeros((n_blocks, 16), dtype=np.uint32)
    block_counts = np.zeros((n_blocks, 4), dtype=np.int32)
    totals = np.zeros(5, dtype=np.int64)
    rc = lib.pack_ascii(
        data.ctypes.data, n, term, blocks.ctypes.data,
        block_counts.ctypes.data, totals.ctypes.data,
        min(os.cpu_count() or 1, 8),
    )
    if rc != 0:
        raise ValueError(packing.forbidden_message(int(data[rc - 1]), term))
    return packing.PackedBwt(
        blocks=blocks, block_counts=block_counts,
        F=packing.f_from_totals(totals), counts=totals, n=n, term=term,
    )


def pack_file(path: str, term: int = dna.DEFAULT_TERM):
    # memmap: the packer streams the pages in, no second in-RAM copy
    data = np.memmap(path, dtype=np.uint8, mode="r")
    return pack_bytes(data, term)


def sais(codes: np.ndarray, alphabet: int) -> np.ndarray:
    """Suffix array (int64) of an int32 sequence whose last element is the
    unique smallest (0), by the native linear-time SA-IS."""
    lib = _load("saca")
    codes = np.ascontiguousarray(codes, dtype=np.int32)
    n = len(codes)
    if n >= 2**31:
        sa = np.empty(n, dtype=np.int64)
        rc = lib.sais_int64(codes.ctypes.data, sa.ctypes.data, n, alphabet)
    else:
        sa = np.empty(n, dtype=np.int32)
        rc = lib.sais_int32(codes.ctypes.data, sa.ctypes.data, n, alphabet)
    if rc != 0:
        raise NativeUnavailable(f"SA-IS returned {rc}")
    return sa.astype(np.int64, copy=False)
