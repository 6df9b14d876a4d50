"""The shared library of the port's CUDA kernels (``csrc/*.cu``).

Every ``.cu`` source under ``csrc/`` is compiled in one ``nvcc`` call for
``sm_90a`` into one shared library with a plain C interface under
``build/kernels/`` (gitignored) at first use, keyed by a hash of every file
under ``csrc/`` (the shared headers too), and loaded with ctypes: a
checkout's first run pays one build for every kernel. Nothing is built or
imported from CUDA when this module is imported. The wrappers are
``ops/rank_cuda.py`` (``rank_decode``), ``ops/scan_cuda.py``
(``next_set``), ``ops/emit_cuda.py`` (``emit_single``) and
``ops/node_cuda.py`` (``node_step``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
_CSRC = _PKG / "csrc"
SOURCES = sorted(_CSRC.glob("*.cu"))
# what the library's key hashes: the sources and the headers they include
KEYED = sorted(p for p in _CSRC.iterdir() if p.is_file())
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_PTR, _I64 = ctypes.c_void_p, ctypes.c_longlong
# each C function of the library: its return type and argument types
# (pointers and the stream as c_void_p, so ctypes does not cut them)
SIGNATURES = {
    "rank_decode": (ctypes.c_int, [_PTR, _I64, _PTR, _PTR, _I64, _PTR]),
    "next_set": (ctypes.c_int, [_PTR, _I64, _I64, _I64, _PTR, _PTR, _PTR]),
    "next_set_scratch_len": (_I64, [_I64]),
    "emit_single_plan": (ctypes.c_int, [_PTR, _PTR]),
    "emit_single_write": (ctypes.c_int, [_PTR, _PTR, _PTR]),
    "node_step_scratch_len": (_I64, [_I64]),
    "node_step_count": (ctypes.c_int, [_PTR, _I64, _PTR, _I64, _PTR, _I64,
                                       _PTR, _I64, _I64, _PTR, _PTR]),
    "node_step_write": (ctypes.c_int, [_PTR, _I64, _PTR, _PTR, _I64, _PTR,
                                       _PTR, _PTR]),
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("ebwt2indel_torch kernels: nvcc not found (needs the "
                       "CUDA toolkit)")


def library_path() -> Path:
    """Where the library of the files under ``csrc/`` as they are now
    lives: its name holds their hash."""
    h = hashlib.sha256()
    for src in KEYED:
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"libebwt2indel_kernels_{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the kernel library if these sources and headers have not
    been built yet; returns its path."""
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                        *map(str, SOURCES)], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on {[s.name for s in SOURCES]}:\n"
                           f"{r.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded library, built at the first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (restype, argtypes) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _lib = lib
        return _lib
