"""Binding of mode 1's CUDA emission (``csrc/emit_single.cu``), built with
the port's other kernels into one library by ``ops/kernels.py``.

``emit_single`` is the wrapper: it checks the walks' tensors, allocates the
kernels' scratch (three int32 and one int64 a cluster, and eight int64
totals), launches the plan and the scan on PyTorch's current stream, copies
the counts and the text's length to the host, allocates the text at its
exact size, launches the writer, raises if a launch failed, and adds one to
``LAUNCHES["emit_single"]`` per emission that runs on the card.
"""

from __future__ import annotations

import ctypes

import torch

from . import kernels

LAUNCHES = {"emit_single": 0}
N_COUNTS = 7  # emit_vec.SINGLE_COUNTS, counted in its order
_FLAG_DTYPES = (torch.bool, torch.uint8)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class _Args(ctypes.Structure):
    """``EmitArgs`` of ``csrc/emit_single.cu``: 8-byte fields only."""

    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "found", "freq", "full", "support", "ctx", "seq", "seqlen")]
        + [(n, ctypes.c_longlong) for n in (
            "B", "L", "R", "mcov", "max_snvs", "max_gap", "complexity",
            "term")]
        + [(n, ctypes.c_void_p) for n in (
            "nrec_counted", "base_bytes", "cluster_nr", "offset", "totals")])


def _check(found, freq, full, support, ctx, seq, seqlen):
    dev = found.device
    if dev.type != "cuda" or any(t.device != dev for t in (
            freq, full, support, ctx, seq, seqlen)):
        raise ValueError("emit_single: the walks' tensors must all lie on "
                         f"one CUDA device, found on {dev}")
    B = found.shape[0]
    want = {"found": (found, _FLAG_DTYPES, (B,)),
            "freq": (freq, _FLAG_DTYPES, (B, 4)),
            "full": (full, _FLAG_DTYPES, (B, 4)),
            "support": (support, (torch.int64,), (B, 4)),
            "ctx": (ctx, (torch.int8,), (B, 4, ctx.shape[-1])),
            "seq": (seq, (torch.int8,), (B, seq.shape[-1])),
            "seqlen": (seqlen, (torch.int64,), (B,))}
    for name, (t, dtypes, shape) in want.items():
        if t.dtype not in dtypes or tuple(t.shape) != shape:
            raise ValueError(f"emit_single: {name} must be {dtypes} of "
                             f"shape {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")


def emit_single(cfg, found, freq, full, support, ctx, seq, seqlen):
    """Mode 1's emission on the card over the B clusters that passed the
    base-count filter: ``found`` (B,), ``freq`` and ``full`` (B, 4) flags,
    ``support`` (B, 4) int64, the left contexts ``ctx`` (B, 4, L) and the
    right contexts ``seq`` (B, R) as codes, ``seqlen`` (B,) int64, and
    ``cfg``'s -m, -v, -g, -c and terminator. Returns (the ``.snp`` text of
    every record as a (bytes,) uint8 tensor on the device, the seven counts
    of ``emit_vec.SINGLE_COUNTS`` in its order as host integers); the text
    is complete once the stream reaches it."""
    _check(found, freq, full, support, ctx, seq, seqlen)
    B, L, R = found.shape[0], ctx.shape[-1], seq.shape[-1]
    if L < 1 or cfg.max_gap < 0:
        raise ValueError(f"emit_single: k_left {L} must be >= 1 and max_gap "
                         f"{cfg.max_gap} >= 0")
    # a cluster's record bytes are counted in int32: four records of the
    # left context, an indel's bases, the right context and the numbers
    if 4 * (2 * L + R + 128) >= 2**31:
        raise ValueError(f"emit_single: contexts of {L} and {R} bases are "
                         "too long for a cluster's int32 byte count")
    dev = found.device
    if B == 0:
        return torch.empty(0, dtype=torch.uint8, device=dev), [0] * N_COUNTS
    tensors = [t.contiguous() for t in (found, freq, full, support, ctx,
                                        seq, seqlen)]
    i32 = torch.empty((3, B), dtype=torch.int32, device=dev)
    offset = torch.empty(B, dtype=torch.int64, device=dev)
    totals = torch.zeros(N_COUNTS + 1, dtype=torch.int64, device=dev)
    # a gap is never longer than the context (csrc/emit_single.cu)
    args = _Args(*[t.data_ptr() for t in tensors], B, L, R, cfg.mcov_out,
                 cfg.max_snvs, min(cfg.max_gap, L), cfg.complexity, cfg.term,
                 *[t.data_ptr() for t in i32], offset.data_ptr(),
                 totals.data_ptr())
    lib = kernels.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.emit_single_plan(ctypes.addressof(args), stream)
        if err != 0:
            raise RuntimeError(f"emit_single: plan launch failed "
                               f"(cudaError {err})")
        *counts, n_bytes = totals.cpu().tolist()
        text = torch.empty(n_bytes, dtype=torch.uint8, device=dev)
        err = lib.emit_single_write(ctypes.addressof(args), text.data_ptr(),
                                    stream)
        if err != 0:
            raise RuntimeError(f"emit_single: write launch failed "
                               f"(cudaError {err})")
    LAUNCHES["emit_single"] += 1
    return text, counts
