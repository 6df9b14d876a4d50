"""``EBWT_PROFILE=<dir>``: a ``torch.profiler`` trace of a whole run
(counterpart of ``_maybe_profile`` and ``_profiled``,
``ebwt2indel_tpu/models/pipeline.py:32-53``), read by
``ebwt2indel_torch/tools/tracetop.py``.

``profiled`` wraps a pipeline run. With the switch set, it records the run's
device activity and its phase marks, and writes one Chrome trace into
``<dir>``. It does not parse the trace in Python, where a run's host events
would cost seconds. The phase marks are host events, so host activity is
recorded as well as the device's.

``phase(name)`` marks a phase (``index``, ``leaf_phase``, ``node_phase``,
``cluster``, ``call_emit``: the keys of ``stats["seconds"]``) with
``record_function`` while a profiler runs, which gives the trace one host
annotation per phase; otherwise it is a null context. With the switch
unset, neither adds a sync.
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from .. import device as device_mod


def phase(name: str):
    """``record_function(name)`` while a profiler runs, else a null
    context."""
    if torch._C._autograd._profiler_enabled():
        return record_function(name)
    return contextlib.nullcontext()


def profiled(fn):
    """Wrap a run that takes ``device`` and ``log`` arguments: with
    ``EBWT_PROFILE`` set (read at each call), record it and export
    ``<dir>/<function>.<pid>.<ns>.pt.trace.json``, then log the path."""
    sig = inspect.signature(fn)

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        trace_dir = os.environ.get("EBWT_PROFILE")
        if not trace_dir:
            return fn(*args, **kwargs)
        call = sig.bind(*args, **kwargs)
        call.apply_defaults()
        dev = device_mod.resolve(call.arguments["device"])
        activities = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            out = fn(*args, **kwargs)
            device_mod.synchronize(dev)
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, f"{fn.__name__}.{os.getpid()}."
                                       f"{time.time_ns()}.pt.trace.json")
        prof.export_chrome_trace(path)
        call.arguments["log"](f"[profile] trace {path}")
        return out

    return wrapped
