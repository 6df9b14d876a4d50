"""The program's timing: one span helper, the record of each run's spans,
and ``EBWT_PROFILE=<dir>``, a ``torch.profiler`` trace of a whole run
(counterpart of ``_maybe_profile`` and ``_profiled``,
``ebwt2indel_tpu/models/pipeline.py:32-53``), read by
``ebwt2indel_torch/tools/tracetop.py``.

``span(name)`` times a stretch of a run on the host clock
(``time.perf_counter``) and adds its seconds to the current run's record
under ``name``; a span entered more than once in a run adds up. A name is
a phase (``index``, ``leaf_phase``, ``node_phase``, ``da_wait``,
``cluster``, ``call_emit``) or ``<phase>.<part>``, a part timed inside its
phase. While a profiler runs in the thread, the span also opens
``record_function(name)`` around the same enter and exit, so the trace's
host annotation and the recorded seconds are one interval on the
profiler's clock. A phase span ends on the device synchronise that closes
the phase, so its seconds time the work, not its enqueue.

``span(name, device=dev)`` on a CUDA device times the device's work
between enter and exit instead: a pair of ``torch.cuda.Event(
enable_timing=True)`` recorded on the current stream, read when the run
ends, after the run's own last synchronise. It synchronises nothing and
allocates no device memory. On the CPU it takes host time.

``recorded`` wraps a run and opens its record; the record is a context
variable, so a worker thread that runs in a copy of the run's context
(``contextvars.copy_context().run``) adds to the same record. The wrapped
run's returned stats get the record as ``stats["seconds"]``.
``profiled`` is ``recorded`` plus ``EBWT_PROFILE``: with the switch set, it
records the run's device activity and its span marks and writes one
Chrome trace into ``<dir>``, without parsing it in Python, where a run's
host events would cost seconds. With the switch unset, neither adds a
sync.
"""

from __future__ import annotations

import contextvars
import functools
import inspect
import os
import threading
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from .. import device as device_mod


class Record:
    """The spans of one run: host seconds by name, and the event pairs of
    device spans until the run ends."""

    def __init__(self):
        self._seconds: dict[str, float] = {}
        self._events: list = []  # (name, start, end) CUDA events
        self._lock = threading.Lock()  # the DA worker adds beside the run

    def add(self, name: str, seconds: float) -> None:
        with self._lock:
            self._seconds[name] = self._seconds.get(name, 0.0) + seconds

    def add_events(self, name: str, start, end) -> None:
        with self._lock:
            self._events.append((name, start, end))

    def spent(self, *names: str) -> float:
        with self._lock:
            return sum(self._seconds.get(n, 0.0) for n in names)

    def close(self) -> dict[str, float]:
        """Seconds by name, the device spans' read from their events. Each
        end event was recorded before the run's last synchronise, so
        waiting on it returns at once."""
        with self._lock:
            events, self._events = self._events, []
        for name, start, end in events:
            end.synchronize()
            self.add(name, start.elapsed_time(end) / 1e3)
        with self._lock:
            return dict(self._seconds)


_RUN: contextvars.ContextVar[Record | None] = contextvars.ContextVar(
    "ebwt2indel_run", default=None)


class span:
    """A timed stretch of the current run (see the module's docstring);
    ``seconds`` holds its host seconds once it has exited."""

    def __init__(self, name: str, device: torch.device | None = None):
        self.name = name
        self.device = device if device is not None and \
            torch.device(device).type == "cuda" else None
        self.seconds: float | None = None

    def __enter__(self):
        self._mark = record_function(self.name) \
            if torch._C._autograd._profiler_enabled() else None
        if self._mark is not None:
            self._mark.__enter__()
        if self.device is not None:
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record(torch.cuda.current_stream(self.device))
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        run = _RUN.get()
        if self.device is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(self.device))
            if run is not None:
                run.add_events(self.name, self._start, end)
        elif run is not None:
            run.add(self.name, self.seconds)
        if self._mark is not None:
            self._mark.__exit__(*exc)
        return False


def spent(*names: str) -> float:
    """Host seconds the current run has recorded so far under ``names``,
    summed; 0 outside a run."""
    run = _RUN.get()
    return run.spent(*names) if run is not None else 0.0


def recorded(fn):
    """Wrap a run that returns its stats (a dict): open its record for the
    call, and return the stats with the record as ``stats["seconds"]``."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        token = _RUN.set(Record())
        try:
            out = fn(*args, **kwargs)
            out["seconds"] = _RUN.get().close()
        finally:
            _RUN.reset(token)
        return out

    return wrapped


def profiled(fn):
    """``recorded``, for a run that takes ``device`` and ``log`` arguments:
    with ``EBWT_PROFILE`` set (read at each call), record it under the
    profiler and export ``<dir>/<function>.<pid>.<ns>.pt.trace.json``, then
    log the path."""
    sig = inspect.signature(fn)
    run = recorded(fn)

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        trace_dir = os.environ.get("EBWT_PROFILE")
        if not trace_dir:
            return run(*args, **kwargs)
        call = sig.bind(*args, **kwargs)
        call.apply_defaults()
        dev = device_mod.resolve(call.arguments["device"])
        activities = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            out = run(*args, **kwargs)
            device_mod.synchronize(dev)
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, f"{fn.__name__}.{os.getpid()}."
                                       f"{time.time_ns()}.pt.trace.json")
        prof.export_chrome_trace(path)
        call.arguments["log"](f"[profile] trace {path}")
        return out

    return wrapped
