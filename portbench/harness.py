"""One run of one cell: set-up, the measured window, the counting sample,
the traced samples, the reference and the result line (``run``).

Set-up makes the inputs on the device from the seed (``gen.py``), writes
the files the traffic's argv names into a fresh directory under
``TMPDIR``, and runs one untimed sample, which builds the program's
kernels and the native packer into the checkout on a first run and loads
every kernel a sample uses. Each sample is one call of
``ebwt2indel_torch.cli.main`` on the cell's argv, its log going to a file.
The window runs whole samples and ends with the first that finishes after
``seconds``. With ``trace``, one counting sample follows, neither timed
nor profiled, in which each rank kernel launch is reduced at once to two
host integers (its distinct block rows and its queries), and then
``TRACED_SAMPLES`` samples run under ``torch.profiler``. Then the
program's state is freed and every sample's ``.snp`` bytes are judged
against the plain reference (``reference/calls.py``), computed on the
same device from the same reads.
"""

from __future__ import annotations

import contextlib
import gc
import hashlib
import json
import os
import shutil
import sys
import tempfile
import time
import traceback
from pathlib import Path

import torch

from . import gen, manifest, tracing
from .reference import calls

FORBIDDEN = ("jax", "jaxlib", "flax", "ebwt2indel_tpu")
PIPELINES = ("run_one_dataset", "run_two_datasets", "run_two_datasets_da")
TRACED_SAMPLES = 2
# bytes one rank_decode launch needs: a 64-byte block row per distinct row
# (i >> 7), an int64 position in and four int64 counts out per query
ROW_BYTES, QUERY_BYTES = 64, 40
NAME_CHARS = 160  # of a device operation's name in the breakdown


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` that the run may not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def prepare_environment(root: Path) -> None:
    """Before CUDA starts: no ``EBWT_*`` switch reaches the program, and
    the caches live at fixed paths inside the checkout."""
    for k in [k for k in os.environ if k.startswith("EBWT_")]:
        del os.environ[k]
    build = Path(root) / "build"
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda-cache")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")


class Program:
    """The system under test on one argv: each ``sample`` is one call of
    ``cli.main``. While ``hooked``, the pipeline function that ``cli.main``
    dispatches to hands its stats to the harness, and while ``counts`` is
    a list each rank kernel launch appends its distinct block rows and its
    queries to it, two host integers; nothing of a launch outlives it."""

    def __init__(self, argv: list[str], device: torch.device, work: str,
                 out_path: str):
        from ebwt2indel_torch import cli
        from ebwt2indel_torch.models import pipeline
        from ebwt2indel_torch.ops import rank_cuda

        self._cli, self._pipeline, self._rank = cli, pipeline, rank_cuda
        self.argv = argv
        self.device = device
        self.log_path = os.path.join(work, "program.log")
        self.out_path = out_path
        self.outputs: dict[str, bytes] = {}
        self.counts: list[tuple[int, int]] | None = None
        self._stats = None

    @contextlib.contextmanager
    def hooked(self):
        saved = {n: getattr(self._pipeline, n) for n in PIPELINES}
        decode = self._rank.rank_decode

        def wrap(fn):
            def run(*a, **k):
                self._stats = fn(*a, **k)
                return self._stats
            return run

        def rank_decode(blocks, i):
            if self.counts is not None and i.numel():
                self.counts.append((torch.unique(i >> 7).numel(),
                                    i.numel()))
            return decode(blocks, i)

        for n, fn in saved.items():
            setattr(self._pipeline, n, wrap(fn))
        self._rank.rank_decode = rank_decode
        try:
            yield self
        finally:
            for n, fn in saved.items():
                setattr(self._pipeline, n, fn)
            self._rank.rank_decode = decode

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def sample(self) -> dict:
        launches = self._rank.LAUNCHES["rank_decode"]
        queries = self._rank.QUERIES["rank_decode"]
        self._stats = None
        t = time.perf_counter()
        try:
            with open(self.log_path, "w") as log, \
                    contextlib.redirect_stdout(log):
                rc = self._cli.main(self.argv, device=self.device.type)
            self._sync()
            data = open(self.out_path, "rb").read() if rc == 0 else None
        except Exception:  # a sample that raises is a failed sample
            traceback.print_exc(file=sys.stderr)
            rc, data = None, None
        wall = time.perf_counter() - t
        digest = None
        if data is not None:
            digest = hashlib.sha256(data).hexdigest()
            self.outputs.setdefault(digest, data)
        else:
            sys.stderr.write(f"[portbench] sample failed (rc={rc}); log "
                             f"tail:\n{_tail(self.log_path)}\n")
        return {"ok": data is not None, "wall": wall, "digest": digest,
                "seconds": dict((self._stats or {}).get("seconds", {})),
                "launches": self._rank.LAUNCHES["rank_decode"] - launches,
                "queries": self._rank.QUERIES["rank_decode"] - queries}


def _tail(path: str, n: int = 2000) -> str:
    try:
        return open(path, errors="replace").read()[-n:]
    except OSError:
        return ""


def _free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def records(data: bytes) -> list[bytes]:
    """The .snp's records, each a header line and its sequence line."""
    lines = data.split(b"\n")
    if lines[-1] == b"":
        lines.pop()
    return [b"\n".join(lines[i:i + 2]) for i in range(0, len(lines), 2)]


def records_wrong(got: bytes, want: bytes) -> int:
    """Records that differ in place, plus those one side lacks."""
    a, b = records(got), records(want)
    return sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))


def _show_diff(got: bytes, want: bytes, most: int = 3) -> None:
    """The first records where a sample's output and the reference's
    differ, on standard error."""
    a, b = records(got), records(want)
    shown = 0
    for i in range(max(len(a), len(b))):
        x = a[i] if i < len(a) else b"(none)"
        y = b[i] if i < len(b) else b"(none)"
        if x != y:
            sys.stderr.write(f"[portbench] record {i} of {len(b)}:\n program "
                             f"{x.decode(errors='replace')}\n reference "
                             f"{y.decode(errors='replace')}\n")
            shown += 1
            if shown == most:
                return


def launch_bytes(counts) -> int:
    """Bytes the rank kernel's launches need, from each launch's
    (distinct block rows, queries)."""
    return sum(ROW_BYTES * rows + QUERY_BYTES * queries
               for rows, queries in counts)


def _counted(prog: Program) -> dict:
    """One more sample of the same argv, neither timed nor profiled, with
    its rank kernel bytes (``rank_bytes``) counted launch by launch."""
    prog.counts = []
    try:
        s = prog.sample()
    finally:
        counts, prog.counts = prog.counts, None
    s["rank_bytes"] = launch_bytes(counts)
    return s


def traced_rank_bytes(counted: dict, traced: list[dict]) -> int | None:
    """The rank kernel's bytes over the traced samples: the counted
    sample's, once for each, where every traced sample launched the kernel
    as often and on as many queries as the counted one; else None, and
    standard error says why."""
    want = (counted["launches"], counted["queries"])
    off = [(s["launches"], s["queries"]) for s in traced
           if (s["launches"], s["queries"]) != want]
    if off:
        sys.stderr.write(f"[portbench] rank_bytes left out: the counted "
                         f"sample made (launches, queries) {want}, traced "
                         f"samples {off}\n")
        return None
    return counted["rank_bytes"] * len(traced)


def _traced(prog: Program, device: torch.device, work: str, counted: dict):
    """TRACED_SAMPLES samples under the profiler: their records, the
    trace's summary with the rank kernel's bytes and launches, and the
    device's memory peak over them."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    cuda = device.type == "cuda"
    if cuda:
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.reset_peak_memory_stats(device)
    done = []
    with profile(activities=acts) as prof:
        for _ in range(TRACED_SAMPLES):
            with record_function(tracing.SAMPLE):
                done.append(prog.sample())
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    path = os.path.join(work, "trace.json")
    prof.export_chrome_trace(path)
    del prof
    trace_bytes = os.path.getsize(path)
    summary = tracing.summarize(tracing.load_events(path), ("rank_decode",))
    os.remove(path)
    if summary is not None:
        summary["rank_launches"] = sum(s["launches"] for s in done)
        summary["rank_bytes"] = traced_rank_bytes(counted, done)
        summary["trace_file_bytes"] = trace_bytes
    return done, summary, peak


def run(cell: manifest.Cell, seed: int, seconds: float, trace: bool,
        device: str, t0: float, recipe_overrides: dict | None = None) -> int:
    """Run ``cell`` once and print its result line; returns the exit
    code. ``t0`` is the process's start on ``time.perf_counter``."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    recipe = {**cell.config, **(recipe_overrides or {})}
    work = tempfile.mkdtemp(prefix=f"portbench-{cell.name}-")
    marks = {"entered": time.perf_counter() - t0}  # seconds from the start
    peaks = {}  # the device's memory peak of each stage, bytes
    try:
        reads1, reads2 = gen.make_reads(recipe, seed, dev)
        if cuda:
            torch.cuda.synchronize(dev)
        marks["reads made"] = time.perf_counter() - t0
        paths = gen.write_inputs(cell.inputs, reads1, reads2, work)
        positions = sum(os.path.getsize(paths[k]) for k in cell.inputs
                        if k in gen.EBWT_INPUTS)
        reads1, reads2 = reads1.cpu(), reads2.cpu()
        _free(dev)
        marks["inputs written"] = time.perf_counter() - t0
        if cuda:
            peaks["inputs"] = torch.cuda.max_memory_allocated(dev)
        out_path = os.path.join(work, "out.snp")
        argv = [a.format(out=out_path, **paths)
                for a in cell.traffic["argv"]]
        prog = Program(argv, dev, work, out_path)

        with prog.hooked():
            marks["program imported"] = time.perf_counter() - t0
            warm = prog.sample()
            setup_s = time.perf_counter() - t0
            if cuda:
                torch.cuda.synchronize(dev)
                torch.cuda.reset_peak_memory_stats(dev)
            window = []
            start = time.perf_counter()
            while True:
                window.append(prog.sample())
                end = time.perf_counter()
                if end - start >= seconds:
                    break
            peak = peaks["window"] = \
                torch.cuda.max_memory_allocated(dev) if cuda else 0
            counted, traced, summary = [], [], None
            if trace:
                counted = [_counted(prog)]
                marks["counted"] = time.perf_counter() - t0
                traced, summary, peaks["traced"] = _traced(prog, dev, work,
                                                           counted[0])
                marks["traced"] = time.perf_counter() - t0
        loaded = forbidden_modules()
        if loaded:
            sys.stderr.write(f"[portbench] refused: {', '.join(loaded)} "
                             "loaded in the process\n")
            return 3
        outputs = prog.outputs
        del prog
        _free(dev)

        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        t_ref = time.perf_counter()
        want = calls.snp_bytes(reads1.to(dev), reads2.to(dev),
                               int(cell.traffic["mode"]),
                               calls.Params.from_argv(argv))
        _free(dev)
        if cuda:
            peaks["reference"] = torch.cuda.max_memory_allocated(dev)
        sys.stderr.write(f"[portbench] marks (s) {marks}; reference "
                         f"{time.perf_counter() - t_ref} s; device memory "
                         f"peaks (B) {peaks}\n")
        wrong = {d: records_wrong(data, want) for d, data in outputs.items()}
        for d, data in outputs.items():
            if wrong[d]:
                _show_diff(data, want)
        attempted = len(window) + len(traced)
        judged = window + traced + [warm] + counted
        bad = [not s["ok"] or wrong[s["digest"]] > 0 for s in judged]
        compared = {
            "samples_wrong": {"value": sum(bad), "limit": 0},
            "records_wrong": {"value": max(wrong.values(), default=0),
                              "limit": 0},
        }
        correct = all(c["value"] <= c["limit"] for c in compared.values())

        ok = [s for s in window if s["ok"]]
        kind = torch.cuda.get_device_name(dev) if cuda else dev.type
        record = {
            "positions": positions,
            "setup_s": setup_s,
            "window": {"seconds": end - start, "samples": len(ok),
                       "positions": positions * len(ok)},
            "peak_bytes": peak,
            "samples": ok,
            "device": {"kind": kind},
            "peaks": json.loads(
                (manifest.BENCH / "peaks.json").read_text()),
            "trace": summary,
        }
        metrics = {}
        for m in (cell.per_layer if trace else cell.end_to_end):
            v = m.read(record)
            if v is not None:
                metrics[m.name] = {"value": v, "unit": m.unit}
        device_rec = {"platform": "gpu", "kind": kind, "count": cell.chips,
                      "memory_peak_bytes": peak}
        result = {"correct": correct, "attempted": attempted,
                  "failed": sum(bad[:attempted]), "metrics": metrics,
                  "device": device_rec}
        if summary is not None:
            device_rec["busy_s"] = summary["busy_s"]
            device_rec["window_s"] = summary["window_s"]
            result["breakdown"] = {
                "device_ops": [[n[:NAME_CHARS], t]
                               for n, t in summary["device_ops"]],
                "idle_gaps": summary["idle_gaps"]}
        result["compared"] = compared

        _report(positions, setup_s, warm, window, counted, traced, summary,
                record)
        sys.stderr.write(f"[portbench] run wall {time.perf_counter() - t0} "
                         "s\n")
        for name, c in compared.items():
            sys.stderr.write(f"{name} {c['value']} limit {c['limit']}\n")
        sys.stderr.flush()
        print(json.dumps(result), flush=True)
        return 0
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _report(positions, setup_s, warm, window, counted, traced, summary,
            record):
    """What the run saw, on standard error, before the compared numbers."""
    w = sys.stderr.write
    w(f"[portbench] positions {positions}, setup_s {setup_s}, warm-up "
      f"sample {warm['wall']} s\n")
    for kind, samples in (("window", window), ("counted", counted),
                          ("traced", traced)):
        for i, s in enumerate(samples):
            w(f"[portbench] {kind} sample {i}: wall {s['wall']} s, "
              f"launches {s['launches']}, queries {s['queries']}, "
              f"seconds {json.dumps(s['seconds'])}\n")
    w(f"[portbench] window {record['window']}, peak "
      f"{record['peak_bytes']} B\n")
    if summary is not None:
        brief = {k: v for k, v in summary.items()
                 if k not in ("device_ops", "idle_gaps")}
        w(f"[portbench] trace {json.dumps(brief)}\n")
