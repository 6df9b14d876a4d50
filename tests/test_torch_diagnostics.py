"""The port's diagnostic switches, on the CPU: ``EBWT_PROGRESS`` prints the
JAX package's progress line after each traversal chunk, and the last line
of each phase counts the phase's leaves or nodes as the JAX package's
traversal does; ``EBWT_PROFILE`` writes a trace that the port's
``tracetop`` reads, with the run's spans marked; and ``tracetop`` on
small synthetic Chrome traces gives the expected sums by kernel and by
span, the idle gaps named by span and the clock check's counts. Counts are compared exactly; sums of trace durations, which are
decimal microseconds, to 1e-9 ms."""

import json
import os
import re

import numpy as np
import pytest

from ebwt2indel_tpu.models import fm_index as jfm
from ebwt2indel_tpu.models import traverse as jtraverse
from ebwt2indel_tpu.ops import packing as jpacking
from ebwt2indel_torch.models import fm_index, pipeline, traverse
from ebwt2indel_torch.ops import packing
from ebwt2indel_torch.tools import ebwt, simulate, tracetop
from ebwt2indel_torch.utils import dna
from ebwt2indel_torch.utils.config import Config

K, K_RIGHT = 8, 12
_LINE = re.compile(r"\[progress\] processed (\d+) items, (\d+) pending")
_PHASES = {"index", "leaf_phase", "node_phase", "cluster", "call_emit"}
_PARTS = {"index.pack", "index.upload", "node_phase.wait", "cluster.next_set",
          "call_emit.walks", "call_emit.write",
          "call_emit.align", "call_emit.format"}


@pytest.fixture(scope="module")
def reads_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_diag") / "r.ebwt"
    rng = np.random.default_rng(0xD1A)
    genome = simulate.random_genome(rng, 1500)
    hap2, _ = simulate.plant_variants(rng, genome, snp_rate=0.004,
                                      indel_rate=0.001)
    path.write_text(ebwt.ebwt_of_reads(
        simulate.sample_reads(rng, genome, 6, 60)
        + simulate.sample_reads(rng, hap2, 6, 60)))
    return path


def _phases(lines):
    """The progress lines split into phases: a phase's count never falls,
    and the next phase starts from its first chunk."""
    out, last = [], None
    for p, w in lines:
        if last is None or p < last:
            out.append([])
        out[-1].append((p, w))
        last = p
    return out


@pytest.mark.parametrize("value", ["1", "0", None])
def test_progress_lines(reads_file, value, monkeypatch, capsys):
    monkeypatch.setattr(traverse, "CHUNK", 64)
    if value is None:
        monkeypatch.delenv("EBWT_PROGRESS", raising=False)
    else:
        monkeypatch.setenv("EBWT_PROGRESS", value)
    codes = dna.str_to_codes(reads_file.read_text())
    jf = jfm.FMIndex.from_packed(jpacking.pack_codes(codes))
    want = jtraverse.navigate_one_bwt(jf, K, K_RIGHT).stats
    capsys.readouterr()
    fm = fm_index.FMIndex.from_packed(packing.pack_codes(codes), "cpu")
    traverse.navigate_one_bwt(fm, K, K_RIGHT)
    text = capsys.readouterr().out
    if value != "1":
        assert "[progress]" not in text
        return
    rows = text.splitlines()
    assert rows and all(_LINE.fullmatch(r) for r in rows), rows[:3]
    leaf, node = _phases([tuple(map(int, _LINE.fullmatch(r).groups()))
                          for r in rows])
    assert len(leaf) > 3 and len(node) > 3
    assert leaf[-1] == (want["leaves"], 0)
    assert node[-1] == (want["nodes"], 0)


def test_profile_writes_a_trace_tracetop_reads(reads_file, tmp_path,
                                               monkeypatch, capsys):
    """With EBWT_PROFILE set a CPU run writes one trace into the directory
    and logs its path; tracetop reads it (as a directory too), finds no
    device track, and reports the run's spans: the five phases marked once
    each, their parts, and two node waits a node step. Each mark is the
    interval whose seconds the run records. With the switch unset nothing
    is written."""
    prof = tmp_path / "prof"
    logs = []
    monkeypatch.setenv("EBWT_PROFILE", str(prof))
    st = pipeline.run_one_dataset(Config(input1=str(reads_file),
                                         output=str(tmp_path / "p.snp")),
                                  log=logs.append, device="cpu")
    (trace,) = os.listdir(prof)
    assert trace.startswith("run_one_dataset.") and \
        trace.endswith(".pt.trace.json")
    assert f"[profile] trace {prof / trace}" in logs
    r = tracetop.summarize(tracetop.load_events(str(prof / trace)))
    assert not r["device"] and r["kernels"]
    assert set(r["phases"]) == set(st["seconds"]) == _PHASES | _PARTS
    for name, p in r["phases"].items():
        assert p["span_ms"] > 0, name
        # the mark opens before and closes after the recorded interval
        # (trace times are whole or decimal microseconds)
        assert -1e-3 < p["span_ms"] / 1e3 - st["seconds"][name] < 0.05, \
            name
    for name in _PHASES | _PARTS - {"node_phase.wait"}:
        assert r["phases"][name]["count"] == 1, name
    waits = r["phases"]["node_phase.wait"]["count"]
    assert waits >= 2 and waits % 2 == 0
    assert tracetop.main([str(prof), "5"]) == 0
    text = capsys.readouterr().out
    assert "host (no device track)" in text
    for name in _PHASES | _PARTS:
        assert re.search(rf"\n +[0-9.]+ +[0-9.]+  {re.escape(name)}"
                         r"( \(x\d+\))?\n", text), name

    monkeypatch.delenv("EBWT_PROFILE")
    pipeline.run_one_dataset(Config(input1=str(reads_file),
                                    output=str(tmp_path / "q.snp")),
                             log=logs.append, device="cpu")
    assert os.listdir(prof) == [trace]
    assert (tmp_path / "p.snp").read_bytes() == \
        (tmp_path / "q.snp").read_bytes()


def _x(cat, name, ts, dur, pid=0, correlation=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": pid, "tid": 7}
    if correlation is not None:
        e["args"] = {"correlation": correlation}
    return e


def _assert_phases(r, want):
    assert set(r["phases"]) == set(want)
    for name, w in want.items():
        assert r["phases"][name] == pytest.approx(w, abs=1e-9), name


def test_tracetop_sums_by_kernel_and_phase(tmp_path, capsys):
    """Kernels, a copy and a set on the device track; two phases marked on
    the host (a GPU user annotation is not read). A device event counts in
    the phase whose host span holds its launch (the runtime call of the
    same correlation id), though its own start lie elsewhere, or its own
    start where no launch is linked. Host events are not counted where
    device events exist, and are where none do; where host events overlap,
    their union counts."""
    events = [
        {"ph": "M", "name": "process_name", "pid": 0,
         "args": {"name": "python"}},
        _x("user_annotation", "leaf_phase", 90.0, 70.0, pid=1),
        _x("user_annotation", "node_phase", 195.0, 110.0, pid=1),
        _x("gpu_user_annotation", "leaf_phase", 100.0, 50.0),
        _x("cuda_runtime", "cudaMemcpyAsync", 50.0, 1.0, 1, 4),
        _x("cuda_runtime", "cudaLaunchKernel", 95.0, 3.0, 1, 1),
        _x("cuda_runtime", "cudaLaunchKernel", 150.0, 2.0, 1, 3),
        _x("cuda_driver", "cuLaunchKernel", 200.0, 3.0, 1, 2),
        _x("kernel", "rank_decode", 100.0, 10.5, correlation=1),
        # its launch at 200 is in the node phase, its start is not
        _x("kernel", "rank_decode", 170.0, 20.25, correlation=2),
        _x("kernel", "cumsum", 120.0, 4.0, correlation=3),
        _x("gpu_memcpy", "Memcpy HtoD", 60.0, 30.0, correlation=4),
        _x("gpu_memset", "Memset", 299.5, 1.0),  # no launch linked
        _x("cpu_op", "aten::add", 100.0, 500.0, pid=1),
    ]
    path = tmp_path / "t.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    r = tracetop.summarize(tracetop.load_events(str(path)), top_n=3)
    assert r["device"]
    assert [(n, c) for n, _, c in r["kernels"]] == \
        [("rank_decode", 2), ("Memcpy HtoD", 1), ("cumsum", 1)]
    ms = {n: t for n, t, _ in r["kernels"]}
    assert ms["rank_decode"] == pytest.approx(0.03075, abs=1e-9)
    assert r["busy_ms"] == pytest.approx(0.06575, abs=1e-9)
    assert r["linked"] == 4
    _assert_phases(r, {
        "leaf_phase": {"busy_ms": 0.0145, "span_ms": 0.07, "count": 1},
        "node_phase": {"busy_ms": 0.02125, "span_ms": 0.11, "count": 1}})

    host = [e for e in events if e.get("cat") not in
            ("kernel", "gpu_memcpy", "gpu_memset", "gpu_user_annotation")]
    r = tracetop.summarize(host)
    assert not r["device"] and r["linked"] == 0
    assert [(n, c) for n, _, c in r["kernels"]] == \
        [("aten::add", 1), ("cudaLaunchKernel", 2), ("cuLaunchKernel", 1),
         ("cudaMemcpyAsync", 1)]
    # the launch at 95 and the op at 100-600 count once each: the union
    _assert_phases(r, {
        "leaf_phase": {"busy_ms": 0.503, "span_ms": 0.07, "count": 1},
        "node_phase": {"busy_ms": 0.003, "span_ms": 0.11, "count": 1}})
    assert tracetop.main([str(path)]) == 0
    assert "device events" in capsys.readouterr().out


def test_tracetop_union_gaps_and_clock(tmp_path, capsys):
    """Overlapping device events count once (the union), in the trace and
    in each span; the idle gaps are named by the innermost span holding
    their middle; the clock check counts device events that start before
    the span holding their launch, and before the launch itself."""
    events = [
        _x("user_annotation", "node_phase", 0.0, 100.0, pid=1),
        _x("user_annotation", "node_phase.wait", 20.0, 60.0, pid=1),
        _x("user_annotation", "cluster", 100.0, 50.0, pid=1),
        _x("cuda_runtime", "cudaLaunchKernel", 5.0, 1.0, 1, 1),
        _x("cuda_runtime", "cudaLaunchKernel", 6.0, 1.0, 1, 2),
        _x("cuda_runtime", "cudaLaunchKernel", 110.0, 1.0, 1, 3),
        _x("kernel", "rank_decode", 10.0, 10.0, correlation=1),  # 10-20
        _x("kernel", "cumsum", 15.0, 10.0, correlation=2),  # 15-25
        # launched at 110 in the cluster span, started at 90 before it
        _x("kernel", "scan", 90.0, 40.0, correlation=3),  # 90-130
    ]
    path = tmp_path / "u.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    r = tracetop.summarize(tracetop.load_events(str(path)))
    assert r["busy_ms"] == pytest.approx(0.055, abs=1e-9)  # 15 + 40 us
    assert r["window_ms"] == pytest.approx(0.15, abs=1e-9)
    assert r["idle_ms"] == pytest.approx(0.095, abs=1e-9)
    _assert_phases(r, {
        "node_phase": {"busy_ms": 0.015, "span_ms": 0.1, "count": 1},
        "node_phase.wait": {"busy_ms": 0.0, "span_ms": 0.06, "count": 1},
        "cluster": {"busy_ms": 0.04, "span_ms": 0.05, "count": 1}})
    # the gap 25-90 holds its middle in the wait, 0-10 in node_phase only,
    # 130-150 in cluster
    assert r["gaps"] == [("node_phase.wait", pytest.approx(0.065)),
                         ("cluster", pytest.approx(0.02)),
                         ("node_phase", pytest.approx(0.01))]
    assert r["idle_by_span"] == {
        "node_phase.wait": pytest.approx(0.065),
        "cluster": pytest.approx(0.02),
        "node_phase": pytest.approx(0.01)}
    assert r["clock"] == {"linked": 3, "before_span": 1, "before_launch": 1,
                          "lead_ms": pytest.approx(0.01),
                          "launch_lead_ms": pytest.approx(0.02)}
    assert tracetop.main([str(path)]) == 0
    text = capsys.readouterr().out
    assert "[clock] of 3 device events linked to a launch, 1 start before " \
        "the span holding their launch (largest lead 0.010 ms)" in text
