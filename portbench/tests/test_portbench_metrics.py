"""The metric readers and the trace reduction on known inputs."""

from pathlib import Path

import pytest
import torch

from portbench import harness, manifest, tracing

ROOT = Path(__file__).resolve().parents[2]


def _record(**kw):
    rec = {"positions": 1000, "setup_s": 3.0, "peak_bytes": 36000,
           "window": {"seconds": 4.5, "samples": 3, "positions": 3000},
           "samples": [], "device": {"kind": "NVIDIA H100 80GB HBM3"},
           "peaks": {"NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12}},
           "trace": None}
    rec.update(kw)
    return rec


def test_positions_per_s_over_whole_samples():
    # three whole samples of 1000 positions, the last ending 4.5 s after
    # the window opened: all the work over all the time
    read = manifest.load_reader("positions_per_s")
    assert read(_record()) == pytest.approx(3000 / 4.5)
    assert read(_record(window={"seconds": 1.0, "samples": 0,
                                "positions": 0})) is None
    assert manifest.load_reader("peak_bytes_per_position")(_record()) == 36


def test_phase_means_and_missing_phase():
    samples = [{"seconds": {"index": 0.2, "node_phase": 0.5},
                "launches": 485}, {"seconds": {"index": 0.4,
                                               "node_phase": 0.7},
                                   "launches": 487}]
    rec = _record(samples=samples)
    assert manifest.load_reader("index.index_s")(rec) == pytest.approx(0.3)
    assert manifest.load_reader("traverse.node_s")(rec) == pytest.approx(0.6)
    assert manifest.load_reader("index.da_wait_s")(rec) is None
    assert manifest.load_reader("rank_decode.launches")(rec) == 486


def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_idle_from_union_of_overlapping_intervals():
    events = [
        _ev(tracing.SAMPLE, "user_annotation", 0, 100),
        _ev("node_phase", "user_annotation", 0, 60),
        _ev("node_phase.wait", "user_annotation", 50, 8),  # inside it
        _ev("cluster", "user_annotation", 60, 30),
        _ev("k1", "kernel", 10, 20),   # 10-30
        _ev("k2", "kernel", 20, 20),   # 20-40, overlaps k1
        _ev("rank_decode_kernel", "kernel", 70, 10),  # 70-80
        _ev("Memcpy HtoD", "gpu_memcpy", 95, 10),  # clipped to 95-100
        _ev("cpu op", "cpu_op", 0, 100),
    ]
    s = tracing.summarize(events, ("rank_decode",))
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(45e-6)  # 10-40, 70-80, 95-100
    assert s["kernel_s"]["rank_decode"] == pytest.approx(10e-6)
    # each gap by the innermost span that holds its middle: 0-10, 40-70
    # (middle 55, in the wait), 80-95 (middle 87.5, in the cluster phase)
    gaps = dict((round(v * 1e6), k) for k, v in s["idle_gaps"])
    assert gaps == {10: "node_phase", 30: "node_phase.wait", 15: "cluster"}
    assert s["idle_by_span"] == pytest.approx(
        {"node_phase": 10e-6, "node_phase.wait": 30e-6, "cluster": 15e-6})
    rec = _record(trace=s)
    assert manifest.load_reader("device.idle_pct")(rec) == pytest.approx(55)


def test_trace_without_device_or_samples_reads_nothing():
    assert tracing.summarize([_ev("x", "cpu_op", 0, 5)]) is None
    s = tracing.summarize([_ev(tracing.SAMPLE, "user_annotation", 0, 5)],
                          ("rank_decode",))
    assert s["idle_gaps"] == [[tracing.OUTSIDE, pytest.approx(5e-6)]]
    rec = _record(trace=s)
    assert manifest.load_reader("device.idle_pct")(rec) is None
    assert manifest.load_reader("rank_decode_roofline")(rec) is None


def test_rank_decode_bytes_of_a_known_launch():
    # 6 queries over block rows 0, 0, 1, 1, 1, 9: 3 distinct rows
    i = torch.tensor([0, 127, 128, 200, 255, 9 * 128 + 5])
    rows = (i >> 7).reshape(-1)
    got = harness.ROW_BYTES * torch.unique(rows).numel() + \
        harness.QUERY_BYTES * rows.numel()
    assert got == 64 * 3 + 40 * 6
    assert harness.launch_bytes([(3, 6)]) == got
    t = {"kernel_s": {"rank_decode": 1e-6}, "rank_bytes": 1.675e6,
         "device_events": 1, "busy_s": 1, "window_s": 2}
    # 1.675 MB at 3.35 TB/s is 0.5 us: half of the 1 us the kernel took
    assert manifest.load_reader("rank_decode_roofline")(
        _record(trace=t)) == pytest.approx(50)
    assert manifest.load_reader("rank_decode_roofline")(
        _record(trace=t, device={"kind": "other card"})) is None


def test_records_wrong_counts_changed_and_missing_records():
    a = b">h1\nAC\n>h2\nGT\n>h3\nTT\n"
    assert harness.records_wrong(a, a) == 0
    assert harness.records_wrong(a.replace(b"GT", b"GA"), a) == 1
    assert harness.records_wrong(a[: a.index(b">h3")], a) == 1
