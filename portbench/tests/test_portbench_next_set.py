"""The reader of the anchor table's span (``cluster.next_set_s``) on a
synthetic run record: the mean of the span's seconds over the window's
samples, nothing where the program has no such span, and its entry in
``BENCHMARK.json``."""

import pytest

from portbench import manifest

METRIC = "cluster.next_set_s"


def _record(samples):
    return {"positions": 1000, "setup_s": 3.0, "peak_bytes": 20000,
            "window": {"seconds": 4.5, "samples": len(samples),
                       "positions": 1000 * len(samples)},
            "samples": samples, "device": {"kind": "NVIDIA H100 80GB HBM3"},
            "peaks": {}, "trace": None}


def test_reads_the_span_mean_over_samples():
    samples = [{"seconds": {"cluster": 0.02, "cluster.next_set": t},
                "launches": 485} for t in (0.001, 0.002, 0.006)]
    assert manifest.load_reader(METRIC)(_record(samples)) == \
        pytest.approx(0.003)


def test_reads_nothing_without_the_span():
    # a program without the span: the phases and some of their parts
    samples = [{"seconds": {"index": 0.2, "leaf_phase": 0.1,
                            "node_phase": 0.5, "cluster": 0.35,
                            "call_emit": 0.3, "call_emit.walks": 0.2},
                "launches": 485}]
    assert manifest.load_reader(METRIC)(_record(samples)) is None
    assert manifest.load_reader(METRIC)(_record([])) is None


def test_declared_beside_the_cluster_phase():
    bench = manifest.load(manifest.BENCH.parent)
    declared = {m["name"]: m for m in bench["per_layer"]}
    m = declared[METRIC]
    assert (m["source"], m["moves"], m["unit"], m["better"]) == \
        ("program_span", "positions_per_s", "s", "lower")
    assert m["layer"] == declared["cluster.cluster_s"]["layer"]
    assert "workloads" not in m
