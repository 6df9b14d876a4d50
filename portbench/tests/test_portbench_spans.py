"""The readers of the program's nested spans on a synthetic run record:
each is the mean of its span's seconds over the window's samples, and
reads nothing where the program has no such span."""

import pytest

from portbench import manifest

# per-layer metric -> the span of stats["seconds"] it reads
SPANS = {
    "index.pack_s": "index.pack",
    "index.upload_s": "index.upload",
    "index.da_side_s": "index.da_side",
    "traverse.node_wait_s": "node_phase.wait",
    "call.walks_s": "call_emit.walks",
    "call.write_s": "call_emit.write",
    "call.da_rank_s": "call_emit.da_rank",
}


def _record(samples):
    return {"positions": 1000, "setup_s": 3.0, "peak_bytes": 36000,
            "window": {"seconds": 4.5, "samples": len(samples),
                       "positions": 1000 * len(samples)},
            "samples": samples, "device": {"kind": "NVIDIA H100 80GB HBM3"},
            "peaks": {}, "trace": None}


@pytest.mark.parametrize("metric", sorted(SPANS))
def test_span_reader_means_over_samples(metric):
    key = SPANS[metric]
    samples = [{"seconds": {"index": 0.3, key: 0.1}, "launches": 485},
               {"seconds": {"index": 0.3, key: 0.2}, "launches": 485},
               {"seconds": {"index": 0.3, key: 0.6}, "launches": 485}]
    assert manifest.load_reader(metric)(_record(samples)) == \
        pytest.approx(0.3)


@pytest.mark.parametrize("metric", sorted(SPANS))
def test_span_reader_reads_nothing_without_the_span(metric):
    # the parent's samples: the five phases only
    samples = [{"seconds": {"index": 0.2, "leaf_phase": 0.1,
                            "node_phase": 0.5, "cluster": 0.35,
                            "call_emit": 0.3}, "launches": 485}]
    assert manifest.load_reader(metric)(_record(samples)) is None
    assert manifest.load_reader(metric)(_record([])) is None


def test_every_new_span_metric_is_declared():
    bench = manifest.load(manifest.BENCH.parent)
    declared = {m["name"]: m for m in bench["per_layer"]}
    for metric in SPANS:
        m = declared[metric]
        assert (m["source"], m["moves"], m["unit"]) == \
            ("program_span", "positions_per_s", "s")
    assert declared["index.da_side_s"]["workloads"] == ["mode3-ecoli25x-pair"]
    assert declared["call.da_rank_s"]["workloads"] == [
        "mode2-ecoli25x-pair", "mode3-ecoli25x-pair"]
