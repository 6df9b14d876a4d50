"""The emission's two spans, ``call_emit.align`` and ``call_emit.format``
(``call.align_s``, ``call.format_s``): their readers on a synthetic run
record, and both read from a traced run of every cell on the CPU at a tiny
recipe, inside the ``call_emit.write`` span that holds them."""

import json
import time
from pathlib import Path

import pytest

from portbench import harness, manifest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in manifest.load(ROOT)["workloads"]]
TINY = {"genome_length": 12000}
SPANS = {"call.align_s": "call_emit.align",
         "call.format_s": "call_emit.format"}


def _record(samples):
    return {"positions": 1000, "setup_s": 3.0, "peak_bytes": 36000,
            "window": {"seconds": 4.5, "samples": len(samples),
                       "positions": 1000 * len(samples)},
            "samples": samples, "device": {"kind": "NVIDIA H100 80GB HBM3"},
            "peaks": {}, "trace": None}


@pytest.mark.parametrize("metric", sorted(SPANS))
def test_reader_means_over_samples_and_reads_nothing_without(metric):
    key = SPANS[metric]
    read = manifest.load_reader(metric)
    samples = [{"seconds": {"call_emit.write": 0.5, key: s}}
               for s in (0.1, 0.2, 0.6)]
    assert read(_record(samples)) == pytest.approx(0.3)
    # the parent's samples: call_emit.write without its two parts
    assert read(_record([{"seconds": {"call_emit.write": 0.2}}])) is None
    assert read(_record([])) is None


def test_declared_for_every_cell():
    bench = manifest.load(ROOT)
    declared = {m["name"]: m for m in bench["per_layer"]}
    for metric in SPANS:
        m = declared[metric]
        assert "workloads" not in m
        assert (m["source"], m["moves"], m["unit"], m["better"]) == \
            ("program_span", "positions_per_s", "s", "lower")
        assert m["layer"] == declared["call.write_s"]["layer"]


@pytest.mark.parametrize("workload", CELLS)
def test_read_from_a_traced_run(capsys, workload):
    harness.prepare_environment(ROOT)
    cell = manifest.cell(ROOT, workload)
    rc = harness.run(cell, 2**31 + 29, 0.5, True, "cpu", time.perf_counter(),
                     TINY)
    out, err = capsys.readouterr()
    assert rc == 0, err[-3000:]
    res = json.loads(out.strip().splitlines()[-1])
    assert res["correct"] is True
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(SPANS) <= set(got)
    assert 0 < got["call.align_s"] + got["call.format_s"] <= \
        got["call.write_s"]
