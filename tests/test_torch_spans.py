"""The port's span helper (``ebwt2indel_torch/utils/profile.py``) on the
CPU: nested spans, repeats that add up, a worker thread's span in its run's
record, the host-time fallback of a device span; and in each run mode,
the parts of ``index`` and ``call_emit`` within their phase, and the CLI's
``[timing] spans`` line holding the run's record, after its ``[emit]
counts`` line."""

import contextvars
import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from ebwt2indel_torch import cli
from ebwt2indel_torch.models import emit_vec, pipeline
from ebwt2indel_torch.tools import ebwt, simulate
from ebwt2indel_torch.utils import profile
from ebwt2indel_torch.utils.config import Config

_QUIET = {"log": lambda *a, **k: None}
NAP = 0.02  # seconds a timed stretch sleeps


def _run(body):
    """``body()`` as a recorded run; returns the run's seconds."""
    return profile.recorded(lambda: body() or {})()["seconds"]


def test_nested_spans_and_repeats_add_up():
    def body():
        with profile.span("a") as outer:
            for _ in range(3):
                with profile.span("a.b"):
                    time.sleep(NAP)
            assert profile.spent("a.b") >= 3 * NAP
            assert profile.spent("a") == 0.0  # not yet exited
        assert profile.spent("a") == outer.seconds

    sec = _run(body)
    assert set(sec) == {"a", "a.b"}
    assert 3 * NAP <= sec["a.b"] <= sec["a"]


def test_span_outside_a_run_records_nothing():
    with profile.span("x") as sp:
        time.sleep(NAP)
    assert sp.seconds >= NAP and profile.spent("x") == 0.0


def test_record_closed_after_a_run_that_raises():
    def body():
        with profile.span("a"):
            raise ValueError("stop")

    with pytest.raises(ValueError):
        _run(body)
    assert profile._RUN.get() is None


def test_worker_thread_adds_under_its_own_span_only():
    """A worker started in a copy of the run's context adds its span to the
    run's record while the main thread's spans run beside it, and nothing
    of it reaches theirs; a worker started without the copy adds
    nothing."""
    started = threading.Event()

    def worker(name):
        with profile.span(name):
            started.set()
            time.sleep(10 * NAP)

    def body():
        with ThreadPoolExecutor(2) as ex:
            fut = ex.submit(contextvars.copy_context().run, worker,
                            "index.da_side")
            bare = ex.submit(worker, "elsewhere")
            assert started.wait(5)
            with profile.span("index"):
                with profile.span("index.upload"):
                    time.sleep(NAP)
            fut.result(timeout=5)
            bare.result(timeout=5)

    sec = _run(body)
    assert set(sec) == {"index", "index.upload", "index.da_side"}
    assert NAP <= sec["index.upload"] <= sec["index"]
    assert sec["index.da_side"] >= 10 * NAP


def test_device_span_on_the_cpu_takes_host_time():
    def body():
        with profile.span("d", device=torch.device("cpu")) as sp:
            time.sleep(NAP)
        assert profile.spent("d") == sp.seconds >= NAP

    sec = _run(body)
    assert set(sec) == {"d"} and sec["d"] >= NAP


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Small inputs of the three modes: one read set, two read sets, and
    their merged eBWT and document array."""
    d = tmp_path_factory.mktemp("torch_spans")
    rng = np.random.default_rng(0x5BA7)
    genome = simulate.random_genome(rng, 2000)
    hap2, _ = simulate.plant_variants(rng, genome, snp_rate=0.004,
                                      indel_rate=0.001)
    r1 = simulate.sample_reads(rng, genome, 8, 80)
    r2 = simulate.sample_reads(rng, hap2, 8, 80)
    (d / "r.ebwt").write_text(ebwt.ebwt_of_reads(r1 + r2))
    (d / "a.ebwt").write_text(ebwt.ebwt_of_reads(r1))
    (d / "b.ebwt").write_text(ebwt.ebwt_of_reads(r2))
    bwt, da = ebwt.ebwt_and_da_of_two(r1, r2)
    (d / "m.ebwt").write_text(bwt)
    (d / "m.da").write_text(da)
    return d


_MODES = {
    1: (pipeline.run_one_dataset, {"input1": "r.ebwt"}, ()),
    2: (pipeline.run_two_datasets, {"input1": "a.ebwt", "input2": "b.ebwt"},
        ("call_emit.da_rank",)),
    3: (pipeline.run_two_datasets_da, {"input1": "m.ebwt",
                                       "input_da": "m.da"},
        ("index.da_side", "da_wait", "call_emit.da_rank")),
}
_COMMON = {"index", "index.pack", "index.upload", "leaf_phase", "node_phase",
           "node_phase.wait", "cluster", "cluster.next_set", "call_emit",
           "call_emit.walks", "call_emit.write",
           "call_emit.align", "call_emit.format"}


@pytest.mark.parametrize("mode", [1, 2, 3])
def test_parts_within_their_phase(inputs, mode):
    """``index.pack`` and ``index.upload`` run one after the other inside
    ``index``, ``call_emit.walks`` and ``call_emit.write`` inside
    ``call_emit``; the DA rank inside the walks, the node steps' waits
    inside the node phase, the anchor table's build inside ``cluster``.
    (Mode 3's ``index.da_side`` runs in a worker
    beside phases 1-3, no part of ``index``'s time.)"""
    run, paths, extra = _MODES[mode]
    st = run(Config(output=str(inputs / f"m{mode}.snp"),
                    **{k: str(inputs / v) for k, v in paths.items()}),
             device="cpu", **_QUIET)
    sec = st["seconds"]
    assert set(sec) == _COMMON | set(extra) and st["events"] > 0
    assert sec["index.pack"] + sec["index.upload"] <= sec["index"]
    assert sec["call_emit.walks"] + sec["call_emit.write"] <= \
        sec["call_emit"]
    assert sec["call_emit.align"] + sec["call_emit.format"] <= \
        sec["call_emit.write"]
    assert sec["node_phase.wait"] <= sec["node_phase"]
    assert sec["cluster.next_set"] <= sec["cluster"]
    if "call_emit.da_rank" in sec:
        assert sec["call_emit.da_rank"] <= sec["call_emit.walks"]


def test_cli_logs_the_runs_spans(inputs, capsys):
    out = str(inputs / "cli.snp")
    assert cli.main(["-1", str(inputs / "r.ebwt"), "-o", out],
                    device="cpu") == 0
    counts, last = capsys.readouterr().out.rstrip("\n").splitlines()[-2:]
    assert last.startswith("[timing] spans {")
    sec = json.loads(last[len("[timing] spans "):])
    assert set(sec) == _COMMON and all(v >= 0 for v in sec.values())
    assert counts.startswith("[emit] counts {")
    got = json.loads(counts[len("[emit] counts "):])
    assert tuple(got) == emit_vec.SINGLE_COUNTS and got["records"] > 0
