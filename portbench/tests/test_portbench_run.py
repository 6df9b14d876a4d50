"""Whole runs of the harness on the CPU at a tiny recipe, its look for a
card skipped: sound runs are correct, the timed path broken underneath is
not, the control is not, and nothing forbidden is loaded."""

import io
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from portbench import control, harness, manifest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in manifest.load(ROOT)["workloads"]]
TINY = {"genome_length": 12000, "snp_rate": 0.01, "indel_rate": 0.002}


def _run(capsys, workload, seed=2**31 + 3, trace=False):
    harness.prepare_environment(ROOT)
    cell = manifest.cell(ROOT, workload)
    rc = harness.run(cell, seed, 0.5, trace, "cpu", time.perf_counter(),
                     TINY)
    out, err = capsys.readouterr()
    assert rc == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1]), err


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(capsys, workload, trace):
    res, err = _run(capsys, workload, trace=trace)
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    assert list(res)[-1] == "compared"
    assert err.strip().splitlines()[-1] == "records_wrong 0 limit 0"
    cell = manifest.cell(ROOT, workload)
    want = cell.per_layer if trace else cell.end_to_end
    got = set(res["metrics"])
    # on the CPU the card's peak and device trace read nothing
    assert got <= {m.name for m in want}
    if trace:
        assert {"index.index_s", "traverse.node_s", "call.call_emit_s"} <= got
        assert ("index.da_wait_s" in got) == (workload.startswith("mode3"))
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert {"positions_per_s", "setup_s"} <= got
    assert harness.forbidden_modules() == []


def _frozen(body, at):
    """``body`` writing its flags (argument ``at``) into a copy: the
    traversal's state comes back unchanged."""
    def run(*a):
        a = list(a)
        a[at] = a[at].clone()
        return body(*a)
    return run


def _half(fn):
    def run(*a, **k):
        next_thr, cl = fn(*a, **k)
        keep = cl.n_clusters // 2
        cl.begins, cl.ends = cl.begins[:keep], cl.ends[:keep]
        cl.n_clusters = keep
        return next_thr, cl
    return run


def _altered(fn):
    def run(out_f, *a, **k):
        buf = io.StringIO()
        r = fn(buf, *a, **k)
        text = buf.getvalue()
        i = text.find("\n") + 1  # the first base of the first record
        if i:
            text = text[:i] + ("A" if text[i] != "A" else "C") + text[i + 1:]
        out_f.write(text)
        return r
    return run


def _break(monkeypatch, fault):
    from ebwt2indel_torch.models import emit_vec, pipeline, traverse

    if fault == "state_unchanged":
        for name, at in (("_node_body", 2), ("_node_pair_body", 3)):
            monkeypatch.setattr(traverse, name,
                                _frozen(getattr(traverse, name), at))
    elif fault == "half_left_out":
        monkeypatch.setattr(pipeline, "_anchor_and_clusters",
                            _half(pipeline._anchor_and_clusters))
    else:
        for name in ("emit_single", "emit_pair"):
            monkeypatch.setattr(emit_vec, name,
                                _altered(getattr(emit_vec, name)))


@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out",
                                   "answer_altered"])
@pytest.mark.parametrize("workload", CELLS)
def test_broken_timed_path_is_not_correct(capsys, monkeypatch, workload,
                                          fault):
    _break(monkeypatch, fault)
    res, err = _run(capsys, workload)
    assert res["correct"] is False
    assert res["failed"] == res["attempted"]
    assert res["compared"]["records_wrong"]["value"] > 0
    assert "records_wrong" in err.strip().splitlines()[-1]


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    cell = manifest.cell(ROOT, workload)
    for seed in (1, 2, 2**31 + 9):
        r = control.readings(cell, seed, "cpu", TINY)
        assert r["samples_wrong"] == 1 and r["records_wrong"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_at_cell_size(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control at the cell's size")
    cell = manifest.cell(ROOT, workload)
    for seed in (11, 12, 13):
        assert control.readings(cell, seed, "cuda")["records_wrong"] > 0


def _top_level(code: str) -> set[str]:
    out = subprocess.run(
        [sys.executable, "-c", f"import sys; sys.path.insert(0, "
         f"{str(ROOT)!r}); {code}; print(','.join(sorted("
         "{m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, check=True)
    return set(out.stdout.strip().split(","))


def test_reference_imports_neither_jax_nor_the_program():
    names = _top_level("import portbench.reference.calls")
    assert not names & {"jax", "jaxlib", "flax", "ebwt2indel_tpu",
                        "ebwt2indel_torch"}


def test_harness_imports_no_jax():
    names = _top_level(
        "from portbench import harness, manifest, control, tracing; "
        "from pathlib import Path; "
        f"[manifest.cell(Path({str(ROOT)!r}), w) for w in {CELLS!r}]; "
        "import ebwt2indel_torch.cli")
    assert not names & {"jax", "jaxlib", "flax", "ebwt2indel_tpu"}


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal where there is no CUDA device")
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1"],
                       cwd=ROOT, capture_output=True, text=True)
    assert r.returncode == 2 and r.stdout == ""
