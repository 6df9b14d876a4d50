"""The port's scale tools: ``ebwt2indel_torch/tools/genhuge.py`` writes the
bytes of the repo-root ``tools/genhuge.py`` for the same arguments, and
``ebwt2indel_torch/tools/run_huge.py`` writes a report with the keys of the
JAX package's REPORT_*.json plus its device (here on the CPU)."""

import importlib.util
import json
import os

import numpy as np
import pytest

from ebwt2indel_tpu.tools import ebwt as jebwt
from ebwt2indel_torch.tools import genhuge, run_huge

REPO = os.path.join(os.path.dirname(__file__), "..")


def _root_genhuge():
    spec = importlib.util.spec_from_file_location(
        "root_genhuge", os.path.join(REPO, "tools", "genhuge.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_genhuge_bytes_match_root_tool(tmp_path, monkeypatch):
    """A 20 kbp genome at 25x: the same eBWT bytes as the repo-root tool."""
    want = tmp_path / "root.ebwt"
    monkeypatch.setattr("sys.argv", ["genhuge.py", "20000", str(want)])
    _root_genhuge().main()
    got = tmp_path / "port.ebwt"
    assert genhuge.main(["20000", str(got)]) == 0
    assert got.read_bytes() == want.read_bytes()
    assert os.path.getsize(got) > 20000 * 25


def test_read_matrix_builder_matches_ebwt_of_reads(rng):
    """The one-matrix builder gives ebwt_of_reads' suffix order."""
    reads = ["".join(rng.choice(list("ACGT"), size=30)) for _ in range(40)]
    text = np.frombuffer("".join(r + "#" for r in reads).encode(),
                         np.uint8).reshape(40, 31)
    got = genhuge.ebwt_of_read_matrix(text.copy()).tobytes().decode()
    assert got == jebwt.ebwt_of_reads(reads)


@pytest.mark.parametrize("extra", [["--skip-ref"], []])
def test_run_huge_report(tmp_path, extra, capsys):
    """Cold and warm runs fill the REPORT_*.json keys and the device; the
    reference leg runs only where .ref_build/ebwt2InDel exists."""
    inp = tmp_path / "in.ebwt"
    n = genhuge.build(2000, str(inp), coverage=10, log=lambda *a: None)
    rep = tmp_path / "rep.json"
    rc = run_huge.main([str(inp), str(tmp_path / "out.snp"), str(rep),
                        "--device", "cpu", *extra])
    assert rc == 0
    got = json.loads(rep.read_text())
    root_keys = {"metric", "value", "unit", "positions", "warm_seconds",
                 "cold_seconds", "ref_seconds", "parity", "vs_baseline"}
    assert set(got) == root_keys | {"device"}
    assert got["positions"] == n and got["unit"] == "pos/s"
    assert got["cold_seconds"] > 0 and got["warm_seconds"] > 0
    assert got["value"] == pytest.approx(n / got["warm_seconds"])
    assert got["device"] == {"platform": "cpu", "kind": "cpu", "count": 1}
    ran_ref = not extra and os.path.isfile(run_huge.REF_BIN)
    assert got["parity"] is (True if ran_ref else None)
    assert "reference leg skipped" in capsys.readouterr().out or ran_ref
    assert (tmp_path / "out.snp").stat().st_size > 0
