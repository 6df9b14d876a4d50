"""Mode 1 end to end: the port's .snp (ebwt2indel_torch, on the CPU) must be
byte-identical to the JAX package's on the same input and flags; plus the
port's CLI surface (help, missing file, forbidden character, the refused
-2 with -d)."""

import os

import numpy as np
import pytest

from ebwt2indel_tpu import cli as jcli
from ebwt2indel_tpu.models import pipeline as jpipeline
from ebwt2indel_tpu.tools import ebwt as jebwt
from ebwt2indel_tpu.tools import simulate as jsim
from ebwt2indel_tpu.utils.config import Config
from ebwt2indel_torch import cli
from ebwt2indel_torch.models import pipeline
from tests.test_parity import FLAG_SETS, apply_flags, make_dataset

_QUIET = {"log": lambda *a, **k: None}


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """The verify-skill dataset (.claude/skills/verify/SKILL.md) and the
    flag-matrix dataset of tests/test_parity.py, built once."""
    d = tmp_path_factory.mktemp("torch_pipeline")
    rng = np.random.default_rng(7)
    g = jsim.random_genome(rng, 8000)
    h2, _ = jsim.plant_variants(rng, g, snp_rate=0.004, indel_rate=0.001)
    reads = jsim.sample_reads(rng, g, 6, 80) + jsim.sample_reads(rng, h2, 6, 80)
    verify = str(d / "verify.ebwt")
    with open(verify, "w") as f:
        f.write(jebwt.ebwt_of_reads(reads))
    os.makedirs(d / "flags")
    flags, _ = make_dataset(str(d / "flags"), np.random.default_rng(0xEB37))
    return {"verify": verify, "flags": flags, "dir": d}


def _both(path, out_dir, extra, name):
    jout = os.path.join(out_dir, f"{name}_jax.snp")
    tout = os.path.join(out_dir, f"{name}_torch.snp")
    jst = jpipeline.run_one_dataset(
        apply_flags(Config(input1=path, output=jout), extra), **_QUIET)
    tst = pipeline.run_one_dataset(
        apply_flags(Config(input1=path, output=tout), extra), device="cpu",
        **_QUIET)
    return open(jout, "rb").read(), open(tout, "rb").read(), jst, tst


def test_verify_dataset_byte_identical(datasets):
    want, got, jst, tst = _both(datasets["verify"], datasets["dir"], [],
                                "verify")
    assert got == want and len(got) > 0
    for k in ("events", "cluster_nr", "leaves", "nodes", "lcp_values",
              "n_min", "n_clusters"):
        assert tst[k] == jst[k], k
    assert set(tst["seconds"]) == {"index", "index.pack", "index.upload",
                                   "leaf_phase", "node_phase",
                                   "node_phase.wait", "cluster",
                                   "cluster.next_set", "call_emit",
                                   "call_emit.walks", "call_emit.write",
                                   "call_emit.align", "call_emit.format"}


@pytest.mark.parametrize("extra", FLAG_SETS)
def test_flag_sets_byte_identical(datasets, extra):
    want, got, _, _ = _both(datasets["flags"], datasets["dir"], extra,
                            "flags" + "".join(extra))
    assert got == want
    assert tuple(extra) == ("-q", "1") or len(got) > 0


def test_cli_mode1_matches_pipeline(datasets, capsys):
    out = str(datasets["dir"] / "cli.snp")
    assert cli.main(["-1", datasets["verify"], "-o", out], device="cpu") == 0
    text = capsys.readouterr().out
    assert "This is ebwt2InDel (PyTorch/CUDA build)." in text
    assert "Phase 4/4: detecting SNPs and indels." in text
    ref = str(datasets["dir"] / "cli_ref.snp")
    pipeline.run_one_dataset(Config(input1=datasets["verify"], output=ref),
                             device="cpu", **_QUIET)
    assert open(out, "rb").read() == open(ref, "rb").read()


def test_cli_help_and_missing_file(tmp_path, capsys):
    assert cli.main([], device="cpu") == 0
    assert capsys.readouterr().out == cli.help_text() + "\n"
    assert cli.main(["-h", "x"], device="cpu") == 0
    assert cli.help_text() == jcli.help_text()
    missing = str(tmp_path / "nope.ebwt")
    assert cli.main(["-1", missing, "-o", "o.snp"], device="cpu") == 1
    assert f"Error: could not find file {missing}" in capsys.readouterr().out
    assert cli.main(["-1", missing], device="cpu") == 1  # no -o


def test_cli_forbidden_character(tmp_path, capsys):
    bad = tmp_path / "bad.ebwt"
    bad.write_text("ACGT#ACNGT#")
    out = str(tmp_path / "o.snp")
    assert cli.main(["-1", str(bad), "-o", out], device="cpu") == 1
    got = capsys.readouterr().out.strip().splitlines()[-1]
    assert jcli.main(["-1", str(bad), "-o", out]) == 1
    want = capsys.readouterr().out.strip().splitlines()[-1]
    assert got == want and "forbidden character 'N' (ASCII code 78)" in got


def test_cli_refuses_modes_2_and_3(tmp_path, capsys):
    """-2 together with -d is refused, as the reference refuses it; -2 or -d
    alone now runs its mode (modes 2 and 3 are ported)."""
    a = tmp_path / "a.ebwt"
    a.write_text("AC#GT#")
    da = tmp_path / "a.da"
    da.write_text("010110")
    out = str(tmp_path / "o.snp")
    assert cli.main(["-1", str(a), "-2", str(a), "-d", str(da), "-o", out],
                    device="cpu") == 1
    assert "Document array (-d) can only be used" in capsys.readouterr().out
    assert not os.path.exists(out)
    assert cli.main(["-1", str(a), "-2", str(a), "-o", out],
                    device="cpu") == 0
    assert "Running on two samples." in capsys.readouterr().out
    assert os.path.exists(out)
    os.remove(out)
    assert cli.main(["-1", str(a), "-d", str(da), "-o", out],
                    device="cpu") == 0
    assert "input Document array" in capsys.readouterr().out
    assert os.path.exists(out)
