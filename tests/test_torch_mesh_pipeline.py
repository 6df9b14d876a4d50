"""Mode 1 on the port's position mesh end to end: the .snp of
run_one_dataset_sharded at S = 1, 3 and 8 equals the JAX package's
run_one_dataset_sharded on its 8-device virtual CPU mesh and the port's
single-device .snp; the CLI switch (EBWT_MESH) in a subprocess; two gloo
processes of two shards each joined through EBWT_COORD; and the refusals."""

import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest

from ebwt2indel_tpu.parallel import pipeline as jppipe
from ebwt2indel_tpu.parallel import shard as jshard
from ebwt2indel_tpu.utils.config import Config
from ebwt2indel_torch import cli
from ebwt2indel_torch.models import pipeline
from ebwt2indel_torch.parallel import mesh
from ebwt2indel_torch.parallel import pipeline as ppipe
from tests.test_parity import make_dataset

REPO = os.path.join(os.path.dirname(__file__), "..")
_QUIET = {"log": lambda *a, **k: None}
_STATS = ("events", "cluster_nr", "leaves", "nodes", "lcp_values", "n_min",
          "n_clusters")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The JAX mesh tests' dataset (5,000 bp, 12x), with the port's
    single-device .snp and the JAX package's 8-device mesh .snp."""
    d = tmp_path_factory.mktemp("torch_mesh")
    path, _ = make_dataset(str(d), np.random.default_rng(0xEB37),
                           genome_len=5000, coverage=12)
    one = str(d / "one.snp")
    stats = pipeline.run_one_dataset(Config(input1=path, output=one),
                                     device="cpu", **_QUIET)
    jout = str(d / "jax_mesh.snp")
    jppipe.run_one_dataset_sharded(Config(input1=path, output=jout),
                                   jshard.make_mesh(8), **_QUIET)
    return {"path": path, "dir": d, "one": open(one, "rb").read(),
            "jax": open(jout, "rb").read(), "stats": stats}


@pytest.mark.parametrize("S", [1, 3, 8])
def test_sharded_snp_matches_jax_and_single_device(data, S):
    out = str(data["dir"] / f"mesh{S}.snp")
    st = ppipe.run_one_dataset_sharded(Config(input1=data["path"],
                                              output=out),
                                       mesh.Mesh(S, device="cpu"), **_QUIET)
    got = open(out, "rb").read()
    assert data["jax"] == data["one"] and len(got) > 0
    assert got == data["one"]
    for k in _STATS:
        assert st[k] == data["stats"][k], k
    assert set(st["seconds"]) == {"index", "leaf_phase", "node_phase",
                                  "cluster", "call_emit"}


def _port_cli(args, env_extra):
    env = dict(os.environ, PYTHONPATH=REPO, **env_extra)
    code = ("import sys; from ebwt2indel_torch import cli; "
            "raise SystemExit(cli.main(sys.argv[1:], device='cpu'))")
    return subprocess.Popen([sys.executable, "-c", code, *args], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def test_cli_mesh_switch_subprocess(data):
    """EBWT_MESH=8 routes the CLI through the mesh: the banner names it,
    and the .snp equals the single-device one."""
    out = str(data["dir"] / "cli_mesh.snp")
    p = _port_cli(["-1", data["path"], "-o", out], {"EBWT_MESH": "8"})
    stdout, stderr = p.communicate(timeout=300)
    assert p.returncode == 0, stderr
    assert "(8-device mesh)" in stdout
    assert open(out, "rb").read() == data["one"]


def test_two_gloo_processes(data):
    """Two processes of two shards each over gloo, joined through
    EBWT_COORD/EBWT_NPROCS/EBWT_PROCID: process 0's .snp and process 1's
    replica equal the single-device .snp, and each process packed about
    half the input."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out = str(data["dir"] / "dist.snp")
    procs = [_port_cli(["-1", data["path"], "-o", out],
                       {"EBWT_MESH": "4", "EBWT_COORD": f"localhost:{port}",
                        "EBWT_NPROCS": "2", "EBWT_PROCID": str(k)})
             for k in range(2)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (stdout, stderr) in zip(procs, outs):
        assert p.returncode == 0, f"{stdout}\n{stderr}"
        assert "(4-device mesh)" in stdout
    assert open(out, "rb").read() == data["one"]
    assert open(out + ".proc1", "rb").read() == data["one"]
    n = os.path.getsize(data["path"])
    packed = 0
    for k, (stdout, _) in enumerate(outs):
        m = re.search(r"\[loader\] process (\d+) packed (\d+)/(\d+)", stdout)
        assert m and int(m.group(1)) == k and int(m.group(3)) == n
        assert int(m.group(2)) <= n // 2 + 2 * 128  # half and a row a shard
        packed += int(m.group(2))
    assert packed == n


def test_mesh_refuses_pair_modes_and_bad_input(tmp_path, monkeypatch,
                                               capsys):
    """Under EBWT_MESH > 1, -2 and -d exit 1 with an error that names the
    next slice (no fallback to one device, no output); a forbidden
    character gives the reference's message and exit 1; and the mesh, like
    every entry point, needs CUDA unless the CPU is asked for."""
    a = tmp_path / "a.ebwt"
    a.write_text("AC#GT#")
    da = tmp_path / "a.da"
    da.write_text("010110")
    out = tmp_path / "o.snp"
    monkeypatch.setenv("EBWT_MESH", "2")
    for extra in (["-2", str(a)], ["-d", str(da)]):
        assert cli.main(["-1", str(a), *extra, "-o", str(out)],
                        device="cpu") == 1
        err = capsys.readouterr().err
        assert "do not run on a mesh yet" in err and "next slice" in err
        assert not out.exists()
    bad = tmp_path / "bad.ebwt"
    bad.write_text("ACGT#ACNGT#")
    assert cli.main(["-1", str(bad), "-o", str(out)], device="cpu") == 1
    assert "forbidden character 'N' (ASCII code 78)" in \
        capsys.readouterr().out
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            mesh.Mesh(2)
