"""The port's position mesh end to end: the mode-1 .snp of
run_one_dataset_sharded at S = 1, 3 and 8 equals the JAX package's
run_one_dataset_sharded on its 8-device virtual CPU mesh and the port's
single-device .snp; the CLI switch (EBWT_MESH) in a subprocess; two gloo
processes of two shards each joined through EBWT_COORD, in modes 1, 3 and
2; the pair modes through the CLI switch, with a checkpoint directory too;
and the refusals (a forbidden character, no CUDA)."""

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
from ebwt2indel_torch.tools import ebwt, simulate
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
                                  "cluster", "call_emit", "call_emit.walks",
                                  "call_emit.write",
                                  "call_emit.align", "call_emit.format"}


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """A small pair input (3,000 bp, 6x of 80 bp reads per haplotype) as
    two eBWTs (mode 2) and as a merged eBWT with its document array (mode
    3), with the port's single-device .snp of each mode."""
    d = tmp_path_factory.mktemp("torch_mesh_pair")
    rng = np.random.default_rng(0x9A1)
    genome = simulate.random_genome(rng, 3000)
    hap2, _ = simulate.plant_variants(rng, genome, snp_rate=0.004,
                                      indel_rate=0.001)
    reads1 = simulate.sample_reads(rng, genome, 6, 80)
    reads2 = simulate.sample_reads(rng, hap2, 6, 80)
    p = {k: str(d / k) for k in ("a.ebwt", "b.ebwt", "m.ebwt", "m.da")}
    open(p["a.ebwt"], "w").write(ebwt.ebwt_of_reads(reads1))
    open(p["b.ebwt"], "w").write(ebwt.ebwt_of_reads(reads2))
    bwt, da = ebwt.ebwt_and_da_of_two(reads1, reads2)
    open(p["m.ebwt"], "w").write(bwt)
    open(p["m.da"], "w").write(da)
    args = {3: ["-1", p["m.ebwt"], "-d", p["m.da"]],
            2: ["-1", p["a.ebwt"], "-2", p["b.ebwt"]]}
    one = {}
    for mode, run in ((3, pipeline.run_two_datasets_da),
                      (2, pipeline.run_two_datasets)):
        out = str(d / f"one{mode}.snp")
        cfg = Config(input1=args[mode][1], output=out)
        if mode == 3:
            cfg.input_da = p["m.da"]
        else:
            cfg.input2 = p["b.ebwt"]
        run(cfg, device="cpu", **_QUIET)
        one[mode] = open(out, "rb").read()
        assert one[mode]
    return {"dir": d, "args": args, "one": one}


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


@pytest.mark.parametrize("mode", [1, 3, 2])
def test_two_gloo_processes(data, pair, mode):
    """Two processes of two shards each over gloo, joined through
    EBWT_COORD/EBWT_NPROCS/EBWT_PROCID: process 0's .snp and process 1's
    replica equal the single-device .snp of the mode, and each process
    packed about half of input 1."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    if mode == 1:
        args, want, d = ["-1", data["path"]], data["one"], data["dir"]
    else:
        args, want, d = pair["args"][mode], pair["one"][mode], pair["dir"]
    out = str(d / f"dist{mode}.snp")
    procs = [_port_cli(args + ["-o", out],
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
    assert open(out, "rb").read() == want
    assert open(out + ".proc1", "rb").read() == want
    n = os.path.getsize(args[1])
    packed = 0
    for k, (stdout, _) in enumerate(outs):
        m = re.search(r"\[loader\] process (\d+) packed (\d+)/(\d+)", stdout)
        assert m and int(m.group(1)) == k and int(m.group(3)) == n
        assert int(m.group(2)) <= n // 2 + 2 * 128  # half and a row a shard
        packed += int(m.group(2))
    assert packed == n


def test_mesh_refuses_pair_modes_and_bad_input(pair, tmp_path, monkeypatch,
                                               capsys):
    """Under EBWT_MESH > 1, -2 and -d run on the mesh and write the single
    device's .snp; with EBWT_CKPT_DIR set every mode still exits 0 with the
    single device's .snp and leaves the checkpoint directory empty (the
    mesh saves and resumes; tests/test_torch_mesh_resume.py kills and
    resumes it); a forbidden character gives the reference's message and
    exit 1; and the mesh, like every entry point, needs CUDA unless the CPU
    is asked for."""
    out = tmp_path / "o.snp"
    monkeypatch.setenv("EBWT_MESH", "2")
    for mode in (3, 2):
        assert cli.main(pair["args"][mode] + ["-o", str(out)],
                        device="cpu") == 0
        assert "(2-device mesh)" in capsys.readouterr().out
        assert out.read_bytes() == pair["one"][mode]
        out.unlink()
    one1 = tmp_path / "one1.snp"
    pipeline.run_one_dataset(Config(input1=pair["args"][3][1],
                                    output=str(one1)), device="cpu", **_QUIET)
    ckpt = tmp_path / "ckpt"
    monkeypatch.setenv("EBWT_CKPT_DIR", str(ckpt))
    monkeypatch.setenv("EBWT_CKPT_EVERY", "2")
    for args, want in ((pair["args"][3][:2], one1.read_bytes()),
                       (pair["args"][3], pair["one"][3]),
                       (pair["args"][2], pair["one"][2])):
        assert cli.main(args + ["-o", str(out)], device="cpu") == 0
        assert "(2-device mesh)" in capsys.readouterr().out
        assert out.read_bytes() == want and want
        assert os.listdir(ckpt) == []
        out.unlink()
    monkeypatch.delenv("EBWT_CKPT_DIR")
    monkeypatch.delenv("EBWT_CKPT_EVERY")
    bad = tmp_path / "bad.ebwt"
    bad.write_text("ACGT#ACNGT#")
    assert cli.main(["-1", str(bad), "-o", str(out)], device="cpu") == 1
    assert "forbidden character 'N' (ASCII code 78)" in \
        capsys.readouterr().out
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            mesh.Mesh(2)
