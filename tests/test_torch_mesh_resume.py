"""Checkpoint and resume of the port's position mesh (``ckpt_dir`` and
``ckpt_every`` of ebwt2indel_torch/parallel/frontier.py), on the CPU: each
of the four mesh phases (leaf, node, leaf-pair, node-pair) killed after its
second save and run again gives the flags, fills, document array and stats
(the mesh steps and routed bytes among them) of the uninterrupted mesh run
and the flags of the JAX package's frontier traversal on its 8-device
virtual CPU mesh; a save of another input or of another S is not taken;
and two gloo processes, one of which lost its newest save, resume from
the step both hold or both start fresh. Everything compared is integer or
bytes, so the tolerance is 0."""

import os
import re
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from ebwt2indel_tpu.ops import packing as jpacking
from ebwt2indel_tpu.parallel import frontier as jfrontier
from ebwt2indel_tpu.parallel import shard as jshard
from ebwt2indel_tpu.utils import dna
from ebwt2indel_torch.models import pipeline, traverse
from ebwt2indel_torch.ops import packing
from ebwt2indel_torch.parallel import frontier, mesh, shard
from ebwt2indel_torch.tools import ebwt, simulate
from ebwt2indel_torch.utils.config import Config

REPO = os.path.join(os.path.dirname(__file__), "..")
K, K_RIGHT = 20, 30  # Config's defaults
S = 3
CHUNK = 64  # many mesh steps on a small index
EVERY = 3
_PHASES = {  # phase: (mode, step function, checkpoint tag)
    "leaf": (1, "_leaf_step", "m1leaf"),
    "node": (1, "_node_step", "m1node"),
    "leaf-pair": (2, "_leaf_pair_step", "pleaf"),
    "node-pair": (2, "_node_pair_step", "pnode"),
}
_FLAGS = {1: ("thr_K", "thr_R", "minima"),
          2: ("thr_K", "thr_R", "minima", "da")}


class _Preempted(Exception):
    pass


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A 4,000 bp genome and a second haplotype, 8x of 80 bp reads each:
    the eBWT of both read sets (mode 1) and of each (mode 2), packed, and
    the JAX package's frontier flags of each mode at S = 8."""
    d = tmp_path_factory.mktemp("torch_mesh_resume")
    rng = np.random.default_rng(0x5E5)
    genome = simulate.random_genome(rng, 4000)
    hap2, _ = simulate.plant_variants(rng, genome, snp_rate=0.004,
                                      indel_rate=0.001)
    reads1 = simulate.sample_reads(rng, genome, 8, 80)
    reads2 = simulate.sample_reads(rng, hap2, 8, 80)
    paths = {}
    for name, reads in (("m1", reads1 + reads2), ("a", reads1),
                        ("b", reads2)):
        paths[name] = str(d / f"{name}.ebwt")
        open(paths[name], "w").write(ebwt.ebwt_of_reads(reads))
    packs = {k: packing.pack_file(p) for k, p in paths.items()}
    jm = jshard.make_mesh(8)

    def jsfm(name):
        return jshard.shard_fm(jpacking.pack_codes(dna.str_to_codes(
            open(paths[name]).read())), jm)

    jax = {1: jfrontier.navigate_one_bwt_frontier_device(
               jsfm("m1"), K, K_RIGHT)[:3],
           2: jfrontier.navigate_two_bwts_frontier_device(
               jsfm("a"), jsfm("b"), K, K_RIGHT)[:4]}
    return {"dir": d, "paths": paths, "packs": packs,
            "n": {1: packs["m1"].n, 2: packs["a"].n + packs["b"].n},
            "jax": {m: [np.asarray(f) for f in v] for m, v in jax.items()}}


def _navigate(data, mode, S_=S, packs=None, **ckpt):
    """The mesh traversal of a mode at S_ shards: (flags gathered over the
    shards, stats without the seconds)."""
    m = mesh.Mesh(S_, device="cpu")
    if mode == 1:
        *flags, st = frontier.navigate_one_bwt_sharded(
            shard.shard_fm(packs or data["packs"]["m1"], m), K, K_RIGHT,
            **ckpt)
    else:
        *flags, st = frontier.navigate_two_bwts_sharded(
            shard.shard_fm(data["packs"]["a"], m),
            shard.shard_fm(data["packs"]["b"], m), K, K_RIGHT, **ckpt)
    gathered = [torch.cat([f[s] for s in sorted(f)]) for f in flags]
    return gathered, {k: v for k, v in st.items()
                      if not k.endswith("_seconds")}


class _TripWire:
    """Counts the calls of one mesh step function and the saves of one
    checkpoint tag; while armed, the step raises once ``after`` saves of
    its phase were written."""

    def __init__(self, monkeypatch, step: str, tag: str, after: int = 2):
        self.saves, self.steps, self.armed = 0, 0, True
        real_save = frontier._MeshCheckpoint.save
        real_step = getattr(frontier, step)

        def save(ckpt, *a):
            real_save(ckpt, *a)
            self.saves += ckpt.tag == tag

        def wrapped(*a, **k):
            if self.armed and self.saves >= after:
                raise _Preempted
            self.steps += 1
            return real_step(*a, **k)

        monkeypatch.setattr(frontier._MeshCheckpoint, "save", save)
        monkeypatch.setattr(frontier, step, wrapped)


def _files(tag, proc=0):
    return sorted([f"frontier_{tag}.p{proc}.prev.pt",
                   f"frontier_{tag}.p{proc}.pt"])


@pytest.mark.parametrize("phase", list(_PHASES))
def test_mesh_resume_gives_uninterrupted_run(data, phase, tmp_path,
                                             monkeypatch):
    mode, step, tag = _PHASES[phase]
    monkeypatch.setattr(traverse, "CHUNK", CHUNK)
    trip = _TripWire(monkeypatch, step, tag)
    trip.armed = False
    want, want_st = _navigate(data, mode)
    full_steps = trip.steps
    assert full_steps > 3 * EVERY

    trip.armed, trip.steps = True, 0
    ckpt = {"ckpt_dir": str(tmp_path), "ckpt_every": EVERY}
    with pytest.raises(_Preempted):
        _navigate(data, mode, **ckpt)
    assert sorted(os.listdir(tmp_path)) == _files(tag)
    assert trip.saves == 2 and trip.steps == 2 * EVERY

    trip.armed, trip.steps = False, 0
    got, got_st = _navigate(data, mode, **ckpt)
    assert os.listdir(tmp_path) == []
    # it resumed after the second save instead of starting over
    assert trip.steps == full_steps - 2 * EVERY
    assert got_st == want_st
    n = data["n"][mode]
    for name, g, w, j in zip(_FLAGS[mode], got, want, data["jax"][mode]):
        assert torch.equal(g, w), name
        np.testing.assert_array_equal(g[:n].numpy(), j[:n].astype(np.uint8),
                                      err_msg=name)
    if mode == 2:
        assert got_st["comm_bytes_per_step"] > 0


@pytest.mark.parametrize("other", ["input", "S"])
def test_checkpoint_of_another_run_is_ignored(data, other, tmp_path,
                                              monkeypatch, capsys):
    """A node-phase save of mode 1 at S = 3 is not taken by a run of another
    input (another n) or of another S: it runs in full, says once on stderr
    that it starts fresh, gives its own flags and removes the files."""
    monkeypatch.setattr(traverse, "CHUNK", CHUNK)
    trip = _TripWire(monkeypatch, "_node_step", "m1node")
    ckpt = {"ckpt_dir": str(tmp_path), "ckpt_every": EVERY}
    with pytest.raises(_Preempted):
        _navigate(data, 1, **ckpt)
    assert sorted(os.listdir(tmp_path)) == _files("m1node")
    capsys.readouterr()

    trip.armed = False
    run = ({"packs": data["packs"]["a"]} if other == "input"
           else {"S_": 2})
    trip.steps = 0
    want, want_st = _navigate(data, 1, **run)
    full_steps = trip.steps
    trip.steps = 0
    got, got_st = _navigate(data, 1, **run, **ckpt)
    assert trip.steps == full_steps
    err = capsys.readouterr().err
    assert err.count("[ckpt] frontier_m1node: no saved step") == 1, err
    assert "frontier_m1leaf" not in err
    assert got_st == want_st
    for name, g, w in zip(_FLAGS[1], got, want):
        assert torch.equal(g, w), name
    assert os.listdir(tmp_path) == []


# one process of a two-process CLI mesh run: with T_KILL set, its node step
# exits once T_KILL node-phase saves were written; it prints the node steps
# it took
_PROC = r"""
import os, sys
from ebwt2indel_torch import cli
from ebwt2indel_torch.models import traverse
from ebwt2indel_torch.parallel import frontier
traverse.CHUNK = int(os.environ["T_CHUNK"])
kill = int(os.environ.get("T_KILL", "0"))
count = {"saves": 0, "steps": 0}
real_save, real_step = frontier._MeshCheckpoint.save, frontier._node_step
def save(ckpt, *a):
    real_save(ckpt, *a)
    count["saves"] += ckpt.tag == "m1node"
def step(*a, **k):
    if kill and count["saves"] >= kill:
        raise SystemExit(3)
    count["steps"] += 1
    return real_step(*a, **k)
frontier._MeshCheckpoint.save, frontier._node_step = save, step
rc = cli.main(sys.argv[1:], device="cpu")
print(f"[test] node steps {count['steps']}", flush=True)
raise SystemExit(rc)
"""


def _two_processes(args, ckpt_dir, kill=0):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    for k in range(2):
        env = dict(os.environ, PYTHONPATH=REPO, EBWT_MESH="4",
                   EBWT_COORD=f"localhost:{port}", EBWT_NPROCS="2",
                   EBWT_PROCID=str(k), EBWT_CKPT_DIR=ckpt_dir,
                   EBWT_CKPT_EVERY=str(EVERY), T_CHUNK=str(CHUNK),
                   T_KILL=str(kill))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _PROC, *args], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    return [(p.returncode, out, err) for p, (out, err) in zip(procs, outs)]


def test_two_gloo_processes_agree_on_the_resume(data, tmp_path):
    """Two processes of two shards each, killed together after their second
    node-phase save (steps EVERY and 2 x EVERY on disk). Process 1's newest
    save lost: both resume from step EVERY. Process 1's saves all lost:
    both start fresh, and process 0 alone says so. Each time the .snp
    equals the single device's and the checkpoint directory ends empty."""
    single = tmp_path / "single.snp"
    pipeline.run_one_dataset(Config(input1=data["paths"]["m1"],
                                    output=str(single)),
                             device="cpu", log=lambda *a, **k: None)
    ckpt = tmp_path / "ckpt"
    out = tmp_path / "mesh.snp"
    args = ["-1", data["paths"]["m1"], "-o", str(out)]
    killed = _two_processes(args, str(ckpt), kill=2)
    assert [rc for rc, _, _ in killed] == [3, 3], killed
    assert sorted(os.listdir(ckpt)) == sorted(_files("m1node", 0)
                                              + _files("m1node", 1))
    saved = tmp_path / "saved"
    shutil.copytree(ckpt, saved)

    for lost, resumed_at in ((["frontier_m1node.p1.pt"], EVERY),
                             (_files("m1node", 1), 0)):
        shutil.rmtree(ckpt)
        shutil.copytree(saved, ckpt)
        for f in lost:
            os.remove(ckpt / f)
        runs = _two_processes(args, str(ckpt))
        for k, (rc, stdout, stderr) in enumerate(runs):
            assert rc == 0, f"{stdout}\n{stderr}"
            (total,) = re.findall(r"\(\d+ and (\d+) mesh steps\)", stdout)
            (took,) = re.findall(r"\[test\] node steps (\d+)", stdout)
            assert int(took) == int(total) - resumed_at, (k, took, total)
            said = "[ckpt] frontier_m1node: no saved step" in stderr
            assert said == (resumed_at == 0 and k == 0), stderr
        assert out.read_bytes() == single.read_bytes()
        assert (tmp_path / "mesh.snp.proc1").read_bytes() == \
            single.read_bytes()
        assert os.listdir(ckpt) == []
