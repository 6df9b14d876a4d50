"""Checkpoint and resume of the port's traversal (``ckpt_dir``/``ckpt_every``
of ebwt2indel_torch/models/traverse.py), on the CPU: a phase interrupted
after its second save and run again gives the flags of an uninterrupted run
and of the JAX package's navigate functions on the same index, in modes 1
and 2, on the dense and the bit-packed route, interrupted in the leaf and in
the node phase. The counts other than ``max_pending`` are equal, and the
checkpoint is gone when the traversal completes. Everything compared is
integer or bytes, so the tolerance is 0."""

import os

import numpy as np
import pytest
import torch

from ebwt2indel_tpu.models import fm_index as jfm
from ebwt2indel_tpu.models import pipeline as jpipeline
from ebwt2indel_tpu.models import traverse as jtraverse
from ebwt2indel_tpu.tools import ebwt as jebwt
from ebwt2indel_tpu.ops import packing as jpacking
from ebwt2indel_tpu.tools import simulate as jsim
from ebwt2indel_tpu.utils import dna
from ebwt2indel_tpu.utils.config import Config
from ebwt2indel_torch import cli
from ebwt2indel_torch.models import fm_index as fm
from ebwt2indel_torch.models import pipeline, traverse
from ebwt2indel_torch.ops import bits
from tests.test_torch_hosttools import two_torch_threads  # noqa: F401
from tests.test_torch_traverse_pair import _index_pair

K, K_RIGHT = 8, 12
CHUNK = 64  # many chunks on a small index
EVERY = 3
_QUIET = {"log": lambda *a, **k: None}
_BODIES = {1: {"leaf": "_leaf_body", "node": "_node_body"},
           2: {"leaf": "_leaf_pair_body", "node": "_node_pair_body"}}


class _Preempted(Exception):
    pass


def _index(reads):
    """The JAX package's FM index of a read set and the port's of the same
    blocks."""
    codes = dna.str_to_codes(jebwt.ebwt_of_reads(reads))
    jf = jfm.FMIndex.from_packed(jpacking.pack_codes(codes))
    return jf, fm.FMIndex.from_numpy(
        np.asarray(jf.blocks), np.asarray(jf.block_counts), np.asarray(jf.F),
        jf.n, jf.term, device="cpu")


@pytest.fixture(scope="module")
def data():
    """Two read sets of a genome and a second haplotype: their indexes
    (mode 2), the index of both together (mode 1), and the JAX package's
    flags of each."""
    rng = np.random.default_rng(0xC4)
    genome = jsim.random_genome(rng, 1500)
    hap2, _ = jsim.plant_variants(rng, genome, snp_rate=0.004,
                                  indel_rate=0.001)
    reads1 = jsim.sample_reads(rng, genome, 6, 60)
    reads2 = jsim.sample_reads(rng, hap2, 6, 60)
    (jf1, tf1), (jf2, tf2) = _index_pair(reads1, reads2)
    jf, tf = _index(reads1 + reads2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtraverse, "CHUNK", 4096)
        want = {1: jtraverse.navigate_one_bwt(jf, K, K_RIGHT),
                2: jtraverse.navigate_two_bwts(jf1, jf2, K, K_RIGHT)}
    return {"reads": (reads1, reads2), "fm": {1: (tf,), 2: (tf1, tf2)},
            "jax": want}


def _navigate(data, mode, packed, **ckpt):
    nav = traverse.navigate_one_bwt if mode == 1 else \
        traverse.navigate_two_bwts
    return nav(*data["fm"][mode], K, K_RIGHT, packed=packed, slice_len=96,
               **ckpt)


def _flag_names(mode):
    return ("thr_K", "thr_R", "minima") + (("da",) if mode == 2 else ())


def _stats(res):
    return {k: v for k, v in res.stats.items()
            if k != "max_pending"}


class _TripWire:
    """Counts the steps of one phase body and its checkpoint saves; while
    armed, the body raises once its phase has saved ``after`` times."""

    def __init__(self, monkeypatch, body: str, after: int = 2):
        self.file = f"phase{body}.pt"
        self.saves, self.steps, self.armed = 0, 0, True
        real_save = traverse._Checkpoint.save
        real_body = getattr(traverse, body)

        def save(ckpt, *a):
            real_save(ckpt, *a)
            self.saves += os.path.basename(ckpt.path) == self.file

        def step(*a, **k):
            if self.armed and self.saves >= after:
                raise _Preempted
            self.steps += 1
            return real_body(*a, **k)

        monkeypatch.setattr(traverse._Checkpoint, "save", save)
        monkeypatch.setattr(traverse, body, step)


@pytest.mark.parametrize("phase", ["leaf", "node"])
@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
@pytest.mark.parametrize("mode", [1, 2])
def test_resume_gives_uninterrupted_flags(data, mode, packed, phase,
                                          tmp_path, monkeypatch):
    monkeypatch.setattr(traverse, "CHUNK", CHUNK)
    trip = _TripWire(monkeypatch, _BODIES[mode][phase])
    trip.armed = False
    want = _navigate(data, mode, packed)
    full_steps = trip.steps

    trip.armed, trip.steps = True, 0
    ckpt = {"ckpt_dir": str(tmp_path), "ckpt_every": EVERY}
    with pytest.raises(_Preempted):
        _navigate(data, mode, packed, **ckpt)
    assert os.listdir(tmp_path) == [trip.file]
    assert trip.saves == 2 and trip.steps == 2 * EVERY

    trip.armed, trip.steps = False, 0
    got = _navigate(data, mode, packed, **ckpt)
    assert os.listdir(tmp_path) == []
    # it resumed after the second save instead of starting over
    assert trip.steps == full_steps - 2 * EVERY
    jax = data["jax"][mode]
    n = sum(f.n for f in data["fm"][mode])
    for name in _flag_names(mode):
        g, w = getattr(got, name), getattr(want, name)
        assert got.packed == packed and torch.equal(g, w), name
        dense = bits.unpack_bits(g, n) if packed else g
        np.testing.assert_array_equal(dense.to(torch.uint8).numpy(),
                                      np.asarray(getattr(jax, name)),
                                      err_msg=name)
    assert _stats(got) == _stats(want)
    for k, v in _stats(got).items():
        assert v == jax.stats[k], k


def test_checkpoint_of_another_index_is_ignored(data, tmp_path,
                                                monkeypatch):
    """A node-phase checkpoint left by mode 1 on one index is not taken by a
    traversal of another n: it runs in full, gives its own flags, and
    removes the file."""
    monkeypatch.setattr(traverse, "CHUNK", CHUNK)
    trip = _TripWire(monkeypatch, "_node_body")
    ckpt = {"ckpt_dir": str(tmp_path), "ckpt_every": EVERY}
    with pytest.raises(_Preempted):
        _navigate(data, 1, False, **ckpt)
    assert os.listdir(tmp_path) == [trip.file]

    trip.armed = False
    other = data["fm"][2][0]
    assert other.n != data["fm"][1][0].n
    want = traverse.navigate_one_bwt(other, K, K_RIGHT)
    trip.steps = 0
    got = traverse.navigate_one_bwt(other, K, K_RIGHT, **ckpt)
    full_steps = trip.steps
    trip.steps = 0
    traverse.navigate_one_bwt(other, K, K_RIGHT)
    assert full_steps == trip.steps
    for name in _flag_names(1):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert _stats(got) == _stats(want)
    assert os.listdir(tmp_path) == []


def test_mode3_resumed_snp_matches_jax(data, tmp_path, monkeypatch):
    """Mode 3 (merged eBWT and document array) interrupted in its node
    phase and run again writes the JAX package's .snp."""
    bwt, da = jebwt.ebwt_and_da_of_two(*data["reads"])
    (tmp_path / "m.ebwt").write_text(bwt)
    (tmp_path / "m.da").write_text(da)

    def cfg(out):
        return Config(input1=str(tmp_path / "m.ebwt"),
                      input_da=str(tmp_path / "m.da"),
                      output=str(tmp_path / out))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtraverse, "CHUNK", 4096)
        jpipeline.run_two_datasets_da(cfg("jax.snp"), **_QUIET)
    monkeypatch.setattr(traverse, "CHUNK", CHUNK)
    trip = _TripWire(monkeypatch, "_node_body")
    ckpt_dir = tmp_path / "ckpt"
    run = {"device": "cpu", "ckpt_dir": str(ckpt_dir), "ckpt_every": EVERY}
    with pytest.raises(_Preempted):
        pipeline.run_two_datasets_da(cfg("torch.snp"), **_QUIET, **run)
    assert os.listdir(ckpt_dir) == [trip.file]
    trip.armed = False
    pipeline.run_two_datasets_da(cfg("torch.snp"), **_QUIET, **run)
    want = (tmp_path / "jax.snp").read_bytes()
    assert (tmp_path / "torch.snp").read_bytes() == want and want
    assert os.listdir(ckpt_dir) == []


def test_cli_resumes_from_the_environment(data, tmp_path, monkeypatch,
                                          capsys):
    """``cli.main`` takes the checkpoint directory and interval from
    EBWT_CKPT_DIR and EBWT_CKPT_EVERY, the JAX package's interface: a run
    killed in its node phase and started again writes the uninterrupted
    .snp."""
    path = tmp_path / "r.ebwt"
    path.write_text(jebwt.ebwt_of_reads(data["reads"][0] +
                                        data["reads"][1]))
    pipeline.run_one_dataset(Config(input1=str(path),
                                    output=str(tmp_path / "want.snp")),
                             device="cpu", **_QUIET)
    monkeypatch.setattr(traverse, "CHUNK", CHUNK)
    monkeypatch.setenv("EBWT_CKPT_DIR", str(tmp_path / "ckpt"))
    monkeypatch.setenv("EBWT_CKPT_EVERY", str(EVERY))
    trip = _TripWire(monkeypatch, "_node_body")
    args = ["-1", str(path), "-o", str(tmp_path / "got.snp")]
    with pytest.raises(_Preempted):
        cli.main(args, device="cpu")
    assert os.listdir(tmp_path / "ckpt") == [trip.file]
    trip.armed = False
    assert cli.main(args, device="cpu") == 0
    capsys.readouterr()
    want = (tmp_path / "want.snp").read_bytes()
    assert (tmp_path / "got.snp").read_bytes() == want and want
    assert os.listdir(tmp_path / "ckpt") == []
