"""The rank kernel's bytes counted in the counting sample, launch by launch,
against the formula over each launch's held block rows (64 B per distinct
row of ``i >> 7``, 40 B per query); the guard that leaves the bytes out
where the traced samples launched otherwise; and the ``mode1-1G`` cell."""

import json
import time
from pathlib import Path

import pytest
import torch

from portbench import gen, harness, manifest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in manifest.load(ROOT)["workloads"]]
TINY = {"genome_length": 12000, "snp_rate": 0.01, "indel_rate": 0.002}


def held_rows_bytes(launches) -> int:
    """The formula over every launch's block rows held as a tensor."""
    rows = [(i >> 7).reshape(-1) for i in launches]
    return sum(harness.ROW_BYTES * torch.unique(r).numel()
               + harness.QUERY_BYTES * r.numel() for r in rows)


def _stand_in(held: list):
    """A rank kernel for the CPU: the plain version, counted as the CUDA
    wrapper counts (an empty query vector launches nothing), its queries
    held in ``held``."""
    from ebwt2indel_torch.ops import rank, rank_cuda

    def rank_decode(blocks, i):
        if i.numel():
            held.append(i.clone())
            rank_cuda.LAUNCHES["rank_decode"] += 1
            rank_cuda.QUERIES["rank_decode"] += i.numel()
        return rank.parallel_rank_plain(blocks, i)
    return rank_decode


def test_counted_launches_give_the_held_rows_bytes(monkeypatch, tmp_path):
    from ebwt2indel_torch.ops import rank_cuda

    g = torch.Generator().manual_seed(4)
    launches = [torch.tensor([0, 127, 128, 200, 255, 9 * 128 + 5]),
                torch.randint(0, 1 << 20, (3, 1000), generator=g),
                torch.tensor([5, 5, 5]), torch.zeros(0, dtype=torch.int64),
                torch.randint(0, 1 << 12, (4096, 2), generator=g)]
    blocks = torch.zeros(((1 << 20) // 128 + 1, 16), dtype=torch.int32)
    monkeypatch.setattr(rank_cuda, "rank_decode", _stand_in([]))
    prog = harness.Program(["-1", "in", "-o", "out"], torch.device("cpu"),
                           str(tmp_path), str(tmp_path / "out"))
    with prog.hooked():
        prog.counts = []
        for i in launches:
            rank_cuda.rank_decode(blocks, i)
        counts, prog.counts = prog.counts, None
    assert len(counts) == 4  # the empty vector is no launch
    assert counts[0] == (3, 6)
    assert harness.launch_bytes(counts) == held_rows_bytes(launches)
    assert harness.launch_bytes(counts[:1]) == 64 * 3 + 40 * 6


def _trace_line(err: str) -> dict:
    line = [x for x in err.splitlines() if x.startswith("[portbench] trace ")]
    return json.loads(line[-1][len("[portbench] trace "):])


@pytest.mark.parametrize("workload", CELLS)
def test_traced_bytes_and_launches_equal_the_held_rows(capsys, monkeypatch,
                                                       workload):
    # every rank query of a whole run goes through the (stand-in) kernel,
    # so the traced samples' bytes and launches are the held formula's
    from ebwt2indel_torch.ops import rank, rank_cuda

    held: list = []
    monkeypatch.setattr(rank_cuda, "rank_decode", _stand_in(held))
    monkeypatch.setattr(rank, "parallel_rank",
                        lambda blocks, i: rank_cuda.rank_decode(blocks, i))
    harness.prepare_environment(ROOT)
    rc = harness.run(manifest.cell(ROOT, workload), 2**31 + 17, 0.3, True,
                     "cpu", time.perf_counter(), TINY)
    out, err = capsys.readouterr()
    assert rc == 0, err[-3000:]
    assert json.loads(out.strip().splitlines()[-1])["correct"] is True
    t = _trace_line(err)
    per_sample = t["rank_launches"] // harness.TRACED_SAMPLES
    assert per_sample > 0
    assert t["rank_launches"] == per_sample * harness.TRACED_SAMPLES
    # the traced samples were the last to launch the kernel
    traced = held[len(held) - t["rank_launches"]:]
    assert t["rank_bytes"] == held_rows_bytes(traced)


def test_bytes_left_out_where_a_traced_sample_launched_otherwise(capsys):
    counted = {"launches": 485, "queries": 1000, "rank_bytes": 70_000}
    same = {"launches": 485, "queries": 1000}
    assert harness.traced_rank_bytes(counted, [same, same]) == 140_000
    assert capsys.readouterr().err == ""
    for other in ({"launches": 486, "queries": 1000},
                  {"launches": 485, "queries": 999}):
        assert harness.traced_rank_bytes(counted, [same, other]) is None
        assert "rank_bytes left out" in capsys.readouterr().err
    t = {"kernel_s": {"rank_decode": 1e-3}, "rank_bytes": None,
         "device_events": 9, "busy_s": 1, "window_s": 2}
    rec = {"trace": t, "device": {"kind": "NVIDIA H100 80GB HBM3"},
           "peaks": {"NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12}}}
    assert manifest.load_reader("rank_decode_roofline")(rec) is None


def test_mode1_1g_cell():
    cell = manifest.cell(ROOT, "mode1-1G")
    assert cell.chips == 1
    assert cell.traffic == json.loads(
        (ROOT / "portbench/traffic/mode1.json").read_text())
    names = {m.name for m in cell.per_layer}
    assert not names & {"index.da_wait_s", "index.da_side_s",
                        "call.da_rank_s"}
    assert {"rank_decode_roofline", "device.idle_pct"} <= names
    base = json.loads(
        (ROOT / "portbench/configs/ecoli25x-single.json").read_text())
    changed = {k for k in base if base[k] != cell.config[k]}
    assert set(cell.config) == set(base)
    assert changed == {"name", "source", "genome_length", "assumed"}
    assert cell.config["genome_length"] == 41_600_000
    assert cell.config["reduced"] == []


@pytest.mark.cuda
def test_counted_sample_bytes_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the rank kernel has no CPU mode")
    dev = torch.device("cuda")
    cell = manifest.cell(ROOT, "mode1-ecoli25x")
    recipe = {**cell.config, "genome_length": 300_000}
    reads1, reads2 = gen.make_reads(recipe, 2**31 + 5, dev)
    paths = gen.write_inputs(cell.inputs, reads1, reads2, str(tmp_path))
    out = str(tmp_path / "out.snp")
    argv = [a.format(out=out, **paths) for a in cell.traffic["argv"]]
    prog = harness.Program(argv, dev, str(tmp_path), out)
    held: list = []
    with prog.hooked():
        counted = harness._counted(prog)
        hooked = prog._rank.rank_decode

        def holding(blocks, i):
            if i.numel():
                held.append(i.clone())
            return hooked(blocks, i)
        prog._rank.rank_decode = holding
        try:
            s = prog.sample()
        finally:
            prog._rank.rank_decode = hooked
    assert counted["ok"] and s["ok"] and counted["digest"] == s["digest"]
    assert (counted["launches"], counted["queries"]) == \
        (s["launches"], s["queries"]) == \
        (len(held), sum(i.numel() for i in held))
    assert counted["launches"] > 0
    assert counted["rank_bytes"] == held_rows_bytes(held)
