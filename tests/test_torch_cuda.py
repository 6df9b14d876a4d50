"""Tests of the port that need an NVIDIA GPU: the CUDA rank kernel against
its plain PyTorch version, modes 1, 2 and 3 on the card against the same
mode on the CPU, the bit-packed route against the dense route, a traversal
resumed from its checkpoint against an uninterrupted run, modes 1, 3 and 2
on a 4-shard mesh held by the card against the CPU's single-device run, a
mesh run resumed from its checkpoints against an uninterrupted one, an
index read from its cache against a fresh one, the windowed add into a
vector past 2^31 elements, the CUDA next-set kernel against its plain
version, at the benchmark's size and past 2^31 positions, and the CUDA node
step against its plain version on a real node phase's chunks and past 2^31
positions, with its launches counted once a step.
A CUDA kernel has no CPU mode, so without a card these skip. On the card:

    python -m pytest tests/test_torch_cuda.py -m cuda

The file imports nothing from ``tests``, so it also collects where another
package of that name is installed."""

import os

import numpy as np
import pytest
import torch

from ebwt2indel_torch.models import pipeline, traverse
from ebwt2indel_torch.ops import packing, rank, rank_cuda, scan, scan_cuda
from ebwt2indel_torch.tools import ebwt, genhuge, simulate
from ebwt2indel_torch.utils.config import Config

pytestmark = pytest.mark.cuda


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the rank kernel runs only on the "
                    "card")


def test_rank_kernel_matches_plain_on_card(rng):
    """Exact equality with the plain version, edge positions included, and
    one launch counted per call."""
    _needs_cuda()
    n = 200_003
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    codes[rng.random(n) < 0.03] = 4
    blocks = torch.from_numpy(packing.pack_codes(codes).blocks.view(np.int32))
    qs = torch.from_numpy(np.concatenate(
        [rng.integers(0, n + 1, size=100_000), [0, 127, 128, n - 1, n]]))
    before = rank_cuda.LAUNCHES["rank_decode"]
    got = rank.parallel_rank(blocks.cuda(), qs.cuda())
    torch.cuda.synchronize()
    assert rank_cuda.LAUNCHES["rank_decode"] == before + 1
    assert torch.equal(got.cpu(), rank.parallel_rank_plain(blocks, qs))


def test_mode1_cuda_matches_cpu(tmp_path, rng):
    """The .snp of mode 1 on the card is byte-identical to the CPU's."""
    _needs_cuda()
    genome = simulate.random_genome(rng, 20_000)
    hap2, _ = simulate.plant_variants(rng, genome, snp_rate=0.004,
                                      indel_rate=0.001)
    reads = simulate.sample_reads(rng, genome, 8, 100) + \
        simulate.sample_reads(rng, hap2, 8, 100)
    path = tmp_path / "r.ebwt"
    path.write_text(ebwt.ebwt_of_reads(reads))
    outs = {}
    for dev in ("cuda", "cpu"):
        out = tmp_path / f"{dev}.snp"
        pipeline.run_one_dataset(Config(input1=str(path), output=str(out)),
                                 log=lambda *a, **k: None, device=dev)
        outs[dev] = out.read_bytes()
    assert outs["cuda"] == outs["cpu"] and outs["cpu"]


def _pair_reads(rng):
    genome = simulate.random_genome(rng, 20_000)
    hap2, _ = simulate.plant_variants(rng, genome, snp_rate=0.004,
                                      indel_rate=0.001)
    return (simulate.sample_reads(rng, genome, 8, 100),
            simulate.sample_reads(rng, hap2, 8, 100))


def _cuda_vs_cpu(run, cfg_of, tmp_path):
    outs, stats = {}, {}
    for dev in ("cuda", "cpu"):
        out = tmp_path / f"{dev}.snp"
        stats[dev] = run(cfg_of(str(out)), log=lambda *a, **k: None,
                         device=dev)
        outs[dev] = out.read_bytes()
    assert outs["cuda"] == outs["cpu"] and outs["cpu"]
    for k in ("leaves", "nodes", "lcp_values", "n_min", "n_clusters",
              "events", "cluster_nr"):
        assert stats["cuda"][k] == stats["cpu"][k], k
    return stats


def test_mode3_cuda_matches_cpu(tmp_path, rng):
    """The .snp of mode 3 on the card is byte-identical to the CPU's."""
    _needs_cuda()
    bwt, da = ebwt.ebwt_and_da_of_two(*_pair_reads(rng))
    (tmp_path / "m.ebwt").write_text(bwt)
    (tmp_path / "m.da").write_text(da)
    _cuda_vs_cpu(pipeline.run_two_datasets_da,
                 lambda out: Config(input1=str(tmp_path / "m.ebwt"),
                                    input_da=str(tmp_path / "m.da"),
                                    output=out), tmp_path)


def test_mode2_cuda_matches_cpu(tmp_path, rng):
    """The .snp of mode 2 on the card is byte-identical to the CPU's, and
    the traversal's DA count agrees."""
    _needs_cuda()
    reads1, reads2 = _pair_reads(rng)
    (tmp_path / "a.ebwt").write_text(ebwt.ebwt_of_reads(reads1))
    (tmp_path / "b.ebwt").write_text(ebwt.ebwt_of_reads(reads2))
    st = _cuda_vs_cpu(pipeline.run_two_datasets,
                      lambda out: Config(input1=str(tmp_path / "a.ebwt"),
                                         input2=str(tmp_path / "b.ebwt"),
                                         output=out), tmp_path)
    assert st["cuda"]["da_values"] == st["cpu"]["da_values"]


def test_mode1_packed_matches_dense_on_card(tmp_path, monkeypatch):
    """At 4M positions the bit-packed route writes the dense route's .snp
    on the card, with the stats equal; slices of 2^20 positions make its
    passes cross slice boundaries."""
    _needs_cuda()
    path = tmp_path / "r.ebwt"
    n = genhuge.build(200_000, str(path), coverage=20, log=lambda *a: None)
    assert n > 4_000_000
    monkeypatch.setattr(traverse, "LEAN_SLICE", 1 << 20)
    outs, stats = {}, {}
    for packed in (True, False):
        out = tmp_path / f"{packed}.snp"
        stats[packed] = pipeline.run_one_dataset(
            Config(input1=str(path), output=str(out)),
            log=lambda *a, **k: None, device="cuda", packed=packed)
        outs[packed] = out.read_bytes()
    assert outs[True] == outs[False] and outs[True]
    for k in ("leaves", "nodes", "lcp_values", "n_min", "n_clusters",
              "events", "cluster_nr"):
        assert stats[True][k] == stats[False][k], k


class _Preempted(Exception):
    pass


def test_mode1_resume_matches_uninterrupted_on_card(tmp_path, monkeypatch):
    """At 4M positions a mode-1 run killed in its node phase after the
    phase's second checkpoint, then run again, writes the uninterrupted
    .snp on the card, and the checkpoint is gone."""
    _needs_cuda()
    path = tmp_path / "r.ebwt"
    genhuge.build(200_000, str(path), coverage=20, log=lambda *a: None)
    monkeypatch.setattr(traverse, "CHUNK", 1 << 16)

    def run(out, **ckpt):
        return pipeline.run_one_dataset(
            Config(input1=str(path), output=str(tmp_path / out)),
            log=lambda *a, **k: None, device="cuda", **ckpt)

    want = run("want.snp")
    saves = []
    real_save = traverse._Checkpoint.save
    real_node = traverse._node_body

    def save(ckpt, *a):
        real_save(ckpt, *a)
        saves.append(os.path.basename(ckpt.path))

    def node(*a, **k):
        if saves.count("phase_node_body.pt") >= 2:
            raise _Preempted
        return real_node(*a, **k)

    monkeypatch.setattr(traverse._Checkpoint, "save", save)
    monkeypatch.setattr(traverse, "_node_body", node)
    ckpt = {"ckpt_dir": str(tmp_path / "ckpt"), "ckpt_every": 3}
    with pytest.raises(_Preempted):
        run("got.snp", **ckpt)
    assert os.listdir(tmp_path / "ckpt") == ["phase_node_body.pt"]
    monkeypatch.setattr(traverse, "_node_body", real_node)
    got = run("got.snp", **ckpt)
    assert (tmp_path / "got.snp").read_bytes() == \
        (tmp_path / "want.snp").read_bytes()
    for k in ("leaves", "nodes", "lcp_values", "n_min", "n_clusters",
              "events", "cluster_nr"):
        assert got[k] == want[k], k
    assert os.listdir(tmp_path / "ckpt") == []


def test_mesh_mode1_cuda_matches_cpu(tmp_path, rng):
    """Mode 1 on a 4-shard mesh held on the one card writes the CPU's
    single-device .snp, every shard's rank a launch of the kernel; the
    mesh's sharded rank equals the plain version over the whole index."""
    _needs_cuda()
    from ebwt2indel_torch.parallel import mesh, shard
    from ebwt2indel_torch.parallel import pipeline as mesh_pipeline

    reads1, reads2 = _pair_reads(rng)
    path = tmp_path / "r.ebwt"
    path.write_text(ebwt.ebwt_of_reads(reads1 + reads2))
    want = tmp_path / "cpu.snp"
    pipeline.run_one_dataset(Config(input1=str(path), output=str(want)),
                             log=lambda *a, **k: None, device="cpu")
    m = mesh.Mesh(4, device="cuda")
    before = rank_cuda.LAUNCHES["rank_decode"]
    got = tmp_path / "mesh.snp"
    mesh_pipeline.run_one_dataset_sharded(
        Config(input1=str(path), output=str(got)), m,
        log=lambda *a, **k: None)
    assert rank_cuda.LAUNCHES["rank_decode"] > before
    assert got.read_bytes() == want.read_bytes() and want.read_bytes()

    pb = packing.pack_file(str(path))
    sfm = shard.shard_fm(pb, m)
    q = torch.from_numpy(rng.integers(0, pb.n + 1, size=100_000))
    assert torch.equal(
        shard.sharded_parallel_rank(sfm, q.cuda()).cpu(),
        rank.parallel_rank_plain(torch.from_numpy(pb.blocks.view(np.int32)),
                                 q))


def _mesh_pair_cuda_vs_cpu(tmp_path, rng, mode):
    """A pair mode on a 4-shard mesh held on the one card writes the CPU's
    single-device .snp with the same stats, and launches the kernel."""
    _needs_cuda()
    from ebwt2indel_torch.parallel import mesh
    from ebwt2indel_torch.parallel import pipeline as mesh_pipeline

    reads1, reads2 = _pair_reads(rng)
    if mode == 3:
        bwt, da = ebwt.ebwt_and_da_of_two(reads1, reads2)
        (tmp_path / "m.ebwt").write_text(bwt)
        (tmp_path / "m.da").write_text(da)
        cfg_of = lambda out: Config(input1=str(tmp_path / "m.ebwt"),  # noqa: E731
                                    input_da=str(tmp_path / "m.da"),
                                    output=out)
        one, sharded = (pipeline.run_two_datasets_da,
                        mesh_pipeline.run_two_datasets_da_sharded)
    else:
        (tmp_path / "a.ebwt").write_text(ebwt.ebwt_of_reads(reads1))
        (tmp_path / "b.ebwt").write_text(ebwt.ebwt_of_reads(reads2))
        cfg_of = lambda out: Config(input1=str(tmp_path / "a.ebwt"),  # noqa: E731
                                    input2=str(tmp_path / "b.ebwt"),
                                    output=out)
        one, sharded = (pipeline.run_two_datasets,
                        mesh_pipeline.run_two_datasets_sharded)
    want = tmp_path / "cpu.snp"
    st_cpu = one(cfg_of(str(want)), log=lambda *a, **k: None, device="cpu")
    before = rank_cuda.LAUNCHES["rank_decode"]
    got = tmp_path / "mesh.snp"
    st = sharded(cfg_of(str(got)), mesh.Mesh(4, device="cuda"),
                 log=lambda *a, **k: None)
    assert rank_cuda.LAUNCHES["rank_decode"] > before
    assert got.read_bytes() == want.read_bytes() and want.read_bytes()
    for k in ("events", "cluster_nr", "n_clusters", "lcp_values", "n_min"):
        assert st[k] == st_cpu[k], k
    if mode == 2:
        assert st["da_values"] == st_cpu["da_values"]


def test_mesh_mode3_cuda_matches_cpu(tmp_path, rng):
    _mesh_pair_cuda_vs_cpu(tmp_path, rng, 3)


def test_mesh_mode2_cuda_matches_cpu(tmp_path, rng):
    _mesh_pair_cuda_vs_cpu(tmp_path, rng, 2)


def test_mesh_mode2_resume_matches_uninterrupted_on_card(tmp_path, rng,
                                                         monkeypatch):
    """Mode 2 on a 4-shard mesh held on the card, killed in its node-pair
    phase after the phase's second save and run again, writes the
    uninterrupted .snp with equal stats (the mesh steps and routed bytes
    among them), ranks through the kernel, and leaves no checkpoint."""
    _needs_cuda()
    from ebwt2indel_torch.parallel import frontier, mesh
    from ebwt2indel_torch.parallel import pipeline as mesh_pipeline

    reads1, reads2 = _pair_reads(rng)
    (tmp_path / "a.ebwt").write_text(ebwt.ebwt_of_reads(reads1))
    (tmp_path / "b.ebwt").write_text(ebwt.ebwt_of_reads(reads2))
    monkeypatch.setattr(traverse, "CHUNK", 256)

    def run(out, **ckpt):
        return mesh_pipeline.run_two_datasets_sharded(
            Config(input1=str(tmp_path / "a.ebwt"),
                   input2=str(tmp_path / "b.ebwt"),
                   output=str(tmp_path / out)),
            mesh.Mesh(4, device="cuda"), log=lambda *a, **k: None, **ckpt)

    want = run("want.snp")
    saves = []
    real_save = frontier._MeshCheckpoint.save
    real_step = frontier._node_pair_step

    def save(ckpt, *a):
        real_save(ckpt, *a)
        saves.append(ckpt.tag)

    def step(*a, **k):
        if saves.count("pnode") >= 2:
            raise _Preempted
        return real_step(*a, **k)

    monkeypatch.setattr(frontier._MeshCheckpoint, "save", save)
    monkeypatch.setattr(frontier, "_node_pair_step", step)
    ckpt = {"ckpt_dir": str(tmp_path / "ckpt"), "ckpt_every": 2}
    with pytest.raises(_Preempted):
        run("got.snp", **ckpt)
    assert sorted(os.listdir(tmp_path / "ckpt")) == [
        "frontier_pnode.p0.prev.pt", "frontier_pnode.p0.pt"]
    monkeypatch.setattr(frontier, "_node_pair_step", real_step)
    before = rank_cuda.LAUNCHES["rank_decode"]
    got = run("got.snp", **ckpt)
    assert rank_cuda.LAUNCHES["rank_decode"] > before
    assert (tmp_path / "got.snp").read_bytes() == \
        (tmp_path / "want.snp").read_bytes()
    for k in ("leaves", "nodes", "lcp_values", "n_min", "n_clusters",
              "events", "cluster_nr", "da_values", "leaf_steps",
              "node_steps", "comm_bytes_per_step"):
        assert got[k] == want[k], k
    assert os.listdir(tmp_path / "ckpt") == []


def test_index_cache_on_card(tmp_path, rng, monkeypatch):
    """With EBWT_INDEX_CACHE=1, mode 1 on the card writes the input's
    sidecar cold and reads it warm (packing nothing), each .snp equal to
    the uncached run's, the cached index ranked by the kernel."""
    _needs_cuda()
    reads1, reads2 = _pair_reads(rng)
    path = tmp_path / "r.ebwt"
    path.write_text(ebwt.ebwt_of_reads(reads1 + reads2))

    def run(out):
        pipeline.run_one_dataset(Config(input1=str(path),
                                        output=str(tmp_path / out)),
                                 log=lambda *a, **k: None, device="cuda")
        return (tmp_path / out).read_bytes()

    want = run("plain.snp")
    monkeypatch.setenv("EBWT_INDEX_CACHE", "1")
    assert run("cold.snp") == want and want
    assert os.path.isfile(str(path) + ".idx.npz")

    def no_pack(*a, **k):
        raise AssertionError("packed although its sidecar was there")

    monkeypatch.setattr(packing, "pack_file", no_pack)
    before = rank_cuda.LAUNCHES["rank_decode"]
    assert run("warm.snp") == want
    assert rank_cuda.LAUNCHES["rank_decode"] > before


def test_add_past_2_31_on_card():
    """``traverse.add_at`` into a uint8 vector of 2^31 + 4,096 elements (2
    GB) on the card, where a single ``index_add_`` does not launch: each
    value lands at its position on both sides of 2^31, repeats add up, and
    nothing else moves."""
    _needs_cuda()
    big = 2**31
    n = big + 4096
    x = torch.zeros(n, dtype=torch.uint8, device="cuda")
    pos = [0, 2**30 - 1, 2**30, big - 1, big, big + 1, n - 1, big]
    idx = torch.tensor(pos, device="cuda")
    val = torch.arange(1, len(pos) + 1, dtype=torch.uint8, device="cuda")
    traverse.add_at(x, idx, val)
    want = {}
    for p, v in zip(pos, range(1, len(pos) + 1)):
        want[p] = want.get(p, 0) + v
    assert x[torch.tensor(sorted(want), device="cuda")].tolist() == \
        [want[p] for p in sorted(want)]
    assert int(x.sum(dtype=torch.int64)) == sum(want.values())


def test_spans_on_card(tmp_path):
    """A device span times the card's work between its two events: queued
    matrix products take longer on the card than their enqueue on the host,
    and the span itself allocates no device memory. A mode-1 run on the
    card records every span of its CPU run, ``node_phase.wait`` inside
    ``node_phase``."""
    _needs_cuda()
    from ebwt2indel_torch.utils import profile

    x = torch.randn(4096, 4096, device="cuda")
    x @ x  # the first product sets cuBLAS up on the host
    torch.cuda.synchronize()
    host = {}

    def body():
        held = torch.cuda.memory_allocated()
        with profile.span("empty", device=x.device):
            pass
        assert torch.cuda.memory_allocated() == held
        with profile.span("products", device=x.device) as sp:
            for _ in range(20):
                x @ x
        host["products"] = sp.seconds
        torch.cuda.synchronize()
        return {}

    sec = profile.recorded(body)()["seconds"]
    assert set(sec) == {"empty", "products"}
    assert sec["products"] > 10 * host["products"] and \
        sec["empty"] < sec["products"]

    rng = np.random.default_rng(0x5BA7)
    genome = simulate.random_genome(rng, 20_000)
    tmp = str(tmp_path / "r.ebwt")
    with open(tmp, "w") as f:
        f.write(ebwt.ebwt_of_reads(simulate.sample_reads(rng, genome, 8,
                                                         100)))
    keys = {}
    for dev in ("cuda", "cpu"):
        st = pipeline.run_one_dataset(
            Config(input1=tmp, output=tmp + f".{dev}.snp"),
            log=lambda *a, **k: None, device=dev)
        keys[dev] = set(st["seconds"])
        assert st["seconds"]["node_phase.wait"] <= \
            st["seconds"]["node_phase"]
    assert keys["cuda"] == keys["cpu"]


_TILE = 4096  # positions per block of csrc/next_set.cu
# the share of positions with thr_R set (LCP >= 30) in the benchmark's
# inputs: 0.6413 of 116,148,788 on a mode-1 input of 25x 100 bp reads
BENCH_THR_R_DENSITY = 0.64
BENCH_N = 116_150_000


def _card_flags(kind: str, size: int, gen: torch.Generator) -> torch.Tensor:
    if kind == "random":
        return (torch.rand(size, generator=gen, device="cuda") <
                0.3).to(torch.uint8)
    f = torch.zeros(size, dtype=torch.uint8, device="cuda")
    if kind == "all":
        f[:] = 1
    elif kind == "first":
        f[0] = 1
    elif kind == "last":
        f[-1] = 1
    return f


# (flags, size, base, n); n None is base + size
_EDGES = {
    "n1_set": ("all", 1, 0, None),
    "n1_unset": ("none", 1, 0, None),
    "all_zero": ("none", 3 * _TILE, 0, None),
    "all_set": ("all", 3 * _TILE, 0, None),
    "only_first": ("first", 3 * _TILE + 5, 0, None),
    "only_last": ("last", 3 * _TILE + 5, 0, None),
    "tile_minus_1": ("random", _TILE - 1, 0, None),
    "tile": ("random", _TILE, 0, None),
    "tile_plus_1": ("random", _TILE + 1, 0, None),
    "mesh_shard": ("random", 10 * _TILE + 3, 7 * _TILE, 12 * _TILE),
    "mesh_shard_past_n": ("all", 1000, 3000, 2000),
    "base_past_2_31": ("random", 2 * _TILE + 1, 2**31 + 5, 2**31 + 6000),
    # more tiles than one pass of the carry block (8,192 tiles)
    "carry_passes": ("random", 9000 * _TILE + 17, 0, None),
}


@pytest.mark.parametrize("case", sorted(_EDGES))
def test_next_set_kernel_matches_plain_on_card(case):
    """Bit for bit the plain version at the edge sizes, and one launch
    counted per call; unaligned flags (a view one byte in) take the kernel's
    byte loads."""
    _needs_cuda()
    kind, size, base, n = _EDGES[case]
    gen = torch.Generator(device="cuda").manual_seed(size)
    f = _card_flags(kind, size, gen)
    for flags in (f, f.to(torch.bool)):
        before = scan_cuda.LAUNCHES["next_set"]
        got = scan.next_set(flags, base, n)
        torch.cuda.synchronize()
        assert scan_cuda.LAUNCHES["next_set"] == before + 1
        assert torch.equal(got, scan.next_set_plain(flags, base, n))
    held = torch.zeros(size + 1, dtype=torch.uint8, device="cuda")
    held[1:] = f
    view = held[1:]
    assert view.data_ptr() % 16
    assert torch.equal(scan.next_set(view, base, n),
                       scan.next_set_plain(f, base, n))


def _rounded(nbytes: int) -> int:
    return -(-nbytes // 512) * 512  # the caching allocator's block size


def test_next_set_at_benchmark_size_on_card():
    """At the benchmark's 116.15 M positions and flag density: bit for bit
    the plain version, one launch, and the device memory the call adds at
    its peak no more than the 8 B/position table plus 8 B of scratch per
    tile."""
    _needs_cuda()
    gen = torch.Generator(device="cuda").manual_seed(0x5E7)
    f = (torch.rand(BENCH_N, generator=gen, device="cuda") <
         BENCH_THR_R_DENSITY).to(torch.uint8)
    del gen
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    before = scan_cuda.LAUNCHES["next_set"]
    got = scan.next_set(f)
    torch.cuda.synchronize()
    grew = torch.cuda.max_memory_allocated() - held
    assert scan_cuda.LAUNCHES["next_set"] == before + 1
    tiles = -(-BENCH_N // _TILE)
    assert grew <= _rounded(8 * BENCH_N) + _rounded(8 * tiles), grew
    assert torch.equal(got, scan.next_set_plain(f))


def test_next_set_past_2_31_on_card():
    """2^31 + 12,289 sparse flags (2 GB): every entry is the first set
    position at or after it, checked window by window against a
    ``searchsorted`` over the set positions, on both sides of 2^31."""
    _needs_cuda()
    big = 2**31
    n = big + 3 * _TILE + 1
    f = torch.zeros(n, dtype=torch.uint8, device="cuda")
    pos = [5, 2**30 - 1, big - 1, big, big + 4095, big + 4097]
    f[torch.tensor(pos, device="cuda")] = 1
    got = scan.next_set(f)
    torch.cuda.synchronize()
    del f
    P = torch.tensor(pos + [n], device="cuda")
    window = 2**28
    for lo in range(0, n, window):
        i = torch.arange(lo, min(lo + window, n), device="cuda")
        assert torch.equal(got[lo:lo + window],
                           P[torch.searchsorted(P, i)]), lo
    assert got[-1].item() == n and got[big].item() == big


# the pipeline's default -k and -R (utils/config.py): K != k_right
NODE_K, NODE_K_RIGHT = 16, 30
NODE_SIZES = (1, 61, 4097)


def _node_step_vs_plain(fm, fm_cpu, chunk, flags, stats, K, k_right):
    """``node_step`` on the card and ``_node_body_plain`` on the CPU from
    the same chunk, flags and stats: flags, stats[0:3] and the children
    equal row for row, one launch counted."""
    from ebwt2indel_torch.ops import node_cuda

    f_card, s_card = flags.clone(), stats.clone()
    f_cpu, s_cpu = flags.cpu(), stats.cpu()
    before = node_cuda.LAUNCHES["node_step"]
    got = node_cuda.node_step(fm.blocks, fm.F, chunk, f_card, s_card, K,
                              k_right)
    torch.cuda.synchronize()
    assert node_cuda.LAUNCHES["node_step"] == before + 1
    want = traverse._node_body_plain(fm_cpu, chunk.cpu(), f_cpu, s_cpu, K,
                                     k_right)
    assert torch.equal(s_card.cpu(), s_cpu)
    assert torch.equal(got.cpu(), want), (got.shape, want.shape)
    assert torch.equal(f_card.cpu(), f_cpu)


@pytest.fixture(scope="module")
def node_index(tmp_path_factory):
    """A 20.2M-position index (``genhuge``'s recipe at 1 Mbp, 20x) on the
    card and on the CPU: its node phase holds up to 351,476 nodes, so it
    pops full chunks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the node-step kernel runs only on "
                    "the card")
    from ebwt2indel_torch.models.fm_index import FMIndex

    path = tmp_path_factory.mktemp("node") / "r.ebwt"
    genhuge.build(1_000_000, str(path), coverage=20, log=lambda *a: None)
    pb = FMIndex.pack_file(str(path))
    return FMIndex.from_packed(pb, "cuda"), FMIndex.from_packed(pb, "cpu")


def _node_steps(fm, packed, keep=()):
    """Run the node phase of a mode-1 traversal on the card through the
    plain step: the rows of each step, and for each step number in ``keep``
    the (chunk, flags, stats) it was handed, copied."""
    sizes, kept = [], {}

    def step(fm_, chunk, flags, stats, K, k_right):
        if len(sizes) in keep:
            kept[len(sizes)] = (chunk.clone(), flags.clone(), stats.clone())
        sizes.append(chunk.shape[0])
        return traverse._node_body_plain(fm_, chunk, flags, stats, K,
                                         k_right)

    real = traverse._node_body
    traverse._node_body = step
    try:
        traverse.navigate_one_bwt(fm, NODE_K, NODE_K_RIGHT, packed=packed)
    finally:
        traverse._node_body = real
    return sizes, kept


@pytest.mark.parametrize("packed", [False, True])
def test_node_step_matches_plain_on_real_chunks_on_card(node_index, packed):
    """The first full chunk and a random mid-phase chunk of a real node
    phase, on the route's flags: the kernel equals the plain version row for
    row at ``CHUNK`` rows and at 1, 61 and 4,097, with K != k_right and with
    the two swapped."""
    fm, fm_cpu = node_index
    sizes, _ = _node_steps(fm, packed)
    full = sizes.index(traverse.CHUNK)
    mids = [k for k, c in enumerate(sizes)
            if k > full and c > max(NODE_SIZES)]
    mid = mids[np.random.default_rng(0x40DE).integers(len(mids))]
    _, kept = _node_steps(fm, packed, keep=(full, mid))
    for chunk, flags, stats in kept.values():
        for rows in (chunk.shape[0],) + NODE_SIZES:
            part = chunk[:rows].contiguous()
            for K, k_right in ((NODE_K, NODE_K_RIGHT),
                               (NODE_K_RIGHT, NODE_K)):
                _node_step_vs_plain(fm, fm_cpu, part, flags, stats, K,
                                    k_right)


def test_node_step_launches_once_a_step_on_card(tmp_path, rng):
    """``LAUNCHES["node_step"]`` counts the node steps of modes 1 and 3 and
    stays 0 in mode 2, whose node-pair step is plain PyTorch."""
    _needs_cuda()
    from ebwt2indel_torch.ops import node_cuda

    reads1, reads2 = _pair_reads(rng)
    (tmp_path / "r.ebwt").write_text(ebwt.ebwt_of_reads(reads1 + reads2))
    bwt, da = ebwt.ebwt_and_da_of_two(reads1, reads2)
    (tmp_path / "m.ebwt").write_text(bwt)
    (tmp_path / "m.da").write_text(da)
    (tmp_path / "a.ebwt").write_text(ebwt.ebwt_of_reads(reads1))
    (tmp_path / "b.ebwt").write_text(ebwt.ebwt_of_reads(reads2))
    out = str(tmp_path / "o.snp")
    runs = {
        1: (pipeline.run_one_dataset,
            Config(input1=str(tmp_path / "r.ebwt"), output=out)),
        3: (pipeline.run_two_datasets_da,
            Config(input1=str(tmp_path / "m.ebwt"),
                   input_da=str(tmp_path / "m.da"), output=out)),
        2: (pipeline.run_two_datasets,
            Config(input1=str(tmp_path / "a.ebwt"),
                   input2=str(tmp_path / "b.ebwt"), output=out)),
    }
    real = traverse._node_body
    for mode, (run, cfg) in runs.items():
        steps = [0]

        def counted(*a):
            steps[0] += 1
            return real(*a)

        traverse._node_body = counted
        node_cuda.reset_launches()
        try:
            run(cfg, log=lambda *a, **k: None, device="cuda")
        finally:
            traverse._node_body = real
        assert node_cuda.LAUNCHES["node_step"] == steps[0], mode
        assert (steps[0] > 0) == (mode != 2), (mode, steps[0])


def test_node_step_past_2_31_on_card():
    """Nodes whose boundaries straddle 2^31 in an index of 2^31 + 2^20
    positions (random block rows, 1 GB; flags 2 GB): the kernel's flags,
    counts and children equal the plain version's on the card, which adds
    into the flags window by window."""
    _needs_cuda()
    import types

    from ebwt2indel_torch.ops import node_cuda

    n = 2**31 + 2**20
    gen = torch.Generator(device="cuda").manual_seed(0x231)
    blocks = torch.randint(-2**31, 2**31, (n // 128 + 1, 16),
                           dtype=torch.int32, generator=gen, device="cuda")
    F = torch.tensor([0, n // 4, n // 2, 3 * n // 4], device="cuda")
    fm = types.SimpleNamespace(blocks=blocks, F=F)
    rng = np.random.default_rng(0x231)
    C, W = 4097, 64
    base = 2**31 - (C // 2) * W + W * np.arange(C)
    offs = np.sort(rng.integers(0, W, (C, 6)), axis=1)
    chunk = np.concatenate([base[:, None] + offs,
                            rng.integers(0, 40, (C, 1))], axis=1)
    chunk = torch.from_numpy(chunk).cuda()
    f_card = torch.zeros(n, dtype=torch.uint8, device="cuda")
    f_plain = torch.zeros_like(f_card)
    s_card = torch.zeros(3, dtype=torch.int64, device="cuda")
    s_plain = torch.zeros_like(s_card)
    got = node_cuda.node_step(blocks, F, chunk, f_card, s_card, NODE_K,
                              NODE_K_RIGHT)
    want = traverse._node_body_plain(fm, chunk, f_plain, s_plain, NODE_K,
                                     NODE_K_RIGHT)
    torch.cuda.synchronize()
    assert torch.equal(s_card, s_plain) and int(s_card[0]) == C
    assert torch.equal(got, want)
    assert int(f_card[2**31:].count_nonzero()) > 0
    assert torch.equal(f_card, f_plain)
