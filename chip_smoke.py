#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--log-dir DIR]

Phases, each of which must pass (the script exits 1 otherwise):

1. the card: ``nvidia-smi`` name and power limit, the kernel build time;
2. the CUDA rank kernel against its plain PyTorch version on the card, exact
   integer equality, on a random ~1M-position index (3% TERM) at
   B = 1, 1000, 2^20 and 6*256k queries, plus edge queries 0, 127, 128, n-1, n;
3. the port on CUDA against the port on the CPU on a ~4M-position dataset:
   byte-identical .snp and equal traversal/cluster stats;
4. mode 1 at full size (4.6 Mbp genome, 25x, 100 bp reads, seed 0xBE7C: the
   bench's E. coli-scale dataset, ~116M BWT positions, built once into
   ``data/``) through ``ebwt2indel_torch.cli.main`` on CUDA, with every
   kernel's launch count reset just before and read just after;
5. mode 1 on CUDA against the CPU (the plain PyTorch path) on the same
   recipe cut to a 0.575 Mbp genome (~14.5M positions): the .snp must be
   byte-identical and the stats equal;
6. the rank kernel timed against its plain version at the main path's shape:
   the first node chunk (256k nodes x 6 boundaries) of the full-size index;
   and the next-set kernel (``csrc/next_set.cu``) on 116.15 M flags of the
   benchmark's density: bit for bit its plain version, timed beside it, its
   byte bound and the ``torch.cummin`` call the plain version makes, its
   launches those of phase 4's run (each full-size and mesh run below logs
   its ``next_set`` launches beside ``rank_decode``'s and must launch both);
   and mode 1's emission kernel (``csrc/emit_single.cu``) over the
   emission's inputs of phase 4's run and of a mode-1 run on the hivar
   cell's recipe (``portbench/configs/ecoli25x-hivar-single.json``, built
   into ``data/hivar/``): the same text and counts as its plain version,
   timed at the hivar shapes beside its byte bound and the plain version's
   wall; its launches (``emit_single``) are logged with the others, once
   in each mode-1 run and never in modes 2 and 3;
7. three more full-size CUDA runs for the spread of the wall and phase times
   (median, min, max), then one with ``EBWT_PROFILE`` set, whose trace the
   port's ``tracetop`` reads: device time by kernel name and by phase, and
   the device's busy share of the run;
8. modes 3 and 2 on CUDA against the CPU on the pair data of phase 3's
   recipe (the two haplotypes' reads as two collections): byte-identical
   .snp and equal stats;
9. the bench's pair datasets (bench.py:94-121) built into ``data/`` from the
   same reads as phase 4: ``a.ebwt`` and ``b.ebwt`` (~58M positions each)
   and the merged ``.ebwt`` and ``.da`` (~116M positions);
10. modes 3 (``-1 merged.ebwt -d merged.da``) and 2 (``-1 a.ebwt -2
    b.ebwt``) at full size through ``cli.main`` on CUDA, each with the
    kernel's launch count reset just before and read just after; then three
    more runs of each for the spread, and one of each with ``EBWT_PROFILE``
    (as in phase 7);
11. ``packed_116M``: modes 1, 3 and 2 at full size on the dense and on the
    bit-packed route (``packed=``), each run with the launch counts reset
    just before and read just after: the .snp of both routes must equal the
    ``cli.main`` run's, with equal stats; wall and peak device memory of
    each route;
12. ``scale_mode1_1G``: ``data/huge_1g.ebwt`` from the port's ``genhuge``
    (41.6 Mbp genome, 25x, 100 bp reads, seed 0xB16B16: 1,050,398,182
    positions), mode 1 through ``cli.main`` on the default route, then on
    the other route through ``run_one_dataset``: byte-identical .snp and
    equal stats; wall, phase seconds, peak device memory and launches of
    each route. The packed route must peak at most 12 bytes per position;
13. ``tools_cuda_vs_cpu``: ``pebwt2indel`` on phase 3's reads (written as
    FASTA; 3 workers, reads of 100, two pieces) on CUDA and on the CPU: the
    ``variants.snp`` must be byte-identical, and the CUDA run must launch
    ``rank_decode`` (counts reset just before it and read just after);
14. ``validate_116M``: ``validate_huge`` on phase 4's .snp, the truth
    regenerated from seed 0xBE7C and the 4.6 Mbp genome (filter m=5,
    context placement, sort, ``vcf_vs_vcf``): SNP and indel sensitivity at
    least 0.85 and precision at least 0.95;
15. ``pebwt2indel_116M``: ``pebwt2indel`` on phase 4's reads on CUDA (4
    workers, three pieces of ~39M positions), with ``rank_decode``
    launched, scored as phase 14 and again, with phase 4's .snp, at m=3
    (a piece holds a third of the coverage): at m=3 its SNP sensitivity at
    least 0.6 times the in-process one (the JAX package's contract,
    tests/test_endtoend_scoring.py:121-122);
16. ``resume_116M``: mode 1 at full size with a checkpoint directory,
    killed in the node phase (a wrapped node step raises after the phase's
    second save) and run again: the .snp must equal phase 4's, the stats
    (but ``max_pending``) equal, and the checkpoint gone; the size of each
    checkpoint and the seconds per save;
17. ``mesh_rank_vs_plain``: the position mesh (``ebwt2indel_torch/
    parallel/``) of 4 shards on the one card over the full-size index: its
    sharded rank (each query decoded by ``rank_decode`` on its owning
    shard's rows, the shards' answers summed), each shard's narrow rank on
    its own rows and halo row, and its sharded select, against the plain
    version over the whole index; max_abs_err 0;
18. ``mesh4_mode1_116M``: mode 1 with ``EBWT_MESH=4`` through ``cli.main``
    on CUDA (4 shards on the one card), the launch counts reset just before
    and read just after: the .snp sha256 must equal phase 4's and the stats
    too; per-phase seconds, mesh steps, peak device memory, launches and
    queries;
19. ``mesh4_mode3_116M`` and ``mesh4_mode2_116M``: modes 3 and 2 the same
    way on phase 9's pair data: each .snp sha256 must equal phase 10's, and
    the stats too (mode 2: with its DA values, leaves and nodes); the same
    records, and for mode 2 the routed bytes per mesh step;
20. ``mesh4_resume_mode1_116M`` and ``mesh4_resume_mode2_116M``: modes 1 and
    2 with ``EBWT_MESH=4`` through ``cli.main``: a run without a checkpoint
    directory counts the node (node-pair) mesh steps; a run with
    ``EBWT_CKPT_DIR`` set is killed in that phase after its second save (a
    wrapped step function raises); the run started again resumes. Its .snp
    sha256 must equal phase 4's (phase 10's), its stats too (mesh steps and
    mode 2's routed bytes per step among them), it must take the node steps
    less 2 x the save interval, launch ``rank_decode``, and leave the
    checkpoint directory empty; the bytes and seconds of each save, the
    killed run's seconds and the resumed run's wall (the time to recover).
    Where the host has two cards or more, modes 1, 3 and 2 at full size as
    two NCCL processes of two shards each (``mesh_nccl_2proc``); with one
    card that phase does not run, and a line says so;
21. ``index_cache_116M``: modes 1 and 2 with ``EBWT_INDEX_CACHE=1``, cold
    (the ``.idx.npz`` sidecars written) and warm (read; packing fails the
    phase): each .snp equal to phase 4's (phase 10's); ``index`` seconds of
    both, the sidecars' bytes and the seconds of their writes;
22. ``mesh4_mode1_1G``: mode 1 with ``EBWT_MESH=4`` on phase 12's
    1,050,398,182 positions: the .snp must equal phase 12's dense-route
    .snp, with equal stats;
23. ``index_cache_1G``: phase 12's input packed into its sidecar, then mode
    1 through ``cli.main`` with ``EBWT_INDEX_CACHE=1`` reading it (packing
    fails the phase): the .snp must equal phase 12's;
24. ``past2g31_data``: phase 4's eBWT and phase 9's pair files with every
    byte repeated 19 times (``write_kfold``, chunk by chunk), which is the
    eBWT (and document array) of every read repeated 19 times in place:
    2,206,844,243 positions, past 2^31, in modes 1 and 3, and n1 + n2 the
    same in mode 2; and the 2-fold files (232,299,394 positions). A
    coordinate-range witness on a duplicated-read input, not a benchmark
    cell; the files (about 10 GB) are deleted when phase 27 ends;
25. ``past2g31_rank``: ``rank_decode`` on the 19-fold index at positions
    0, 127, 128, 2^31 - 129, 2^31 - 1, 2^31, 2^31 + 1, 2^31 + 128, n - 1, n
    and 2^20 random ones in [2^31, n], against its plain version on the card
    (max_abs_err 0) and, at twenty of them, against A/C/G/T counts that
    numpy takes straight from the file's bytes;
26. ``past2g31_mode1``, ``_mode3`` and ``_mode2``: each mode through
    ``cli.main`` on the 19-fold input on its default (bit-packed) route and
    on the 2-fold input on its (dense) one, the launch counts reset just
    before each and read just after: leaves, nodes, n_min and max_pending
    must be equal, lcp_values (mode 2: da_values too) n, and mode 1 must
    peak at most 12 bytes per position; wall, phase seconds, peak, launches,
    queries, and the .snp's bytes and sha256;
27. ``mesh4_past2g31_mode1``, ``_mode3`` and ``_mode2``: the 19-fold inputs
    with ``EBWT_MESH=4`` (as phase 18): the .snp sha256 and the stats must
    equal phase 26's.

It prints the per-kernel JSON line, then the card line, and last
``{"ok": true, "device": {...}}``. Without CUDA, or without the
``ebwt2indel_torch`` package beside it, it exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import hashlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time
import traceback

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
INT32_OPS_PER_S = 67e12  # non-tensor 32-bit rate of the same sheet (FP32)
GENOME_LEN = 4_600_000
SEED = 0xBE7C
COVERAGE = 25
READ_LEN = 100
CPU_GENOME_LEN = 575_000  # the CUDA-vs-CPU comparison's depth (~14.5M)
HUGE_GENOME_LEN = 41_600_000  # the 1.05G-position scale cell
# what the recipe gives with today's simulate.py (repo root and port alike);
# the JAX package's round-3 record, 1,050,399,394, predates a change there
HUGE_N = 1_050_398_182
PACKED_MAX_BYTES_PER_POS = 12
# the past-2^31 witness: phase 4's eBWT with every read repeated 19 times
KFOLD = 19
KFOLD_N = 2_206_844_243
# the emission kernel's timing input: the benchmark's hivar recipe
HIVAR_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "portbench", "configs",
                            "ecoli25x-hivar-single.json")
HIVAR_SEED = 0x51D7
# floors of the 116M evaluation loop, well under the TPU-era record on the
# same recipe (VALIDATION_r05.json: 0.9555 / 0.9859 / 1.0 at 2.575G)
VALIDATE_MIN_SENSITIVITY = 0.85
VALIDATE_MIN_PRECISION = 0.95


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else \
        f"nvidia-smi failed: {r.stderr.strip()}"


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@functools.lru_cache(maxsize=2)
def make_reads(genome_len: int, seed: int, coverage: float, read_len: int):
    """The bench's recipe (bench.py:65-75): reads of a genome and of a second
    haplotype, each at half coverage."""
    from ebwt2indel_torch.tools import simulate

    rng = np.random.default_rng(seed)
    genome = simulate.random_genome(rng, genome_len)
    hap2, _ = simulate.plant_variants(rng, genome, snp_rate=0.001,
                                      indel_rate=0.0002)
    return (simulate.sample_reads(rng, genome, coverage / 2, read_len),
            simulate.sample_reads(rng, hap2, coverage / 2, read_len))


def _write(path: str, text: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path + ".tmp", "w") as f:
        f.write(text)
    os.replace(path + ".tmp", path)


def make_dataset(path: str, genome_len: int, seed: int, coverage: float,
                 read_len: int = READ_LEN) -> int:
    """Mode 1's input: both read sets as one collection; returns the number
    of BWT positions."""
    from ebwt2indel_torch.tools import ebwt

    if not os.path.isfile(path):
        reads1, reads2 = make_reads(genome_len, seed, coverage, read_len)
        _write(path, ebwt.ebwt_of_reads(reads1 + reads2))
    return os.path.getsize(path)


def make_pair_datasets(prefix: str, genome_len: int, seed: int,
                       coverage: float) -> dict:
    """The pair modes' inputs from the same reads (bench.py:94-121): an eBWT
    of each read set (mode 2), and the merged eBWT with its document array
    (mode 3). Logs each file's size and build seconds."""
    from ebwt2indel_torch.tools import ebwt

    paths = {k: f"{prefix}_{k}" for k in ("a.ebwt", "b.ebwt", "merged.ebwt",
                                          "merged.da")}
    if all(os.path.isfile(p) for p in paths.values()):
        return paths
    reads1, reads2 = make_reads(genome_len, seed, coverage, READ_LEN)
    for key, reads in (("a.ebwt", reads1), ("b.ebwt", reads2)):
        t0 = time.perf_counter()
        _write(paths[key], ebwt.ebwt_of_reads(reads))
        log(f"[data] {paths[key]}: {os.path.getsize(paths[key])} positions "
            f"in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    bwt, da = ebwt.ebwt_and_da_of_two(reads1, reads2)
    _write(paths["merged.da"], da)
    _write(paths["merged.ebwt"], bwt)
    log(f"[data] {paths['merged.ebwt']} and .da: {len(bwt)} positions "
        f"({da.count('1')} of collection 2) in "
        f"{time.perf_counter() - t0:.1f} s")
    return paths


def phase_kernel_vs_plain() -> None:
    import torch

    from ebwt2indel_torch.ops import packing, rank

    rng = np.random.default_rng(1)
    n = 1_000_003
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    codes[rng.random(n) < 0.03] = 4
    pb = packing.pack_codes(codes)
    blocks = torch.from_numpy(pb.blocks.view(np.int32)).cuda()
    for B in (1, 1000, 1 << 20, 6 * 256 * 1024):
        q = torch.from_numpy(rng.integers(0, n + 1, size=B)).cuda()
        got = rank.parallel_rank(blocks, q)
        torch.cuda.synchronize()
        want = rank.parallel_rank_plain(blocks, q)
        if not torch.equal(got, want):
            raise AssertionError(f"rank kernel != plain at B={B}")
        log(f"[kernel] B={B}: equal to the plain version")
    edges = [0, 127, 128, n - 1, n]
    got = rank.parallel_rank(blocks, torch.tensor(edges, device="cuda"))
    for k, i in enumerate(edges):
        want = [int((codes[:i] == c).sum()) for c in range(4)]
        if got[k].tolist() != want:
            raise AssertionError(f"rank kernel at {i}: {got[k].tolist()} "
                                 f"!= {want}")
    log(f"[kernel] edge queries {edges}: equal to counts of the string")
    ms = time_ms(lambda: rank.parallel_rank(blocks, q), 50)
    plain = time_ms(lambda: rank.parallel_rank_plain(blocks, q), 5)
    log(f"[kernel] random queries, B={q.shape[0]} on n={n}: kernel "
        f"{ms:.4f} ms, plain {plain:.4f} ms")
    # consensus ties must go to the first maximum (A<C<G<T) on the card too
    x = torch.tensor([[3, 5, 5, 1], [2, 2, 2, 2], [0, 0, 1, 1]],
                     device="cuda")
    if torch.argmax(x, dim=-1).tolist() != [1, 0, 2]:
        raise AssertionError("torch.argmax on CUDA does not take the first "
                             "maximum")


def run_mode1(path: str, out: str, device: str, packed=None):
    from ebwt2indel_torch.models import pipeline
    from ebwt2indel_torch.utils.config import Config

    return pipeline.run_one_dataset(Config(input1=path, output=out),
                                    log=lambda *a, **k: None, device=device,
                                    packed=packed)


_COMPARED = ("leaves", "nodes", "lcp_values", "n_min", "n_clusters",
             "events", "cluster_nr")


def phase_cuda_vs_cpu(data_dir: str, genome_len: int = 200_000,
                      seed: int = 7, coverage: float = 20) -> None:
    tag = f"g{genome_len}_c{coverage}_l{READ_LEN}"
    path = os.path.join(data_dir, f"smoke_{tag}.ebwt")
    n = make_dataset(path, genome_len, seed, coverage)
    outs, stats = {}, {}
    for dev in ("cuda", "cpu"):
        out = os.path.join(data_dir, f"smoke_{tag}_{dev}.snp")
        t0 = time.perf_counter()
        stats[dev] = run_mode1(path, out, dev)
        log(f"[cuda-vs-cpu] {dev}: {time.perf_counter() - t0:.3f} s on "
            f"{n} positions, {stats[dev]['events']} events")
        outs[dev] = open(out, "rb").read()
    if outs["cuda"] != outs["cpu"]:
        raise AssertionError("CUDA .snp differs from the CPU .snp")
    for k in _COMPARED:
        if stats["cuda"][k] != stats["cpu"][k]:
            raise AssertionError(f"{k}: cuda {stats['cuda'][k]} != cpu "
                                 f"{stats['cpu'][k]}")
    if not outs["cpu"]:
        raise AssertionError("the small dataset produced no events")
    log(f"[cuda-vs-cpu] .snp byte-identical ({len(outs['cpu'])} bytes), "
        f"stats equal: {', '.join(_COMPARED)}")


def _grab(pattern: str, text: str, cast=float):
    m = re.search(pattern, text)
    if m is None:
        raise AssertionError(f"log line not found: {pattern}")
    return tuple(cast(g) for g in m.groups())


def _cli_run(args: list, cli_log: str) -> dict:
    """One ``cli.main`` run on CUDA, with the launch counts and the peak
    device memory reset just before and read just after; its log goes to
    ``cli_log``."""
    import torch

    from ebwt2indel_torch import cli
    from ebwt2indel_torch.ops import emit_cuda, rank_cuda, scan_cuda

    os.makedirs(os.path.dirname(cli_log), exist_ok=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rank_cuda.reset_launches()
    scan_cuda.reset_launches()
    emit_cuda.reset_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(args, device="cuda")
    torch.cuda.synchronize()
    r = {"wall": time.perf_counter() - t0, "text": buf.getvalue(),
         "launches": {**rank_cuda.LAUNCHES, **scan_cuda.LAUNCHES,
                      **emit_cuda.LAUNCHES},
         "queries": dict(rank_cuda.QUERIES),
         "peak": torch.cuda.max_memory_allocated()}
    with open(cli_log, "w") as f:
        f.write(r["text"])
    if rc != 0:
        raise AssertionError(f"cli.main returned {rc} (see {cli_log})")
    return r


def _mode1_log(text: str) -> dict:
    """The stats (``_COMPARED``, ``n``) and phase ``seconds`` of a mode-1
    ``cli.main`` log."""
    st = {}
    st["leaves"], st["nodes"] = _grab(
        r"Processed (\d+) suffix-tree leaves and (\d+) nodes", text, int)
    st["lcp_values"], st["n"] = _grab(r"Computed (\d+)/(\d+) LCP values",
                                      text, int)
    (st["n_min"],) = _grab(r"Found (\d+) LCP minima", text, int)
    (st["n_clusters"],) = _grab(r"Analyzed (\d+) clusters", text, int)
    st["events"], clusters = _grab(r"Stored to file (\d+) events clustered "
                                   r"in (\d+) clusters", text, int)
    st["cluster_nr"] = clusters + 1
    (t_index,) = _grab(r"done\. \[([0-9.]+)s\]", text)
    t_leaf, t_node = _grab(r"leaf phase ([0-9.]+)s, node phase ([0-9.]+)s",
                           text)
    (t_cluster,) = _grab(r"cluster detect \((?:device|sharded)\) "
                         r"([0-9.]+)s", text)
    (t_call,) = _grab(r"call\+emit ([0-9.]+)s", text)
    st["seconds"] = {"index": t_index, "leaf_phase": t_leaf,
                     "node_phase": t_node, "cluster": t_cluster,
                     "call_emit": t_call}
    return st


def phase_full(results: dict, data_dir: str, log_dir: str) -> None:
    tag = f"g{GENOME_LEN}_c{COVERAGE}_l{READ_LEN}"
    path = os.path.join(data_dir, f"reads_{tag}.ebwt")
    t0 = time.perf_counter()
    n = make_dataset(path, GENOME_LEN, SEED, COVERAGE)
    log(f"[full] set-up: dataset of {n} BWT positions ready in "
        f"{time.perf_counter() - t0:.1f} s ({path})")
    out = os.path.join(data_dir, f"reads_{tag}.snp")
    r = _cli_run(["-1", path, "-o", out],
                 os.path.join(log_dir, "chip_smoke_cli.log"))
    st = _mode1_log(r["text"])
    wall, launches = r["wall"], r["launches"]
    digest = hashlib.sha256(open(out, "rb").read()).hexdigest()
    log(f"[full] mode 1 on {st['n']} positions: {wall:.3f} s wall "
        f"({st['n'] / wall / 1e6:.3f} Mpos/s)")
    log(f"[full] phase seconds: {st['seconds']}")
    log(f"[full] stats: " + ", ".join(f"{k} {st[k]}" for k in _COMPARED))
    log(f"[full] .snp sha256 {digest}")
    log(f"[full] torch.cuda.max_memory_allocated {r['peak']} bytes")
    log(f"[full] kernels {json.dumps(launches)}; queries "
        f"{json.dumps(r['queries'])}")
    if st["n"] != n or not (0 < st["lcp_values"] <= n) or st["events"] <= 0:
        raise AssertionError("implausible full-size result")
    if launches["rank_decode"] <= 0 or launches["next_set"] <= 0 or \
            launches["emit_single"] != 1:
        raise AssertionError(f"a kernel never launched on the main path, or "
                             f"the emission not once: {launches}")
    results["launches"] = launches
    results["full_stats"] = st
    results["full_path"] = path
    results["n"] = n
    results["full_out"] = out
    results["full_wall"] = wall


def phase_repeats(results: dict, data_dir: str, reps: int = 3,
                  mode: int = 1) -> None:
    """Spread of the full-size CUDA run of a mode: wall and phase
    seconds."""
    import torch

    tag = "" if mode == 1 else f"mode{mode}_"
    r = results if mode == 1 else results[f"mode{mode}"]
    out = os.path.join(data_dir, f"full_{tag}repeat.snp")
    walls, phases = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = RUNS[mode](r["full_path"], out, "cuda")
        walls.append(time.perf_counter() - t0)
        phases.append(st["seconds"])
    if open(out, "rb").read() != open(r["full_out"], "rb").read():
        raise AssertionError("a repeated run wrote another .snp")
    n = r["n"]
    log(f"[repeats] mode {mode}, {reps} runs, wall s: median "
        f"{np.median(walls):.4f}, min {min(walls):.4f}, max "
        f"{max(walls):.4f}; median {n / np.median(walls) / 1e6:.3f} Mpos/s; "
        f"all: {[round(w, 4) for w in walls]}")
    for k in phases[0]:
        v = [p[k] for p in phases]
        log(f"[repeats] mode {mode} {k}: median {np.median(v):.4f}, min "
            f"{min(v):.4f}, max {max(v):.4f}")


def phase_profile(results: dict, data_dir: str, mode: int = 1) -> None:
    """Device time by kernel and by phase over one full-size CUDA run with
    ``EBWT_PROFILE`` set, read by the port's ``tracetop``."""
    from ebwt2indel_torch.tools import tracetop

    r = results if mode == 1 else results[f"mode{mode}"]
    prof_dir = os.path.join(data_dir, f"profile_mode{mode}")
    shutil.rmtree(prof_dir, ignore_errors=True)
    out = os.path.join(data_dir, f"full_profiled_mode{mode}.snp")
    os.environ["EBWT_PROFILE"] = prof_dir
    t0 = time.perf_counter()
    try:
        RUNS[mode](r["full_path"], out, "cuda")
    finally:
        del os.environ["EBWT_PROFILE"]
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    trace = tracetop.newest_trace(prof_dir)
    top = tracetop.summarize(tracetop.load_events(trace), 12)
    log(f"[profile] mode {mode}: trace of {os.path.getsize(trace)} bytes "
        f"read by tracetop in {time.perf_counter() - t0:.1f} s")
    if open(out, "rb").read() != open(r["full_out"], "rb").read():
        raise AssertionError("the profiled run wrote another .snp")
    if not top["device"]:
        log("[profile] the trace holds no device time: not measured")
        return
    busy = top["busy_ms"]
    log(f"[profile] mode {mode}: device busy {busy:.1f} ms over "
        f"{wall * 1e3:.1f} ms of profiled wall, the trace's export included "
        f"({100 * busy / (wall * 1e3):.1f}%); unprofiled wall "
        f"{r['full_wall'] * 1e3:.1f} ms")
    for name, ms, count in top["kernels"]:
        log(f"[profile] {ms:10.3f} ms  {100 * ms / busy:5.1f}%  {count:6d}  "
            f"{name[:100]}")
    five = ("index", "leaf_phase", "node_phase", "cluster", "call_emit")
    # the parts of a phase (index.pack, ...) are spans inside it
    in_phases = sum(p["busy_ms"] for name, p in top["phases"].items()
                    if name in five)
    log(f"[profile] mode {mode}: {top['linked']} device events placed in "
        f"phases by their launch; {in_phases:.3f} ms of the device time in "
        "the five phases")
    for name, p in top["phases"].items():
        log(f"[profile] mode {mode} phase {name}: device {p['busy_ms']:.3f} "
            f"ms of a {p['span_ms']:.3f} ms span")
    missing = set(five) - set(top["phases"])
    if missing:
        raise AssertionError(f"phases not marked in the trace: {missing}")
    # a phase ends with a device synchronise, so the device time of the
    # kernels it launched fits in its span, and the five phases hold nearly
    # all of the run's: more in a phase, or less in all, means misplaced
    # events
    over = [name for name, p in top["phases"].items()
            if name in five and p["busy_ms"] > 1.02 * p["span_ms"] + 1.0]
    if over or in_phases < 0.95 * busy:
        raise AssertionError(f"device time misplaced: over the span in "
                             f"{over}, {in_phases:.3f} of {busy:.3f} ms in "
                             "the phases")


def run_mode3(paths: dict, out: str, device: str, packed=None):
    from ebwt2indel_torch.models import pipeline
    from ebwt2indel_torch.utils.config import Config

    return pipeline.run_two_datasets_da(
        Config(input1=paths["merged.ebwt"], input_da=paths["merged.da"],
               output=out), log=lambda *a, **k: None, device=device,
        packed=packed)


def run_mode2(paths: dict, out: str, device: str, packed=None):
    from ebwt2indel_torch.models import pipeline
    from ebwt2indel_torch.utils.config import Config

    return pipeline.run_two_datasets(
        Config(input1=paths["a.ebwt"], input2=paths["b.ebwt"], output=out),
        log=lambda *a, **k: None, device=device, packed=packed)


RUNS = {1: run_mode1, 2: run_mode2, 3: run_mode3}


def phase_pair_cuda_vs_cpu(data_dir: str) -> None:
    """Modes 3 and 2 on CUDA against the CPU on phase 3's recipe, the two
    haplotypes' reads as two collections."""
    paths = make_pair_datasets(os.path.join(data_dir, "smoke_g200000_c20"),
                               200_000, 7, 20)
    n = os.path.getsize(paths["merged.ebwt"])
    for mode in (3, 2):
        outs, stats = {}, {}
        for dev in ("cuda", "cpu"):
            out = os.path.join(data_dir, f"smoke_small_mode{mode}_{dev}.snp")
            t0 = time.perf_counter()
            stats[dev] = RUNS[mode](paths, out, dev)
            log(f"[pair-cuda-vs-cpu] mode {mode} {dev}: "
                f"{time.perf_counter() - t0:.3f} s on {n} merged positions, "
                f"{stats[dev]['events']} events")
            outs[dev] = open(out, "rb").read()
        if outs["cuda"] != outs["cpu"]:
            raise AssertionError(f"mode {mode}: CUDA .snp differs from the "
                                 "CPU .snp")
        keys = _COMPARED + (("da_values",) if mode == 2 else ())
        for k in keys:
            if stats["cuda"][k] != stats["cpu"][k]:
                raise AssertionError(f"mode {mode} {k}: cuda "
                                     f"{stats['cuda'][k]} != cpu "
                                     f"{stats['cpu'][k]}")
        if stats["cpu"]["events"] <= 0:
            raise AssertionError(f"mode {mode}: the small pair dataset gave "
                                 "no events")
        log(f"[pair-cuda-vs-cpu] mode {mode}: .snp byte-identical "
            f"({len(outs['cpu'])} bytes), stats equal: {', '.join(keys)}")


def phase_pair_data(results: dict, data_dir: str) -> None:
    tag = f"g{GENOME_LEN}_c{COVERAGE}_l{READ_LEN}"
    t0 = time.perf_counter()
    paths = make_pair_datasets(os.path.join(data_dir, tag), GENOME_LEN, SEED,
                               COVERAGE)
    n = os.path.getsize(paths["merged.ebwt"])
    if n != os.path.getsize(paths["a.ebwt"]) + \
            os.path.getsize(paths["b.ebwt"]):
        raise AssertionError("the merged eBWT is not the sum of its parts")
    log(f"[data] pair datasets ready in {time.perf_counter() - t0:.1f} s")
    results["pair_paths"] = paths


def _pair_args(paths: dict, mode: int) -> list:
    return (["-1", paths["a.ebwt"], "-2", paths["b.ebwt"]] if mode == 2
            else ["-1", paths["merged.ebwt"], "-d", paths["merged.da"]])


def _pair_log(text: str, snp: bytes, mode: int) -> dict:
    """The stats and phase ``seconds`` of a mode-3 or mode-2 ``cli.main``
    log (single device or mesh) and its .snp."""
    st = {}
    st["lcp_values"], st["n"] = _grab(r"Computed (\d+)/(\d+) LCP values",
                                      text, int)
    (st["n_min"],) = _grab(r"Found (\d+) LCP minima", text, int)
    (st["n_clusters"],) = _grab(r"Analyzed (\d+) clusters", text, int)
    st["events"] = snp.count(b">") // 2  # a pair event is two records
    (t_index,) = _grab(r"done\. \[([0-9.]+)s\]", text)
    t_leaf, t_node = _grab(r"leaf phase ([0-9.]+)s, node phase ([0-9.]+)s",
                           text)
    (t_cluster,) = _grab(r"\[timing\] cluster detect[^0-9]*([0-9.]+)s",
                         text)
    (t_call,) = _grab(r"call\+emit ([0-9.]+)s", text)
    st["seconds"] = {"index": t_index, "leaf_phase": t_leaf,
                     "node_phase": t_node, "cluster": t_cluster,
                     "call_emit": t_call}
    if mode == 2:
        (st["da_values"],) = _grab(r"Computed (\d+)/\d+ DA values", text,
                                   int)
        st["leaves"], st["nodes"] = _grab(
            r"Processed (\d+) suffix-tree leaves and (\d+) nodes", text, int)
    else:
        (st["seconds"]["da_wait"],) = _grab(r"DA-side index wait ([0-9.]+)s",
                                            text)
    return st


def phase_full_pair(results: dict, mode: int, data_dir: str,
                    log_dir: str) -> None:
    """Mode 3 or 2 at full size through ``cli.main`` on CUDA."""
    paths = results["pair_paths"]
    out = os.path.join(data_dir, f"full_mode{mode}.snp")
    r = _cli_run(_pair_args(paths, mode) + ["-o", out],
                 os.path.join(log_dir, f"chip_smoke_cli_mode{mode}.log"))
    wall, launches = r["wall"], r["launches"]
    snp = open(out, "rb").read()
    st = _pair_log(r["text"], snp, mode)
    n_total = st["n"]
    log(f"[full] mode {mode} on {n_total} merged positions: {wall:.3f} s "
        f"wall ({n_total / wall / 1e6:.3f} Mpos/s)")
    log(f"[full] mode {mode} phase seconds: {st['seconds']}")
    log(f"[full] mode {mode} stats: " + ", ".join(
        f"{k} {v}" for k, v in st.items() if k not in ("n", "seconds")))
    log(f"[full] mode {mode}: {st['events']} events; .snp sha256 "
        f"{hashlib.sha256(snp).hexdigest()}")
    log(f"[full] mode {mode} torch.cuda.max_memory_allocated {r['peak']} "
        "bytes")
    log(f"[full] mode {mode} kernels {json.dumps(launches)}; queries "
        f"{json.dumps(r['queries'])}")
    n = os.path.getsize(paths["merged.ebwt"])
    if n_total != n or not (0 < st["lcp_values"] <= n) or st["events"] <= 0:
        raise AssertionError(f"implausible full-size mode-{mode} result")
    if launches["rank_decode"] <= 0 or launches["next_set"] <= 0 or \
            launches["emit_single"] != 0:
        raise AssertionError(f"a kernel never launched on mode {mode}, or "
                             f"mode 1's emission did: {launches}")
    results[f"mode{mode}"] = {"full_path": paths, "full_out": out, "n": n,
                              "full_wall": wall, "stats": st}


def _measured_run(mode: int, inp, out: str, packed) -> dict:
    """One CUDA run of a mode on a forced route, with the launch counts and
    the peak memory reset just before and read just after."""
    import torch

    from ebwt2indel_torch.ops import rank_cuda, scan_cuda

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rank_cuda.reset_launches()
    scan_cuda.reset_launches()
    t0 = time.perf_counter()
    st = RUNS[mode](inp, out, "cuda", packed=packed)
    torch.cuda.synchronize()
    return {"wall": time.perf_counter() - t0, "stats": st,
            "peak": torch.cuda.max_memory_allocated(),
            "launches": rank_cuda.LAUNCHES["rank_decode"],
            "queries": rank_cuda.QUERIES["rank_decode"],
            "next_set": scan_cuda.LAUNCHES["next_set"],
            "snp": open(out, "rb").read()}


def _compare_routes(label: str, runs: dict, keys) -> None:
    """The dense (False) and packed (True) runs wrote the same .snp, with
    equal stats, and both launched the rank and next-set kernels."""
    if runs[False]["snp"] != runs[True]["snp"]:
        raise AssertionError(f"{label}: the packed .snp differs from the "
                             "dense .snp")
    for k in keys:
        if runs[False]["stats"][k] != runs[True]["stats"][k]:
            raise AssertionError(f"{label} {k}: dense "
                                 f"{runs[False]['stats'][k]} != packed "
                                 f"{runs[True]['stats'][k]}")
    for packed, r in runs.items():
        if r["launches"] <= 0 or r["next_set"] <= 0:
            raise AssertionError(f"{label}: rank_decode or next_set never "
                                 f"launched on the {_ROUTE[packed]} route")


_ROUTE = {False: "dense", True: "packed"}


def _route_line(label: str, packed: bool, r: dict, n: int) -> None:
    phases = ", ".join(f"{k} {v:.4f}" for k, v in r["stats"]["seconds"]
                       .items())
    log(f"[{label}] {_ROUTE[packed]}: wall {r['wall']:.4f} s "
        f"({n / r['wall'] / 1e6:.3f} Mpos/s); phases: {phases}; peak "
        f"{r['peak']} bytes ({r['peak'] / n:.3f} B/position); rank_decode "
        f"{r['launches']} launches, {r['queries']} queries; next_set "
        f"{r['next_set']} launches")


def phase_packed_116m(results: dict, data_dir: str) -> None:
    """Modes 1, 3 and 2 at full size on both routes: each .snp equals the
    ``cli.main`` run's of the earlier phases."""
    for mode in (1, 3, 2):
        r = results if mode == 1 else results[f"mode{mode}"]
        want = open(r["full_out"], "rb").read()
        runs = {}
        for packed in (False, True):
            out = os.path.join(data_dir, f"full_mode{mode}_{_ROUTE[packed]}"
                                         ".snp")
            runs[packed] = _measured_run(mode, r["full_path"], out, packed)
            if runs[packed]["snp"] != want:
                raise AssertionError(f"mode {mode} {_ROUTE[packed]}: the "
                                     ".snp differs from the cli.main run's")
            _route_line(f"packed_116M mode {mode}", packed, runs[packed],
                        r["n"])
        keys = _COMPARED + (("da_values",) if mode == 2 else ())
        _compare_routes(f"mode {mode}", runs, keys)
        log(f"[packed_116M] mode {mode}: both routes' .snp byte-identical "
            f"to the cli.main run's ({len(want)} bytes), stats equal: "
            f"{', '.join(keys)}")


def phase_scale_1g(results: dict, data_dir: str, log_dir: str) -> None:
    """Mode 1 at 1,050,398,182 positions: the default route through
    ``cli.main``, then the other route through ``run_one_dataset``."""
    from ebwt2indel_torch.models import traverse
    from ebwt2indel_torch.tools import genhuge

    path = os.path.join(data_dir, "huge_1g.ebwt")
    if not os.path.isfile(path):
        t0 = time.perf_counter()
        genhuge.build(HUGE_GENOME_LEN, path, COVERAGE, READ_LEN, log=log)
        log(f"[scale_1G] set-up: genhuge built {path} in "
            f"{time.perf_counter() - t0:.1f} s")
    n = os.path.getsize(path)
    log(f"[scale_1G] {n} positions (the recipe's: {HUGE_N})")
    if n != HUGE_N:
        raise AssertionError(f"genhuge wrote {n} positions, not {HUGE_N}")
    default = n >= traverse.LEAN_N
    out = os.path.join(data_dir, "huge_1g_default.snp")
    r = _cli_run(["-1", path, "-o", out],
                 os.path.join(log_dir, "chip_smoke_cli_1g.log"))
    runs = {default: {"wall": r["wall"], "stats": _mode1_log(r["text"]),
                      "peak": r["peak"],
                      "launches": r["launches"]["rank_decode"],
                      "queries": r["queries"]["rank_decode"],
                      "next_set": r["launches"]["next_set"],
                      "snp": open(out, "rb").read()}}
    _route_line("scale_1G cli.main", default, runs[default], n)
    runs[not default] = _measured_run(
        1, path, os.path.join(data_dir, "huge_1g_other.snp"), not default)
    _route_line("scale_1G", not default, runs[not default], n)
    _compare_routes("1.05G mode 1", runs, _COMPARED)
    if runs[True]["stats"]["events"] <= 0:
        raise AssertionError("the 1.05G input gave no events")
    results["huge"] = {"path": path, "n": n, "out": out,
                       "stats": runs[default]["stats"]}
    log(f"[scale_1G] both routes' .snp byte-identical "
        f"({len(runs[True]['snp'])} bytes, sha256 "
        f"{hashlib.sha256(runs[True]['snp']).hexdigest()}), stats equal: "
        f"{', '.join(_COMPARED)}")
    per_pos = runs[True]["peak"] / n
    if per_pos > PACKED_MAX_BYTES_PER_POS:
        raise AssertionError(f"the packed route peaked at {per_pos:.3f} "
                             f"bytes per position, over "
                             f"{PACKED_MAX_BYTES_PER_POS}")


def _reads_fasta(path: str, genome_len: int, seed: int,
                 coverage: float) -> str:
    """Both read sets of a recipe as one FASTA file (pebwt2indel's input),
    written once."""
    from ebwt2indel_torch.tools import ebwt

    if not os.path.isfile(path):
        reads1, reads2 = make_reads(genome_len, seed, coverage, READ_LEN)
        ebwt.write_fasta_reads(path + ".tmp", reads1 + reads2)
        os.replace(path + ".tmp", path)
    return path


def _pebwt2indel(fasta: str, threads: int, outdir: str, device: str):
    """One ``pebwt2indel`` run; on CUDA with the launch counts reset just
    before and read just after. Returns the .snp bytes, the wall, the
    launches and the tool's timing line."""
    import torch

    from ebwt2indel_torch.ops import rank_cuda
    from ebwt2indel_torch.tools import pebwt2indel

    lines: list[str] = []
    if device == "cuda":
        torch.cuda.synchronize()
        rank_cuda.reset_launches()
    t0 = time.perf_counter()
    final = pebwt2indel.run(fasta, threads, READ_LEN, outdir, device=device,
                            log=lines.append)
    if device == "cuda":
        torch.cuda.synchronize()
    return {"snp": open(final, "rb").read(), "path": final,
            "wall": time.perf_counter() - t0,
            "launches": rank_cuda.LAUNCHES["rank_decode"],
            "pieces": _grab(r"Processing (\d+) pieces", " ".join(lines),
                            int)[0],
            "timing": lines[-1]}


def phase_tools_cuda_vs_cpu(data_dir: str) -> None:
    """pebwt2indel on phase 3's reads, two pieces, on CUDA and on the CPU."""
    fasta = _reads_fasta(os.path.join(data_dir, "smoke_g200000_c20.fa"),
                         200_000, 7, 20)
    runs = {dev: _pebwt2indel(fasta, 3, os.path.join(data_dir,
                                                     f"peb_small_{dev}"), dev)
            for dev in ("cuda", "cpu")}
    for dev, r in runs.items():
        log(f"[tools_cuda_vs_cpu] {dev}: {r['wall']:.3f} s, {r['pieces']} "
            f"pieces, {len(r['snp'])} bytes; {r['timing']}")
    if runs["cuda"]["snp"] != runs["cpu"]["snp"]:
        raise AssertionError("pebwt2indel: the CUDA variants.snp differs "
                             "from the CPU one")
    if not runs["cpu"]["snp"] or runs["cuda"]["pieces"] != 2:
        raise AssertionError("pebwt2indel: no events, or not two pieces")
    if runs["cuda"]["launches"] <= 0:
        raise AssertionError("rank_decode never launched by pebwt2indel")
    log(f"[tools_cuda_vs_cpu] variants.snp byte-identical; rank_decode "
        f"{runs['cuda']['launches']} launches on CUDA")


def _score_line(label: str, rep: dict) -> None:
    for kind in ("snp", "indel"):
        r = rep[kind]
        log(f"[{label}] {kind}: TP {r['TP']}, FP {r['FP']}, FN {r['FN']}, "
            f"sensitivity {r['sensitivity']}, precision {r['precision']}")
    log(f"[{label}] truth {rep['truth_snps']} SNPs, {rep['truth_indels']} "
        f"indels; placed {rep['placed']} ({rep['unique_variants']} unique, "
        f"{rep['dropped']} dropped) in {rep['place_seconds']} s; total "
        f"{rep['total_seconds']} s; device {json.dumps(rep['device'])}")


def _validate(results: dict, data_dir: str, snp: str, tag: str,
              min_cov: int = 5) -> dict:
    from ebwt2indel_torch.tools import validate_huge

    return validate_huge.run(
        GENOME_LEN, results["full_path"], snp,
        os.path.join(data_dir, f"validation_{tag}.json"), seed=SEED,
        device="cuda", min_cov=min_cov, log=lambda *a: None)


def phase_validate_116m(results: dict, data_dir: str) -> None:
    """The evaluation loop on phase 4's .snp, against the recipe's truth."""
    rep = _validate(results, data_dir, results["full_out"], "116M")
    _score_line("validate_116M", rep)
    results["validate_116M"] = rep
    for kind in ("snp", "indel"):
        if rep[kind]["sensitivity"] < VALIDATE_MIN_SENSITIVITY or \
                rep[kind]["precision"] < VALIDATE_MIN_PRECISION:
            raise AssertionError(
                f"{kind} sensitivity {rep[kind]['sensitivity']} or precision "
                f"{rep[kind]['precision']} under the floors "
                f"{VALIDATE_MIN_SENSITIVITY} / {VALIDATE_MIN_PRECISION}")


def phase_pebwt2indel_116m(results: dict, data_dir: str) -> None:
    """pebwt2indel on the full-size reads on CUDA, three pieces, scored as
    phase 14 scores the in-process run (filter m=5), and then both runs
    scored with the calls' own coverage floor (m=3, no filtering), since
    each piece holds a third of the 25x for which m=5 is meant. The JAX
    package's contract (sharded at least 0.6 x in-process) was measured on
    one piece; it is held here on the m=3 scores."""
    t0 = time.perf_counter()
    fasta = _reads_fasta(
        os.path.join(data_dir, f"reads_g{GENOME_LEN}_c{COVERAGE}"
                               f"_l{READ_LEN}.fa"),
        GENOME_LEN, SEED, COVERAGE)
    log(f"[pebwt2indel_116M] set-up: FASTA ready in "
        f"{time.perf_counter() - t0:.1f} s")
    r = _pebwt2indel(fasta, 4, os.path.join(data_dir, "peb_116M"), "cuda")
    log(f"[pebwt2indel_116M] {r['wall']:.3f} s wall, {r['pieces']} pieces, "
        f"rank_decode {r['launches']} launches; {r['timing']}")
    if r["pieces"] != 3 or r["launches"] <= 0:
        raise AssertionError("pebwt2indel_116M: not three pieces, or "
                             "rank_decode never launched")
    sens = {}
    for m in (5, 3):
        full = results["validate_116M"] if m == 5 else \
            _validate(results, data_dir, results["full_out"], "116M_m3", 3)
        rep = _validate(results, data_dir, r["path"], f"peb_116M_m{m}", m)
        _score_line(f"pebwt2indel_116M m={m}", rep)
        full, sharded = full["snp"]["sensitivity"], rep["snp"]["sensitivity"]
        sens[m] = full, sharded
        log(f"[pebwt2indel_116M] m={m} SNP sensitivity: in-process {full}, "
            f"3 pieces {sharded}, delta {full - sharded:+.4f}")
    full, sharded = sens[3]
    if sharded < 0.6 * full:
        raise AssertionError(f"sharded SNP sensitivity {sharded} under 0.6 "
                             f"x the in-process {full}")


class _Preempted(Exception):
    pass


def phase_resume_116m(results: dict, data_dir: str) -> None:
    """Mode 1 at full size killed in its node phase after the phase's second
    checkpoint, then run again from it."""
    import shutil

    import torch

    from ebwt2indel_torch.models import pipeline, traverse
    from ebwt2indel_torch.ops import rank_cuda
    from ebwt2indel_torch.utils.config import Config

    ckpt_dir = os.path.join(data_dir, "ckpt_116M")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    out = os.path.join(data_dir, "resume_116M.snp")
    saves: list[tuple] = []  # (file, bytes, seconds)
    wire = {"armed": False, "steps": 0}
    real_save = traverse._Checkpoint.save
    real_node = traverse._node_body

    def save(ckpt, *a):
        t = time.perf_counter()
        real_save(ckpt, *a)
        saves.append((os.path.basename(ckpt.path),
                      os.path.getsize(ckpt.path), time.perf_counter() - t))

    def node(*a, **k):
        if wire["armed"] and \
                sum(f == "phase_node_body.pt" for f, _, _ in saves) >= 2:
            raise _Preempted
        wire["steps"] += 1
        return real_node(*a, **k)

    def run(every):
        torch.cuda.synchronize()
        rank_cuda.reset_launches()
        t0 = time.perf_counter()
        st = pipeline.run_one_dataset(
            Config(input1=results["full_path"], output=out),
            log=lambda *a, **k: None, device="cuda", ckpt_dir=ckpt_dir,
            ckpt_every=every)
        torch.cuda.synchronize()
        return st, time.perf_counter() - t0

    traverse._Checkpoint.save, traverse._node_body = save, node
    try:
        run(0)  # counts the node chunks; saves nothing
        chunks = wire["steps"]
        every = max(1, chunks // 3)
        wire.update(armed=True, steps=0)
        t0 = time.perf_counter()
        try:
            run(every)
            raise AssertionError("the trip wire did not fire")
        except _Preempted:
            pass
        killed = time.perf_counter() - t0
        first = list(saves)
        if os.listdir(ckpt_dir) != ["phase_node_body.pt"]:
            raise AssertionError(f"after the kill: {os.listdir(ckpt_dir)}")
        wire.update(armed=False, steps=0)
        saves.clear()
        st, wall = run(every)
        resumed_steps = wire["steps"]
    finally:
        traverse._Checkpoint.save, traverse._node_body = real_save, real_node
    launches = rank_cuda.LAUNCHES["rank_decode"]
    for label, ss in (("killed run", first), ("resumed run", saves)):
        for name in sorted({f for f, _, _ in ss}):
            sizes = [b for f, b, _ in ss if f == name]
            secs = [t for f, _, t in ss if f == name]
            log(f"[resume_116M] {label}: {len(sizes)} saves of {name}, "
                f"{sizes[-1]} bytes each at most {max(sizes)}, seconds per "
                f"save {[round(t, 4) for t in secs]}")
    log(f"[resume_116M] {chunks} node chunks, a save every {every}; killed "
        f"after {killed:.3f} s; the resumed run took {wall:.3f} s, "
        f"{resumed_steps} node chunks, rank_decode {launches} launches; "
        f"phase seconds {st['seconds']}")
    if open(out, "rb").read() != open(results["full_out"], "rb").read():
        raise AssertionError("the resumed .snp differs from full_mode1's")
    for k in _COMPARED:
        if st[k] != results["full_stats"][k]:
            raise AssertionError(f"resumed {k} {st[k]} != full_mode1's "
                                 f"{results['full_stats'][k]}")
    if os.listdir(ckpt_dir):
        raise AssertionError(f"checkpoint left behind: "
                             f"{os.listdir(ckpt_dir)}")
    if resumed_steps != chunks - 2 * every or launches <= 0:
        raise AssertionError(f"the resumed run took {resumed_steps} node "
                             f"chunks, not {chunks} - 2 x {every}, or "
                             "launched no rank_decode")
    log(f"[resume_116M] .snp byte-identical to full_mode1's, stats equal "
        f"({', '.join(_COMPARED)}), checkpoint removed")


def _node_chunk(fm):
    """The boundaries (CHUNK, 6) of the first node chunk of an index: real
    suffix-tree nodes, in node-major order."""
    from ebwt2indel_torch.models import fm_index as fm_ops
    from ebwt2indel_torch.models import traverse

    frontier = fm.root()[None, :]
    while frontier.shape[0] < traverse.CHUNK:
        ext = fm_ops.extend_node(fm, frontier)
        frontier = traverse._char_major(
            ext, fm_ops.node_num_children(ext) >= 2)
    return frontier[: traverse.CHUNK, :6].contiguous()


def phase_mesh_rank_vs_plain(results: dict) -> None:
    """The 4-shard mesh's rank and select on the card against the plain
    version over the whole index, at the node chunk's shape, on uniform
    queries, on queries all held by shard 0, and at the shard edges."""
    import torch

    from ebwt2indel_torch.models import fm_index as fm_ops
    from ebwt2indel_torch.ops import rank, rank_cuda
    from ebwt2indel_torch.parallel import frontier, mesh, shard

    m = mesh.Mesh(4, device="cuda")
    sfm = shard.shard_fm_from_file(results["full_path"], m)
    fm = fm_ops.FMIndex.from_file(results["full_path"], device="cuda")
    n, L = fm.n, sfm.local_n
    rng = np.random.default_rng(5)
    coords = _node_chunk(fm)
    edges = [0, 127, 128, n - 1, n] + [k * L + d for k in range(1, 4)
                                       for d in (-1, 0, 1)]
    queries = {
        "node chunk": coords,
        "uniform": torch.from_numpy(rng.integers(0, n + 1, 1 << 20)).cuda(),
        "shard 0 only": torch.from_numpy(rng.integers(0, L, 1 << 20)).cuda(),
        "shard edges": torch.tensor(edges, device="cuda"),
    }
    torch.cuda.synchronize()
    rank_cuda.reset_launches()
    err = 0
    for name, q in queries.items():
        got = shard.sharded_parallel_rank(sfm, q)
        e = int((got - rank.parallel_rank_plain(fm.blocks, q)).abs().max())
        log(f"[mesh_rank] {name}: {q.numel()} queries, max_abs_err {e}")
        err = max(err, e)
    b = coords >> 7
    for s in m.local:
        own = coords[(b[:, 0] // sfm.rows == s) & (b[:, 5] - b[:, 0] <= 1)]
        e = 0
        if own.numel():
            got = frontier._narrow_rank(sfm, s, own)
            e = int((got - rank.parallel_rank_plain(fm.blocks, own)).abs()
                    .max())
        log(f"[mesh_rank] shard {s}: {own.shape[0]} narrow nodes of the "
            f"chunk on its rows and halo, max_abs_err {e}")
        err = max(err, e)
    F = fm.F.tolist() + [n]
    totals = torch.tensor([F[k + 1] - F[k] for k in range(4)], device="cuda")
    c = torch.from_numpy(rng.integers(0, 4, 1 << 20)).cuda()
    r = (torch.rand(c.shape, device="cuda", dtype=torch.float64)
         * totals[c]).long()
    got = shard.sharded_select(sfm, r, c)
    e = int((got - rank.select(fm.blocks, fm.block_counts, r, c)).abs()
            .max())
    log(f"[mesh_rank] select: {r.numel()} queries, max_abs_err {e}")
    err = max(err, e)
    launches = rank_cuda.LAUNCHES["rank_decode"]
    q = queries["node chunk"]
    ms = time_ms(lambda: shard.sharded_parallel_rank(sfm, q), 20)
    one = time_ms(lambda: rank.parallel_rank(fm.blocks, q), 20)
    log(f"[mesh_rank] node chunk ({q.numel()} queries): 4-shard rank "
        f"{ms:.4f} ms (4 masked rank_decode launches and the sum), one "
        f"rank_decode launch over the whole index {one:.4f} ms")
    log(f"[mesh_rank] rank_decode launches in the comparisons: {launches}")
    if err != 0:
        raise AssertionError(f"the mesh's rank or select differs from the "
                             f"plain version: max_abs_err {err}")
    if launches <= 0:
        raise AssertionError("the mesh's rank never launched rank_decode")


def phase_mesh(label: str, args: list, want_out: str, want_stats: dict,
               n: int, data_dir: str, log_dir: str, mode: int = 1) -> None:
    """A mode with EBWT_MESH=4 through ``cli.main`` on CUDA: the .snp and
    the stats must equal the single-device run's."""
    out = os.path.join(data_dir, f"{label}.snp")
    os.environ["EBWT_MESH"] = "4"
    try:
        r = _cli_run(args + ["-o", out],
                     os.path.join(log_dir, f"chip_smoke_cli_{label}.log"))
    finally:
        del os.environ["EBWT_MESH"]
    got = open(out, "rb").read()
    want = open(want_out, "rb").read()
    text = r["text"]
    st = _mode1_log(text) if mode == 1 else _pair_log(text, got, mode)
    steps = _grab(r"\((\d+) and (\d+) mesh steps", text, int)
    (shards,) = _grab(r"\((\d+)-device mesh\)", text, int)
    log(f"[{label}] mode {mode} on {st['n']} positions, {shards} shards on "
        f"one card: {r['wall']:.4f} s wall ({n / r['wall'] / 1e6:.3f} "
        "Mpos/s)")
    log(f"[{label}] phase seconds: {st['seconds']}; mesh steps (leaf, node) "
        f"{steps}")
    if mode == 2:
        (routed,) = _grab(r"(\d+) routed bytes per step", text, int)
        log(f"[{label}] routed bytes per step (all_to_all rows sent to "
            f"another shard): {routed}")
    log(f"[{label}] torch.cuda.max_memory_allocated {r['peak']} bytes "
        f"({r['peak'] / n:.3f} B/position)")
    log(f"[{label}] kernels {json.dumps(r['launches'])}; queries "
        f"{json.dumps(r['queries'])}")
    log(f"[{label}] .snp sha256 {hashlib.sha256(got).hexdigest()}; the "
        f"single-device run's {hashlib.sha256(want).hexdigest()}")
    if shards != 4 or st["n"] != n:
        raise AssertionError(f"{label}: not a 4-shard run over {n} positions")
    if got != want:
        raise AssertionError(f"{label}: the mesh's .snp differs from the "
                             "single-device .snp")
    keys = [k for k in want_stats if k not in ("seconds", "n")]
    for k in keys:
        if st[k] != want_stats[k]:
            raise AssertionError(f"{label} {k}: mesh {st[k]} != "
                                 f"single-device {want_stats[k]}")
    if r["launches"]["rank_decode"] <= 0 or r["launches"]["next_set"] <= 0:
        raise AssertionError(f"{label}: a kernel never launched: "
                             f"{r['launches']}")
    log(f"[{label}] .snp byte-identical to the single-device run's, stats "
        f"equal: {', '.join(keys)}")


def phase_mesh_resume(results: dict, mode: int, data_dir: str,
                      log_dir: str) -> None:
    """Mode 1 or 2 with EBWT_MESH=4 through ``cli.main``: a run that counts
    the node phase's mesh steps, a run with EBWT_CKPT_DIR killed in that
    phase after its second save, and the resumed run."""
    from ebwt2indel_torch.parallel import frontier

    label = f"mesh4_resume_mode{mode}_116M"
    step_name, tag = (("_node_step", "m1node") if mode == 1
                      else ("_node_pair_step", "pnode"))
    if mode == 1:
        args, want_out = ["-1", results["full_path"]], results["full_out"]
        want = results["full_stats"]
    else:
        args = _pair_args(results["pair_paths"], mode)
        want_out, want = (results[f"mode{mode}"][k]
                          for k in ("full_out", "stats"))
    ckpt_dir = os.path.join(data_dir, f"ckpt_{label}")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    out = os.path.join(data_dir, f"{label}.snp")
    saves: list[tuple] = []  # (tag, bytes, seconds)
    wire = {"armed": False, "steps": 0}
    real_save = frontier._MeshCheckpoint.save
    real_step = getattr(frontier, step_name)

    def save(ckpt, *a):
        t = time.perf_counter()
        real_save(ckpt, *a)
        saves.append((ckpt.tag, os.path.getsize(ckpt.path),
                      time.perf_counter() - t))

    def step(*a, **k):
        if wire["armed"] and sum(t == tag for t, _, _ in saves) >= 2:
            raise _Preempted
        wire["steps"] += 1
        return real_step(*a, **k)

    def run(every=None):
        env = {"EBWT_MESH": "4"}
        if every is not None:
            env.update(EBWT_CKPT_DIR=ckpt_dir, EBWT_CKPT_EVERY=str(every))
        os.environ.update(env)
        try:
            r = _cli_run(args + ["-o", out],
                         os.path.join(log_dir, f"chip_smoke_cli_{label}.log"))
        finally:
            for k in env:
                del os.environ[k]
        text = r["text"]
        r["stats"] = (_mode1_log(text) if mode == 1
                      else _pair_log(text, open(out, "rb").read(), mode))
        r["stats"]["mesh_steps"] = _grab(r"\((\d+) and (\d+) mesh steps",
                                         text, int)
        if mode == 2:
            (r["stats"]["routed"],) = _grab(r"(\d+) routed bytes per step",
                                            text, int)
        return r

    frontier._MeshCheckpoint.save = save
    setattr(frontier, step_name, step)
    try:
        counted = run()
        total = wire["steps"]
        every = max(1, total // 3)
        wire.update(armed=True, steps=0)
        t0 = time.perf_counter()
        try:
            run(every)
            raise AssertionError("the trip wire did not fire")
        except _Preempted:
            pass
        killed = time.perf_counter() - t0
        files = sorted(os.listdir(ckpt_dir))
        first = list(saves)
        wire.update(armed=False, steps=0)
        saves.clear()
        resumed = run(every)
        resumed_steps = wire["steps"]
    finally:
        frontier._MeshCheckpoint.save = real_save
        setattr(frontier, step_name, real_step)
    for what, ss in (("killed run", first), ("resumed run", saves)):
        for t in sorted({t for t, _, _ in ss}):
            log(f"[{label}] {what}: {sum(x == t for x, _, _ in ss)} saves of "
                f"frontier_{t}, bytes {[b for x, b, _ in ss if x == t]}, "
                f"seconds {[round(s_, 4) for x, _, s_ in ss if x == t]}")
    st = resumed["stats"]
    log(f"[{label}] uninterrupted run {counted['wall']:.4f} s, {total} "
        f"node mesh steps, a save every {every}; killed after "
        f"{killed:.4f} s with {files}; resumed run (the time to recover) "
        f"{resumed['wall']:.4f} s, {resumed_steps} node mesh steps, "
        f"rank_decode {resumed['launches']['rank_decode']} launches and "
        f"{resumed['queries']['rank_decode']} queries; phase seconds "
        f"{st['seconds']}; mesh steps {st['mesh_steps']}"
        + (f"; routed bytes per step {st['routed']}" if mode == 2 else ""))
    got = open(out, "rb").read()
    log(f"[{label}] .snp sha256 {hashlib.sha256(got).hexdigest()}")
    if got != open(want_out, "rb").read():
        raise AssertionError(f"{label}: the resumed .snp differs from the "
                             "single-device run's")
    keys = [k for k in want if k not in ("seconds", "n")]
    for k in keys:
        if st[k] != want[k]:
            raise AssertionError(f"{label} {k}: resumed {st[k]} != "
                                 f"single-device {want[k]}")
    for k in ("mesh_steps",) + (("routed",) if mode == 2 else ()):
        if st[k] != counted["stats"][k]:
            raise AssertionError(f"{label} {k}: resumed {st[k]} != "
                                 f"uninterrupted {counted['stats'][k]}")
    if files != sorted([f"frontier_{tag}.p0.pt", f"frontier_{tag}.p0.prev.pt"]):
        raise AssertionError(f"{label}: after the kill {files}")
    if resumed_steps != total - 2 * every:
        raise AssertionError(f"{label}: the resumed run took {resumed_steps} "
                             f"node mesh steps, not {total} - 2 x {every}")
    if resumed["launches"]["rank_decode"] <= 0:
        raise AssertionError(f"{label}: rank_decode never launched")
    if os.listdir(ckpt_dir):
        raise AssertionError(f"{label}: checkpoint left behind: "
                             f"{os.listdir(ckpt_dir)}")
    log(f"[{label}] .snp byte-identical to the single-device run's, stats "
        f"equal ({', '.join(keys)}, mesh steps"
        + (", routed bytes per step" if mode == 2 else "")
        + "), checkpoint directory empty")


def _no_pack(*a, **k):
    raise AssertionError("packed although its sidecar was there")


@contextlib.contextmanager
def _index_cache(writes: list):
    """EBWT_INDEX_CACHE=1, with each sidecar write's (bytes, seconds)
    appended to ``writes``."""
    from ebwt2indel_torch.ops import packing

    real = packing.save_packed

    def save(pb, path):
        t = time.perf_counter()
        real(pb, path)
        writes.append((os.path.getsize(path), time.perf_counter() - t))

    packing.save_packed = save
    os.environ["EBWT_INDEX_CACHE"] = "1"
    try:
        yield packing
    finally:
        packing.save_packed = real
        del os.environ["EBWT_INDEX_CACHE"]


def phase_index_cache_116m(results: dict, data_dir: str) -> None:
    """Modes 1 and 2 with EBWT_INDEX_CACHE=1, cold then warm: each .snp
    equals the uncached run's."""
    for mode in (1, 2):
        r = results if mode == 1 else results[f"mode{mode}"]
        inputs = ([r["full_path"]] if mode == 1 else
                  [r["full_path"][k] for k in ("a.ebwt", "b.ebwt")])
        for path in inputs:
            if os.path.exists(path + ".idx.npz"):
                os.remove(path + ".idx.npz")
        want = open(r["full_out"], "rb").read()
        writes: list = []
        runs = {}
        with _index_cache(writes) as packing:
            for temp in ("cold", "warm"):
                out = os.path.join(data_dir, f"index_cache_mode{mode}_"
                                             f"{temp}.snp")
                real_pack = packing.pack_file
                if temp == "warm":
                    packing.pack_file = _no_pack
                try:
                    runs[temp] = _measured_run(mode, r["full_path"], out,
                                               None)
                finally:
                    packing.pack_file = real_pack
                if temp == "cold":
                    written = list(writes)
        for temp, x in runs.items():
            log(f"[index_cache_116M] mode {mode} {temp}: index "
                f"{x['stats']['seconds']['index']:.4f} s, wall "
                f"{x['wall']:.4f} s, rank_decode {x['launches']} launches")
            if x["snp"] != want:
                raise AssertionError(f"mode {mode} {temp}: the .snp differs "
                                     "from the uncached run's")
            if x["launches"] <= 0:
                raise AssertionError(f"mode {mode} {temp}: rank_decode "
                                     "never launched")
        log(f"[index_cache_116M] mode {mode}: sidecars (bytes, seconds of "
            f"the write) {[(b, round(t, 4)) for b, t in written]}; the "
            f"uncached cli.main run's index "
            f"{r['full_stats' if mode == 1 else 'stats']['seconds']['index']}"
            f" s (log, 0.01 s)")
        if len(written) != len(inputs) or len(writes) != len(inputs):
            raise AssertionError(f"mode {mode}: {len(written)} sidecars "
                                 f"written cold, {len(writes)} in all")
        for path in inputs:
            os.remove(path + ".idx.npz")
        log(f"[index_cache_116M] mode {mode}: cold and warm .snp "
            "byte-identical to the uncached run's")


def phase_index_cache_1g(results: dict, data_dir: str, log_dir: str) -> None:
    """Phase 12's input packed into its sidecar, then mode 1 through
    ``cli.main`` with EBWT_INDEX_CACHE=1 reading it."""
    h = results["huge"]
    path = h["path"]
    if os.path.exists(path + ".idx.npz"):
        os.remove(path + ".idx.npz")
    out = os.path.join(data_dir, "huge_1g_index_cache.snp")
    writes: list = []
    with _index_cache(writes) as packing:
        t0 = time.perf_counter()
        packing.pack_file_cached(path)
        cold = time.perf_counter() - t0
        real_pack = packing.pack_file
        packing.pack_file = _no_pack
        try:
            r = _cli_run(["-1", path, "-o", out],
                         os.path.join(log_dir, "chip_smoke_cli_1g_cache.log"))
        finally:
            packing.pack_file = real_pack
    st = _mode1_log(r["text"])
    got = open(out, "rb").read()
    log(f"[index_cache_1G] {h['n']} positions: pack and sidecar write "
        f"{cold:.3f} s, of which the write {writes[0][1]:.3f} s for "
        f"{writes[0][0]} bytes; the cached run: index "
        f"{st['seconds']['index']} s (log, 0.01 s; uncached "
        f"{h['stats']['seconds']['index']} s), wall {r['wall']:.4f} s, "
        f"phases {st['seconds']}, peak {r['peak']} bytes, rank_decode "
        f"{r['launches']['rank_decode']} launches; .snp sha256 "
        f"{hashlib.sha256(got).hexdigest()}")
    os.remove(path + ".idx.npz")
    if got != open(h["out"], "rb").read():
        raise AssertionError("the cached 1.05G .snp differs from "
                             "scale_mode1_1G's")
    for k in _COMPARED:
        if st[k] != h["stats"][k]:
            raise AssertionError(f"cached 1.05G {k}: {st[k]} != "
                                 f"{h['stats'][k]}")
    if r["launches"]["rank_decode"] <= 0:
        raise AssertionError("the cached 1.05G run launched no rank_decode")
    log("[index_cache_1G] .snp byte-identical to scale_mode1_1G's, stats "
        f"equal: {', '.join(_COMPARED)}")


def write_kfold(src: str, dst: str, k: int, chunk: int = 1 << 24) -> int:
    """Each byte of ``src`` repeated ``k`` times in place, written chunk by
    chunk (host memory stays at ``k * chunk`` bytes); returns the bytes
    written. Repeating each read of a collection k times in place gives
    this eBWT (and document array): the terminators order by read index, so
    the k copies of a suffix tie only among themselves and keep their
    order."""
    data = np.memmap(src, dtype=np.uint8, mode="r")
    with open(dst + ".tmp", "wb") as f:
        for lo in range(0, len(data), chunk):
            np.repeat(data[lo:lo + chunk], k).tofile(f)
    os.replace(dst + ".tmp", dst)
    return os.path.getsize(dst)


# each k-fold file's name after ``kfold<k>``, by its source's key
_KFOLD_FILES = {"ebwt": ".ebwt", "a.ebwt": "_a.ebwt", "b.ebwt": "_b.ebwt",
                "merged.ebwt": "_merged.ebwt", "merged.da": "_merged.da"}


def phase_past2g31_data(results: dict, data_dir: str) -> None:
    """The k-fold files of phase 4's eBWT and phase 9's pair data: k = 19
    (2,206,844,243 positions, past 2^31) and k = 2 (below it)."""
    src = dict(results["pair_paths"], ebwt=results["full_path"])
    kfold = {}
    for k in (KFOLD, 2):
        paths = {}
        for key, name in _KFOLD_FILES.items():
            paths[key] = os.path.join(data_dir, f"kfold{k}{name}")
            t0 = time.perf_counter()
            size = write_kfold(src[key], paths[key], k)
            log(f"[past2g31_data] {paths[key]}: {size} bytes in "
                f"{time.perf_counter() - t0:.2f} s")
        kfold[k] = paths
        n = {key: os.path.getsize(p) for key, p in paths.items()}
        want = k * results["n"]
        if not (n["ebwt"] == n["merged.ebwt"] == n["merged.da"] == want
                == n["a.ebwt"] + n["b.ebwt"]):
            raise AssertionError(f"{k}-fold sizes {n}, not {want}")
    results["kfold"] = kfold
    if results["n"] * KFOLD != KFOLD_N:
        raise AssertionError(f"{KFOLD} x {results['n']} is not {KFOLD_N}")
    log(f"[past2g31_data] n = {KFOLD_N} > 2^31 = {2**31} in modes 1 and 3, "
        f"n1 + n2 = {KFOLD_N} in mode 2; the 2-fold input {2 * results['n']}")


def _counts_from_bytes(path: str, positions: list,
                       chunk: int = 1 << 22) -> dict:
    """A, C, G, T counts of the file's bytes before each position, by
    ``np.count_nonzero`` over the bytes, chunk by chunk (no code shared
    with the packer or the rank)."""
    data = np.memmap(path, dtype=np.uint8, mode="r")

    def count(block):
        return np.array([np.count_nonzero(block == c) for c in b"ACGT"])

    run = np.zeros(4, np.int64)
    out, todo = {}, sorted(set(positions))
    for lo in range(0, len(data) + 1, chunk):
        block = data[lo:lo + chunk]
        while todo and todo[0] <= lo + len(block):
            p = todo.pop(0)
            out[p] = (run + count(block[:p - lo])).tolist()
        run += count(block)
    if todo:
        raise AssertionError(f"positions past the file: {todo}")
    return out


def phase_past2g31_rank(results: dict) -> None:
    """``rank_decode`` on the 19-fold index at positions past 2^31: against
    its plain version on the card, and against counts taken straight from
    the file's bytes."""
    import torch

    from ebwt2indel_torch.models import fm_index as fm_ops
    from ebwt2indel_torch.ops import rank, rank_cuda

    path = results["kfold"][KFOLD]["ebwt"]
    t0 = time.perf_counter()
    fm = fm_ops.FMIndex.from_file(path, device="cuda")
    n = fm.n
    log(f"[past2g31_rank] index of {n} positions ({fm.blocks.shape[0]} block "
        f"rows) packed and uploaded in {time.perf_counter() - t0:.2f} s")
    big = 2**31
    edges = [0, 127, 128, big - 129, big - 1, big, big + 1, big + 128,
             n - 1, n]
    rng = np.random.default_rng(31)
    rand = rng.integers(big, n + 1, size=1 << 20)
    q = torch.from_numpy(np.concatenate([edges, rand])).cuda()
    rank_cuda.reset_launches()
    got = rank.parallel_rank(fm.blocks, q)
    torch.cuda.synchronize()
    launches = rank_cuda.LAUNCHES["rank_decode"]
    want = rank.parallel_rank_plain(fm.blocks, q)
    err = int((got - want).abs().max())
    log(f"[past2g31_rank] {q.numel()} queries (the edges {edges} and 2^20 "
        f"in [2^31, n]), rows up to {int(q.max()) >> 7}: rank_decode "
        f"{launches} launch, max_abs_err {err} against the plain version")
    picks = edges + rand[:10].tolist()
    t0 = time.perf_counter()
    counts = _counts_from_bytes(path, picks)
    bad = [p for k, p in enumerate(picks) if got[k].tolist() != counts[p]]
    log(f"[past2g31_rank] {len(picks)} positions against the A/C/G/T counts "
        f"of the file's bytes (numpy, {time.perf_counter() - t0:.2f} s): "
        f"{len(picks) - len(bad)} equal; at n: {counts[n]}")
    del fm, got, want, q
    if err != 0 or bad or launches != 1:
        raise AssertionError(f"past2g31_rank: max_abs_err {err}, unequal at "
                             f"{bad}, {launches} launches")


@contextlib.contextmanager
def _traversal_stats(got: list):
    """Each single-device traversal's stats, with its route, appended to
    ``got`` (the CLI's log has no ``max_pending`` in modes 3 and 2)."""
    from ebwt2indel_torch.models import traverse

    names = ("navigate_one_bwt", "navigate_two_bwts")
    real = {k: getattr(traverse, k) for k in names}

    def wrap(fn):
        def run(*a, **k):
            res = fn(*a, **k)
            got.append(dict(res.stats, packed=res.packed))
            return res
        return run

    for k in names:
        setattr(traverse, k, wrap(real[k]))
    try:
        yield got
    finally:
        for k in names:
            setattr(traverse, k, real[k])


def _kfold_args(paths: dict, mode: int) -> list:
    if mode == 1:
        return ["-1", paths["ebwt"]]
    return _pair_args(paths, mode)


_KFOLD_SAME = ("leaves", "nodes", "n_min", "max_pending")


def phase_past2g31(results: dict, mode: int, data_dir: str,
                   log_dir: str) -> None:
    """A mode through ``cli.main`` on the 19-fold input (past 2^31) on its
    default route, then on the 2-fold input (dense): the suffix tree's
    counts must be the same, and each run's LCP values (mode 2: DA values
    too) n."""
    import gc

    import torch

    label = f"past2g31_mode{mode}"
    runs = {}
    for k in (KFOLD, 2):
        paths = results["kfold"][k]
        out = os.path.join(data_dir, f"{label}_k{k}.snp")
        gc.collect()
        torch.cuda.empty_cache()
        with _traversal_stats([]) as trav:
            r = _cli_run(_kfold_args(paths, mode) + ["-o", out],
                         os.path.join(log_dir,
                                      f"chip_smoke_cli_{label}_k{k}.log"))
        snp = open(out, "rb").read()
        st = (_mode1_log(r["text"]) if mode == 1
              else _pair_log(r["text"], snp, mode))
        n = k * results["n"]
        r.update(stats=st, trav=trav[0], out=out, n=n,
                 sha=hashlib.sha256(snp).hexdigest(), bytes=len(snp))
        runs[k] = r
        log(f"[{label}] k={k}: {n} positions, {r['wall']:.4f} s wall "
            f"({n / r['wall'] / 1e6:.3f} Mpos/s), "
            f"{'packed' if r['trav']['packed'] else 'dense'} route; phase "
            f"seconds {st['seconds']}")
        log(f"[{label}] k={k}: peak {r['peak']} bytes ({r['peak'] / n:.3f} "
            f"B/position); rank_decode {r['launches']['rank_decode']} "
            f"launches, {r['queries']['rank_decode']} queries; next_set "
            f"{r['launches']['next_set']} launches")
        log(f"[{label}] k={k}: stats " + ", ".join(
            f"{x} {v}" for x, v in st.items() if x not in ("n", "seconds"))
            + f", max_pending {r['trav']['max_pending']}")
        log(f"[{label}] k={k}: .snp {r['bytes']} bytes, sha256 {r['sha']}")
        if st["n"] != n or r["trav"]["lcp_values"] != n or \
                (mode == 2 and r["trav"]["da_values"] != n):
            raise AssertionError(f"{label} k={k}: n {st['n']}, lcp_values "
                                 f"{r['trav']['lcp_values']}, not {n}")
        if r["launches"]["rank_decode"] <= 0 or r["bytes"] == 0:
            raise AssertionError(f"{label} k={k}: no rank_decode launch or "
                                 "no events")
    big, two = runs[KFOLD], runs[2]
    if not big["trav"]["packed"] or two["trav"]["packed"]:
        raise AssertionError(f"{label}: routes {big['trav']['packed']} / "
                             f"{two['trav']['packed']}, not packed / dense")
    for x in _KFOLD_SAME:
        if big["trav"][x] != two["trav"][x]:
            raise AssertionError(f"{label} {x}: 19-fold {big['trav'][x]} != "
                                 f"2-fold {two['trav'][x]}")
    per_pos = big["peak"] / big["n"]
    if mode == 1 and per_pos > PACKED_MAX_BYTES_PER_POS:
        raise AssertionError(f"{label}: the packed route peaked at "
                             f"{per_pos:.3f} bytes per position, over "
                             f"{PACKED_MAX_BYTES_PER_POS}")
    results[label] = big
    log(f"[{label}] {', '.join(_KFOLD_SAME)} equal to the 2-fold run's; "
        f"lcp_values = n" + (", da_values = n" if mode == 2 else ""))


def phase_mesh_past2g31(results: dict, mode: int, data_dir: str,
                        log_dir: str) -> None:
    """``phase_mesh`` on the 19-fold input: the .snp and stats of the
    4-shard mesh must equal the single device's ``past2g31`` run's."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    r = results[f"past2g31_mode{mode}"]
    phase_mesh(f"mesh4_past2g31_mode{mode}",
               _kfold_args(results["kfold"][KFOLD], mode), r["out"],
               r["stats"], r["n"], data_dir, log_dir, mode)


def run_past2g31(phase, results: dict, data_dir: str, log_dir: str) -> None:
    """Phases 24-27 through ``phase``; the k-fold files (about 10 GB) are
    deleted when the last of them ends, whether it passed or not."""
    try:
        phase("past2g31_data", phase_past2g31_data, results, data_dir)
        if "kfold" not in results:
            return
        phase("past2g31_rank", phase_past2g31_rank, results)
        for mode in (1, 3, 2):
            phase(f"past2g31_mode{mode}", phase_past2g31, results, mode,
                  data_dir, log_dir)
        for mode in (1, 3, 2):
            if f"past2g31_mode{mode}" in results:
                phase(f"mesh4_past2g31_mode{mode}", phase_mesh_past2g31,
                      results, mode, data_dir, log_dir)
    finally:
        results.pop("kfold", None)
        for name in os.listdir(data_dir):
            if name.startswith("kfold"):
                os.remove(os.path.join(data_dir, name))


def phase_mesh_nccl(results: dict, data_dir: str, log_dir: str) -> None:
    """Modes 1, 3 and 2 at full size as two processes of two shards each on
    two cards, joined over NCCL through EBWT_COORD."""
    import socket

    code = ("import sys; from ebwt2indel_torch import cli; "
            "raise SystemExit(cli.main(sys.argv[1:], device='cuda'))")
    here = os.path.dirname(os.path.abspath(__file__))
    paths = results["pair_paths"]
    for mode, args, want in (
            (1, ["-1", results["full_path"]], results["full_out"]),
            (3, _pair_args(paths, 3), results["mode3"]["full_out"]),
            (2, _pair_args(paths, 2), results["mode2"]["full_out"])):
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        out = os.path.join(data_dir, f"mesh_nccl_2proc_mode{mode}.snp")
        procs, logs, rcs = [], [], None
        t0 = time.perf_counter()
        try:
            for k in range(2):
                logs.append(open(os.path.join(
                    log_dir, f"mesh_nccl_mode{mode}_{k}.log"), "w"))
                env = dict(os.environ, EBWT_MESH="4", EBWT_NPROCS="2",
                           EBWT_PROCID=str(k), EBWT_COORD=f"localhost:{port}",
                           PYTHONPATH=here)
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", code, *args, "-o", out], env=env,
                    stdout=logs[-1], stderr=subprocess.STDOUT))
            rcs = [p.wait(timeout=600) for p in procs]
        finally:
            for p in procs:
                p.kill()
                p.wait()
            for f in logs:
                f.close()
        log(f"[mesh_nccl_2proc] mode {mode}: exit codes {rcs} in "
            f"{time.perf_counter() - t0:.3f} s")
        want = open(want, "rb").read()
        if rcs != [0, 0] or open(out, "rb").read() != want or \
                open(out + ".proc1", "rb").read() != want:
            raise AssertionError(f"mode {mode}: the two-process NCCL mesh "
                                 "failed or wrote another .snp")
        log(f"[mesh_nccl_2proc] mode {mode}: both processes' .snp "
            "byte-identical to the single-device run's")


def phase_kernel_at_main_shape(results: dict) -> dict:
    """Time the kernel on the first node chunk of the full-size index: the
    6 boundaries of 256k real suffix-tree nodes, in node-major order."""
    import torch

    from ebwt2indel_torch.models import fm_index as fm_ops
    from ebwt2indel_torch.models import traverse
    from ebwt2indel_torch.ops import rank

    fm = fm_ops.FMIndex.from_file(results["full_path"], device="cuda")
    coords = _node_chunk(fm)
    B = coords.numel()
    got = rank.parallel_rank(fm.blocks, coords)
    torch.cuda.synchronize()
    want = rank.parallel_rank_plain(fm.blocks, coords)
    if not torch.equal(got, want):
        raise AssertionError("rank kernel != plain on the node chunk")
    ms = time_ms(lambda: rank.parallel_rank(fm.blocks, coords), 50)
    plain_ms = time_ms(lambda: rank.parallel_rank_plain(fm.blocks, coords), 5)
    rows = int(torch.unique(coords >> 7).numel())
    # bytes the function must move: each distinct row once, each position
    # read once, each int64 (4,) count written once
    n_bytes = rows * 64 + B * 8 + B * 32
    # per query: 4 masks, 4 x (3 ands + 1 not + 4 popcounts), 4 adds, 4
    # combines — about 50 32-bit integer operations
    n_ops = B * 50
    bound_s = max(n_bytes / HBM_BYTES_PER_S, n_ops / INT32_OPS_PER_S)
    log(f"[kernel] node chunk of the full index: B={B} queries over {rows} "
        f"distinct rows: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bound_s * 1e3:.4f} ms ({n_bytes} bytes), equal to plain")
    return {
        "name": "rank_decode", "route": "cuda",
        "source": "ebwt2indel_torch/csrc/rank_decode.cu",
        "replaces": "ebwt2indel_tpu/ops/rank_pallas.py:52",
        "launches": results["launches"]["rank_decode"],
        "max_abs_err": int((got - want).abs().max()),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_s * 1e3,
        "bound_by": "bytes" if n_bytes / HBM_BYTES_PER_S
        >= n_ops / INT32_OPS_PER_S else "operations",
        "library_ms": None,
    }


def phase_next_set_at_main_shape(results: dict) -> dict:
    """Time the next-set kernel on the benchmark's 116.15 M positions at
    its thr_R density, against its plain version and ``torch.cummin``;
    its launches are those of the full-size mode-1 run."""
    import torch

    from ebwt2indel_torch.ops import scan

    n, density = 116_150_000, 0.64
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    flags = (torch.rand(n, generator=gen, device="cuda") <
             density).to(torch.uint8)
    got = scan.next_set(flags)
    want = scan.next_set_plain(flags)
    err = int((got - want).abs().max())
    del got, want
    if err != 0:
        raise AssertionError(f"next_set kernel != plain at 116.15M: "
                             f"max_abs_err {err}")
    ms = time_ms(lambda: scan.next_set(flags), 50)
    plain_ms = time_ms(lambda: scan.next_set_plain(flags), 3)
    idx = torch.where(flags != 0, torch.arange(n, device="cuda"), n)
    library_ms = time_ms(lambda: torch.cummin(idx, dim=0), 3)
    del idx
    n_bytes = 9 * n  # each flag read once, each int64 entry written once
    bound_s = n_bytes / HBM_BYTES_PER_S
    log(f"[kernel] next_set at n={n}, density {density}: kernel {ms:.4f} "
        f"ms, plain {plain_ms:.4f} ms, torch.cummin {library_ms:.4f} ms, "
        f"bound {bound_s * 1e3:.4f} ms ({n_bytes} bytes), equal to plain")
    return {
        "name": "next_set", "route": "cuda",
        "source": "ebwt2indel_torch/csrc/next_set.cu",
        "replaces": None, "launches": results["launches"]["next_set"],
        "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_s * 1e3,
        "bound_by": "bytes", "library_ms": library_ms,
    }


def _emission_inputs(path: str, out: str) -> tuple:
    """Mode 1 on CUDA over ``path``: its emission's config and device
    tensors, kept from the call of ``emit_vec.emit_single``."""
    from ebwt2indel_torch.models import emit_vec

    kept = []
    entry = emit_vec.emit_single

    def keep(out_f, cfg, *ts):
        kept.append((cfg, [t.clone() for t in ts]))
        return entry(out_f, cfg, *ts)

    emit_vec.emit_single = keep
    try:
        run_mode1(path, out, "cuda")
    finally:
        emit_vec.emit_single = entry
    return kept[0]


def _emission_vs_plain(label: str, cfg, ts: list) -> dict:
    """The emission on the card and its plain version on the CPU over the
    same tensors: the same text and counts, and each one's wall time."""
    import torch

    from ebwt2indel_torch.models import emit_vec

    walls = {}
    for dev in ("cuda", "cpu"):
        tensors = [t.to(dev) for t in ts]
        torch.cuda.synchronize()
        buf = io.StringIO()
        t0 = time.perf_counter()
        got = emit_vec.emit_single(buf, cfg, *tensors)
        walls[dev] = (time.perf_counter() - t0, buf.getvalue(), got)
    (k_s, k_text, k_got), (p_s, p_text, p_got) = walls["cuda"], walls["cpu"]
    if k_text != p_text or k_got != p_got:
        raise AssertionError(f"emission kernel != plain at {label}: "
                             f"{len(k_text)} / {len(p_text)} bytes, "
                             f"{k_got} / {p_got}")
    log(f"[emit] {label}: {ts[0].shape[0]} passing clusters, "
        f"{k_got['events']} records, {len(k_text)} bytes, equal to plain; "
        f"entry wall kernel {k_s * 1e3:.3f} ms, plain {p_s * 1e3:.3f} ms; "
        f"counts {json.dumps(k_got['emit_counts'])}")
    return {"text_bytes": len(k_text), "plain_s": p_s}


def phase_emit_single(results: dict, data_dir: str) -> dict:
    """Mode 1's emission kernel against its plain version over the
    emission's inputs of the full-size run and of the hivar cell's recipe
    (``portbench/configs/ecoli25x-hivar-single.json``), and timed at the
    latter's shapes: its device time by CUDA events (the plan, the scan,
    the counts' copy and the writer), its bound, and the plain version's
    wall; its launches are those of phase 4's run."""
    import torch

    from ebwt2indel_torch.models import emit_vec
    from ebwt2indel_torch.ops import emit_cuda
    from portbench import gen

    cfg, ts = _emission_inputs(results["full_path"],
                               os.path.join(data_dir, "emit_116M.snp"))
    _emission_vs_plain("116M", cfg, ts)
    hivar_dir = os.path.join(data_dir, "hivar")
    path = os.path.join(hivar_dir, "reads.ebwt")
    if not os.path.isfile(path):
        with open(HIVAR_CONFIG) as f:
            recipe = json.load(f)
        os.makedirs(hivar_dir, exist_ok=True)
        r1, r2 = gen.make_reads(recipe, HIVAR_SEED, "cuda")
        gen.write_inputs({"reads"}, r1, r2, hivar_dir)
        del r1, r2
    cfg, ts = _emission_inputs(path, os.path.join(hivar_dir, "reads.snp"))
    r = _emission_vs_plain(f"hivar recipe ({os.path.getsize(path)} "
                           "positions)", cfg, ts)
    ms = time_ms(lambda: emit_cuda.emit_single(cfg, *ts), 20)

    def entry():
        emit_vec.emit_single(io.StringIO(), cfg, *ts)

    entry_ms = time_ms(entry, 20)
    B, L, R = ts[0].shape[0], ts[4].shape[-1], ts[5].shape[-1]
    # each input byte read once (found, freq, full, support, contexts,
    # right contexts, lengths) and the text written once
    n_bytes = B * (1 + 4 + 4 + 32 + 4 * L + R + 8) + r["text_bytes"]
    bound_s = n_bytes / HBM_BYTES_PER_S
    log(f"[kernel] emit_single at the hivar recipe: B={B}, k_left {L}: "
        f"kernels through the counts' copy {ms:.4f} ms, the whole entry "
        f"(and the text's copy, decode and write) {entry_ms:.4f} ms, plain "
        f"{r['plain_s'] * 1e3:.4f} ms, bound {bound_s * 1e3:.4f} ms "
        f"({n_bytes} bytes)")
    torch.cuda.synchronize()
    return {
        "name": "emit_single", "route": "cuda",
        "source": "ebwt2indel_torch/csrc/emit_single.cu",
        "replaces": None, "launches": results["launches"]["emit_single"],
        "max_abs_err": 0, "ms": ms, "entry_ms": entry_ms,
        "plain_ms": r["plain_s"] * 1e3, "bound_ms": bound_s * 1e3,
        "bound_by": "bytes", "library_ms": None,
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log-dir", default=os.path.join("data", "chip_smoke"))
    args = ap.parse_args()

    try:
        import torch

        from ebwt2indel_torch.ops import kernels as kernel_lib
    except ImportError as e:
        print(f"chip_smoke: cannot import the port: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1

    here = os.path.dirname(os.path.abspath(__file__))
    data_dir = os.path.join(here, "data")
    card = card_line()
    log(f"[card] {card}; torch.cuda.get_device_name: "
        f"{torch.cuda.get_device_name(0)}; torch {torch.__version__} "
        f"CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    failures: list[str] = []
    results: dict = {}
    kernels: list[dict] = []

    def phase(name, fn, *a):
        t = time.perf_counter()
        try:
            r = fn(*a)
            log(f"[phase] {name}: ok in {time.perf_counter() - t:.1f} s")
            return r
        except Exception:
            failures.append(name)
            log(f"[phase] {name}: FAILED\n{traceback.format_exc()}")
            return None

    phase("build", lambda: log(
        f"[build] {kernel_lib.build()} in {time.perf_counter() - t0:.2f} s"))
    if not failures:
        phase("kernel_vs_plain", phase_kernel_vs_plain)
        phase("cuda_vs_cpu", phase_cuda_vs_cpu, data_dir)
        phase("mode1_cuda_vs_cpu_14M", phase_cuda_vs_cpu, data_dir,
              CPU_GENOME_LEN, SEED, COVERAGE)
        phase("full_mode1", phase_full, results, data_dir,
              os.path.join(here, args.log_dir))
        if "launches" in results:
            for name, fn in (("kernel_at_main_shape",
                              phase_kernel_at_main_shape),
                             ("next_set_at_main_shape",
                              phase_next_set_at_main_shape),
                             ("emit_single_at_main_shape",
                              functools.partial(phase_emit_single,
                                                data_dir=data_dir))):
                k = phase(name, fn, results)
                if k:
                    kernels.append(k)
            phase("repeats", phase_repeats, results, data_dir)
            phase("profile", phase_profile, results, data_dir)
        phase("pair_cuda_vs_cpu", phase_pair_cuda_vs_cpu, data_dir)
        phase("pair_data", phase_pair_data, results, data_dir)
        if "pair_paths" in results:
            for mode in (3, 2):
                phase(f"full_mode{mode}", phase_full_pair, results, mode,
                      data_dir, os.path.join(here, args.log_dir))
            for mode in (3, 2):
                if f"mode{mode}" in results:
                    phase(f"repeats_mode{mode}", phase_repeats, results,
                          data_dir, 3, mode)
                    phase(f"profile_mode{mode}", phase_profile, results,
                          data_dir, mode)
        if all(k in results for k in ("launches", "mode3", "mode2")):
            phase("packed_116M", phase_packed_116m, results, data_dir)
        phase("tools_cuda_vs_cpu", phase_tools_cuda_vs_cpu, data_dir)
        if "launches" in results:
            phase("validate_116M", phase_validate_116m, results, data_dir)
            if "validate_116M" in results:
                phase("pebwt2indel_116M", phase_pebwt2indel_116m, results,
                      data_dir)
            phase("resume_116M", phase_resume_116m, results, data_dir)
            phase("mesh_rank_vs_plain", phase_mesh_rank_vs_plain, results)
            phase("mesh4_mode1_116M", phase_mesh, "mesh4_mode1_116M",
                  ["-1", results["full_path"]], results["full_out"],
                  results["full_stats"], results["n"], data_dir,
                  os.path.join(here, args.log_dir))
        for mode in (3, 2):
            if f"mode{mode}" in results:
                r = results[f"mode{mode}"]
                phase(f"mesh4_mode{mode}_116M", phase_mesh,
                      f"mesh4_mode{mode}_116M",
                      _pair_args(results["pair_paths"], mode), r["full_out"],
                      r["stats"], r["n"], data_dir,
                      os.path.join(here, args.log_dir), mode)
        if "launches" in results:
            phase("mesh4_resume_mode1_116M", phase_mesh_resume, results, 1,
                  data_dir, os.path.join(here, args.log_dir))
        if "mode2" in results:
            phase("mesh4_resume_mode2_116M", phase_mesh_resume, results, 2,
                  data_dir, os.path.join(here, args.log_dir))
        if all(k in results for k in ("launches", "mode3", "mode2")):
            phase("index_cache_116M", phase_index_cache_116m, results,
                  data_dir)
            if torch.cuda.device_count() >= 2:
                phase("mesh_nccl_2proc", phase_mesh_nccl, results, data_dir,
                      os.path.join(here, args.log_dir))
            else:
                log(f"[mesh_nccl_2proc] not run: torch.cuda.device_count() "
                    f"is {torch.cuda.device_count()}, and NCCL puts no two "
                    "processes of one group on one card")
        phase("scale_mode1_1G", phase_scale_1g, results, data_dir,
              os.path.join(here, args.log_dir))
        if "huge" in results:
            h = results["huge"]
            phase("mesh4_mode1_1G", phase_mesh, "mesh4_mode1_1G",
                  ["-1", h["path"]], h["out"], h["stats"], h["n"], data_dir,
                  os.path.join(here, args.log_dir))
            phase("index_cache_1G", phase_index_cache_1g, results, data_dir,
                  os.path.join(here, args.log_dir))
        if all(k in results for k in ("launches", "pair_paths")):
            run_past2g31(phase, results, data_dir,
                         os.path.join(here, args.log_dir))
    log(f"[done] {time.perf_counter() - t0:.1f} s; failed phases: "
        f"{failures or 'none'}")
    if failures or not kernels:
        return 1
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
