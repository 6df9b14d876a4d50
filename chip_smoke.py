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
   recipe cut to a 1.15 Mbp genome (~29M positions): the .snp must be
   byte-identical and the stats equal;
6. the rank kernel timed against its plain version at the main path's shape:
   the first node chunk (256k nodes x 6 boundaries) of the full-size index;
7. five more full-size CUDA runs for the spread of the wall and phase times
   (median, min, max), then one under ``torch.profiler``: device time by
   kernel name and the device's busy share of the run;
8. modes 3 and 2 on CUDA against the CPU on the pair data of phase 3's
   recipe (the two haplotypes' reads as two collections): byte-identical
   .snp and equal stats;
9. the bench's pair datasets (bench.py:94-121) built into ``data/`` from the
   same reads as phase 4: ``a.ebwt`` and ``b.ebwt`` (~58M positions each)
   and the merged ``.ebwt`` and ``.da`` (~116M positions);
10. modes 3 (``-1 merged.ebwt -d merged.da``) and 2 (``-1 a.ebwt -2
    b.ebwt``) at full size through ``cli.main`` on CUDA, each with the
    kernel's launch count reset just before and read just after; then three
    more runs of each for the spread, and one of each under the profiler;
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
    each route. The packed route must peak at most 12 bytes per position.

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
CPU_GENOME_LEN = 1_150_000  # the CUDA-vs-CPU comparison's depth (~29M)
HUGE_GENOME_LEN = 41_600_000  # the 1.05G-position scale cell
# what the recipe gives with today's simulate.py (repo root and port alike);
# the JAX package's round-3 record, 1,050,399,394, predates a change there
HUGE_N = 1_050_398_182
PACKED_MAX_BYTES_PER_POS = 12


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
    from ebwt2indel_torch.ops import rank_cuda

    os.makedirs(os.path.dirname(cli_log), exist_ok=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rank_cuda.reset_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(args, device="cuda")
    torch.cuda.synchronize()
    r = {"wall": time.perf_counter() - t0, "text": buf.getvalue(),
         "launches": dict(rank_cuda.LAUNCHES),
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
    (t_cluster,) = _grab(r"cluster detect \(device\) ([0-9.]+)s", text)
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
    if launches["rank_decode"] <= 0:
        raise AssertionError("rank_decode never launched on the main path")
    results["launches"] = launches
    results["full_path"] = path
    results["n"] = n
    results["full_out"] = out
    results["full_wall"] = wall


def phase_repeats(results: dict, data_dir: str, reps: int = 5,
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
    """Device time by kernel over one profiled full-size CUDA run."""
    from collections import defaultdict

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    r = results if mode == 1 else results[f"mode{mode}"]
    tag = "" if mode == 1 else f"_mode{mode}"
    out = os.path.join(data_dir, f"full_profiled{tag}.snp")
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        RUNS[mode](r["full_path"], out, "cuda")
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by_name: dict[str, float] = defaultdict(float)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    if not by_name:
        log("[profile] the profiler recorded no device time: not measured")
        return
    log(f"[profile] mode {mode}: device busy {busy:.1f} ms over "
        f"{wall * 1e3:.1f} ms of profiled wall "
        f"({100 * busy / (wall * 1e3):.1f}%); unprofiled wall "
        f"{r['full_wall'] * 1e3:.1f} ms")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        log(f"[profile] {ms:10.3f} ms  {100 * ms / busy:5.1f}%  {name[:110]}")


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


def phase_full_pair(results: dict, mode: int, data_dir: str,
                    log_dir: str) -> None:
    """Mode 3 or 2 at full size through ``cli.main`` on CUDA."""
    paths = results["pair_paths"]
    args = (["-1", paths["a.ebwt"], "-2", paths["b.ebwt"]] if mode == 2
            else ["-1", paths["merged.ebwt"], "-d", paths["merged.da"]])
    out = os.path.join(data_dir, f"full_mode{mode}.snp")
    r = _cli_run(args + ["-o", out],
                 os.path.join(log_dir, f"chip_smoke_cli_mode{mode}.log"))
    wall, text, launches = r["wall"], r["text"], r["launches"]
    (t_index,) = _grab(r"done\. \[([0-9.]+)s\]", text)
    t_leaf, t_node = _grab(r"leaf phase ([0-9.]+)s, node phase ([0-9.]+)s",
                           text)
    (t_cluster,) = _grab(r"\[timing\] cluster detect[^0-9]*([0-9.]+)s",
                         text)
    (t_call,) = _grab(r"call\+emit ([0-9.]+)s", text)
    lcp_values, n_total = _grab(r"Computed (\d+)/(\d+) LCP values", text,
                                int)
    (n_min,) = _grab(r"Found (\d+) LCP minima", text, int)
    (n_clusters,) = _grab(r"Analyzed (\d+) clusters", text, int)
    snp = open(out, "rb").read()
    events = snp.count(b">") // 2  # a pair event is two records
    phases = (f"index {t_index}, leaf {t_leaf}, node {t_node}, "
              f"cluster {t_cluster}, call+emit {t_call}")
    extra = ""
    if mode == 2:
        da_values, _ = _grab(r"Computed (\d+)/(\d+) DA values", text, int)
        leaves, nodes = _grab(r"Processed (\d+) suffix-tree leaves and "
                              r"(\d+) nodes", text, int)
        extra = (f", da_values {da_values}, leaves {leaves}, "
                 f"nodes {nodes}")
    else:
        (t_wait,) = _grab(r"DA-side index wait ([0-9.]+)s", text)
        phases += f", DA-side wait {t_wait}"
    log(f"[full] mode {mode} on {n_total} merged positions: {wall:.3f} s "
        f"wall ({n_total / wall / 1e6:.3f} Mpos/s)")
    log(f"[full] mode {mode} phase seconds: {phases}")
    log(f"[full] mode {mode} stats: lcp_values {lcp_values}, n_min {n_min}, "
        f"n_clusters {n_clusters}{extra}")
    log(f"[full] mode {mode}: {events} events; .snp sha256 "
        f"{hashlib.sha256(snp).hexdigest()}")
    log(f"[full] mode {mode} torch.cuda.max_memory_allocated {r['peak']} "
        "bytes")
    log(f"[full] mode {mode} kernels {json.dumps(launches)}; queries "
        f"{json.dumps(r['queries'])}")
    n = os.path.getsize(paths["merged.ebwt"])
    if n_total != n or not (0 < lcp_values <= n) or events <= 0:
        raise AssertionError(f"implausible full-size mode-{mode} result")
    if launches["rank_decode"] <= 0:
        raise AssertionError(f"rank_decode never launched on mode {mode}")
    results[f"mode{mode}"] = {"full_path": paths, "full_out": out, "n": n,
                              "full_wall": wall}


def _measured_run(mode: int, inp, out: str, packed) -> dict:
    """One CUDA run of a mode on a forced route, with the launch counts and
    the peak memory reset just before and read just after."""
    import torch

    from ebwt2indel_torch.ops import rank_cuda

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rank_cuda.reset_launches()
    t0 = time.perf_counter()
    st = RUNS[mode](inp, out, "cuda", packed=packed)
    torch.cuda.synchronize()
    return {"wall": time.perf_counter() - t0, "stats": st,
            "peak": torch.cuda.max_memory_allocated(),
            "launches": rank_cuda.LAUNCHES["rank_decode"],
            "queries": rank_cuda.QUERIES["rank_decode"],
            "snp": open(out, "rb").read()}


def _compare_routes(label: str, runs: dict, keys) -> None:
    """The dense (False) and packed (True) runs wrote the same .snp, with
    equal stats, and both launched the rank kernel."""
    if runs[False]["snp"] != runs[True]["snp"]:
        raise AssertionError(f"{label}: the packed .snp differs from the "
                             "dense .snp")
    for k in keys:
        if runs[False]["stats"][k] != runs[True]["stats"][k]:
            raise AssertionError(f"{label} {k}: dense "
                                 f"{runs[False]['stats'][k]} != packed "
                                 f"{runs[True]['stats'][k]}")
    for packed, r in runs.items():
        if r["launches"] <= 0:
            raise AssertionError(f"{label}: rank_decode never launched on "
                                 f"the {_ROUTE[packed]} route")


_ROUTE = {False: "dense", True: "packed"}


def _route_line(label: str, packed: bool, r: dict, n: int) -> None:
    phases = ", ".join(f"{k} {v:.4f}" for k, v in r["stats"]["seconds"]
                       .items())
    log(f"[{label}] {_ROUTE[packed]}: wall {r['wall']:.4f} s "
        f"({n / r['wall'] / 1e6:.3f} Mpos/s); phases: {phases}; peak "
        f"{r['peak']} bytes ({r['peak'] / n:.3f} B/position); rank_decode "
        f"{r['launches']} launches, {r['queries']} queries")


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


def phase_scale_1g(data_dir: str, log_dir: str) -> None:
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
                      "snp": open(out, "rb").read()}}
    _route_line("scale_1G cli.main", default, runs[default], n)
    runs[not default] = _measured_run(
        1, path, os.path.join(data_dir, "huge_1g_other.snp"), not default)
    _route_line("scale_1G", not default, runs[not default], n)
    _compare_routes("1.05G mode 1", runs, _COMPARED)
    if runs[True]["stats"]["events"] <= 0:
        raise AssertionError("the 1.05G input gave no events")
    log(f"[scale_1G] both routes' .snp byte-identical "
        f"({len(runs[True]['snp'])} bytes, sha256 "
        f"{hashlib.sha256(runs[True]['snp']).hexdigest()}), stats equal: "
        f"{', '.join(_COMPARED)}")
    per_pos = runs[True]["peak"] / n
    if per_pos > PACKED_MAX_BYTES_PER_POS:
        raise AssertionError(f"the packed route peaked at {per_pos:.3f} "
                             f"bytes per position, over "
                             f"{PACKED_MAX_BYTES_PER_POS}")


def phase_kernel_at_main_shape(results: dict) -> dict:
    """Time the kernel on the first node chunk of the full-size index: the
    6 boundaries of 256k real suffix-tree nodes, in node-major order."""
    import torch

    from ebwt2indel_torch.models import fm_index as fm_ops
    from ebwt2indel_torch.models import traverse
    from ebwt2indel_torch.ops import rank

    fm = fm_ops.FMIndex.from_file(results["full_path"], device="cuda")
    frontier = fm.root()[None, :]
    while frontier.shape[0] < traverse.CHUNK:
        ext = fm_ops.extend_node(fm, frontier)
        frontier = traverse._char_major(
            ext, fm_ops.node_num_children(ext) >= 2)
    coords = frontier[: traverse.CHUNK, :6].contiguous()
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log-dir", default=os.path.join("data", "chip_smoke"))
    args = ap.parse_args()

    try:
        import torch

        from ebwt2indel_torch.ops import rank_cuda
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
        f"[build] {rank_cuda.build()} in {time.perf_counter() - t0:.2f} s"))
    if not failures:
        phase("kernel_vs_plain", phase_kernel_vs_plain)
        phase("cuda_vs_cpu", phase_cuda_vs_cpu, data_dir)
        phase("mode1_cuda_vs_cpu_29M", phase_cuda_vs_cpu, data_dir,
              CPU_GENOME_LEN, SEED, COVERAGE)
        phase("full_mode1", phase_full, results, data_dir,
              os.path.join(here, args.log_dir))
        if "launches" in results:
            k = phase("kernel_at_main_shape", phase_kernel_at_main_shape,
                      results)
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
        phase("scale_mode1_1G", phase_scale_1g, data_dir,
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
