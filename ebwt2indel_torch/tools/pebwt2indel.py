"""pebwt2indel — piece-parallel pipeline over a read collection (the port's
copy of ``ebwt2indel_tpu/tools/pebwt2indel.py``).

Equivalent of the reference's only parallel path (pebwt2InDel.sh): break
reads into fixed-length pieces, context-sort so similar reads land in the
same piece, split into pieces, run mode 1 on each piece, and concatenate the
per-piece .snp outputs in piece order.

    python -m ebwt2indel_torch.tools.pebwt2indel input_fasta threads \\
        read_len output_dir [mcov] [--device cuda|cpu]

The chop, the context sort, the split (``per = ceil(len / (p - 1))`` with
``p = max(threads, 2)``) and the concatenation order are the JAX tool's, so
the .snp bytes are too. Where the work runs differs: a ``spawn`` pool of up
to ``threads`` processes builds each piece's eBWT on the host (they never
touch CUDA), and this process runs mode 1 on each piece on ``device``, in
piece order, in one CUDA context, as each eBWT is ready. The device work per
piece is well under a second at E. coli scale, so several CUDA contexts on
one card would gain nothing, and forking after CUDA is initialised is
undefined.

Same correctness contract as the reference (README.md:104-124): variants
supported by reads split across different pieces may be missed; remainder
reads shorter than read_len are dropped.
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
import time
from concurrent.futures import ProcessPoolExecutor

from . import ebwt


def _chop_reads(reads: list[str], read_len: int) -> list[str]:
    """fold -w read_len + drop remainders + N->A (pebwt2InDel.sh:32)."""
    out = []
    for r in reads:
        r = r.replace("N", "A")
        for i in range(0, len(r) - read_len + 1, read_len):
            out.append(r[i : i + read_len])
    return out


def _context_key(read: str, k: int = 16) -> str:
    """Sort key approximating HARC's context reordering: the read's central
    k-mer, then the read itself."""
    mid = max(0, (len(read) - k) // 2)
    return read[mid : mid + k] + read


def _build_piece(args) -> str:
    """Worker: write one piece's eBWT; returns its path."""
    piece_reads, outdir, idx = args
    bwt_path = os.path.join(outdir, f"piece{idx}.ebwt")
    with open(bwt_path, "w") as f:
        f.write(ebwt.ebwt_of_reads(piece_reads))
    return bwt_path


def run(input_fasta: str, threads: int, read_len: int, outdir: str,
        mcov: int = 3, device="cuda", log=print) -> str:
    """Writes ``<outdir>/variants.snp`` and returns its path. Logs, last, the
    seconds of the host preparation (read, chop, sort, split), of waiting
    for the builders, and of the device runs. The pipeline is imported
    here, not at the top: the spawned builders import this module and need
    no torch."""
    from .. import device as device_mod
    from ..models import pipeline
    from ..utils.config import Config

    dev = device_mod.resolve(device)
    t0 = time.perf_counter()
    os.makedirs(outdir, exist_ok=True)
    reads = ebwt.read_fasta(input_fasta)
    log(f"Read {len(reads)} sequences")
    reads = _chop_reads(reads, read_len)
    log(f"{len(reads)} pieces of length {read_len} after chopping")
    reads.sort(key=_context_key)

    p = max(threads, 2)
    per = (len(reads) + p - 2) // (p - 1)  # p-1 pieces like `split` (sh:49)
    pieces = [reads[i : i + per] for i in range(0, len(reads), per)]
    del reads
    log(f"Processing {len(pieces)} pieces: eBWTs on {threads} host "
        f"workers, mode 1 on {dev}")

    jobs = [(piece, outdir, i) for i, piece in enumerate(pieces)]
    del pieces
    outputs = []
    t_prep = time.perf_counter() - t0
    t_wait = t_device = 0.0
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=max(1, min(threads, len(jobs))),
                             mp_context=ctx) as ex:
        # results come in piece order: piece i runs on the device while the
        # workers still build the later pieces
        built = ex.map(_build_piece, jobs)
        del jobs
        while True:
            t = time.perf_counter()
            bwt_path = next(built, None)
            t_wait += time.perf_counter() - t
            if bwt_path is None:
                break
            snp_path = bwt_path[: -len(".ebwt")] + ".snp"
            cfg = Config(input1=bwt_path, output=snp_path, mcov_out=mcov)
            t = time.perf_counter()
            pipeline.run_one_dataset(cfg, log=lambda *a, **k: None,
                                     device=dev)
            t_device += time.perf_counter() - t
            outputs.append((snp_path, bwt_path))

    final = os.path.join(outdir, "variants.snp")
    with open(final, "w") as out:
        for snp_path, bwt_path in outputs:
            with open(snp_path) as f:
                out.write(f.read())
            os.remove(snp_path)
            os.remove(bwt_path)
    log(f"Done. Output: {final}")
    log(f"[timing] host preparation {t_prep:.2f}s, waiting for the eBWT "
        f"builds {t_wait:.2f}s, mode 1 on {dev} {t_device:.2f}s, total "
        f"{time.perf_counter() - t0:.2f}s")
    return final


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="pebwt2indel-torch",
        description="Piece-parallel mode 1 over a FASTA read collection.")
    ap.add_argument("input_fasta")
    ap.add_argument("threads", type=int)
    ap.add_argument("read_len", type=int)
    ap.add_argument("output_dir")
    ap.add_argument("mcov", type=int, nargs="?", default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run(args.input_fasta, args.threads, args.read_len, args.output_dir,
        args.mcov, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
