#!/usr/bin/env python3
"""Scale validation loop of the port (its copy of the repo-root
``tools/validate_huge.py``): a genhuge-recipe simulation scored through the
reference's documented evaluation workflow (README.md:38-51): mode-1 call
-> filter_snp m=5 -> context placement -> sort -> vcf_vs_vcf (scoring rules
vcf_vs_vcf.cpp:268-288).

    python -m ebwt2indel_torch.tools.validate_huge GENOME_LEN IN.ebwt
        [CALLS.snp] [OUT.json] [--seed SEED] [--min-cov M]
        [--device cuda|cpu]

GENOME_LEN and SEED must be those of the recipe that made IN.ebwt: the
genome and the planted truth regenerate from them with genhuge's rates
(``genhuge.SNP_RATE``, ``genhuge.INDEL_RATE``), and SEED defaults to
``genhuge.SEED``. The bench's E. coli recipe (``chip_smoke.py``) is the same
draw with seed 0xBE7C. If CALLS.snp exists it is reused; otherwise mode 1
runs here on ``--device`` and writes it. The work files go to
``<IN>_validate/`` beside the input, and the report, with the keys of
``VALIDATION_r05.json`` plus ``device``, to OUT.json (default
``data/validation.json`` in the repository). ``--min-cov`` is the filter's
m, 5 by default (the reference's suggestion at 25x or more); calls made at
a lower coverage, as each piece of ``pebwt2indel`` is, take a lower one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from . import (context2vcf, filter_snp, genhuge, simulate, sort_vcf,
               vcf_vs_vcf)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_OUT = os.path.join(REPO, "data", "validation.json")


def _rates(tp: int, fn: int, fp: int) -> dict:
    return {"TP": tp, "FP": fp, "FN": fn,
            "sensitivity": round(tp / max(tp + fn, 1), 4),
            "precision": round(tp / max(tp + fp, 1), 4)}


def run(genome_len: int, ebwt_path: str, snp_path: str | None = None,
        out_json: str | None = None, seed: int = genhuge.SEED,
        device="cuda", min_cov: int = 5, log=print) -> dict:
    """Score ``snp_path`` (called here if it does not exist) against the
    recipe's truth; writes and returns the report."""
    from .. import device as device_mod
    from .run_huge import _device_line

    dev = device_mod.resolve(device)
    t0 = time.time()
    work = os.path.splitext(os.path.abspath(ebwt_path))[0] + "_validate"
    os.makedirs(work, exist_ok=True)
    snp_path = snp_path or os.path.join(work, "calls.snp")
    out_json = out_json or DEFAULT_OUT

    # the genome and planted truth of the recipe (the reads consume later
    # draws of the same stream)
    rng = np.random.default_rng(seed)
    genome = simulate.random_genome(rng, genome_len)
    _, truth = simulate.plant_variants(rng, genome,
                                       snp_rate=genhuge.SNP_RATE,
                                       indel_rate=genhuge.INDEL_RATE)
    fasta = os.path.join(work, "ref.fasta")
    with open(fasta, "w") as f:
        f.write(">chr1\n")
        for i in range(0, len(genome), 80):
            f.write(genome[i: i + 80] + "\n")
    del genome
    vcf_truth = os.path.join(work, "truth.vcf")
    simulate.write_vcf(vcf_truth, truth, chrom="chr1")
    log(f"[validate_huge] truth ready: {len(truth.snps)} SNPs, "
        f"{len(truth.indels)} indels {time.time() - t0:.0f}s")

    # 1) call, unless the calls exist
    t_call = None
    if not os.path.isfile(snp_path):
        from ..models import pipeline
        from ..utils.config import Config

        t = time.time()
        pipeline.run_one_dataset(Config(input1=ebwt_path, output=snp_path),
                                 log=lambda *a, **k: None, device=dev)
        t_call = round(time.time() - t, 2)
        log(f"[validate_huge] called on {dev} in {t_call}s")
    else:
        log(f"[validate_huge] reusing calls {snp_path}")

    # 2) filter_snp m, 5 by default (the reference's suggested filter for
    #    >=25x coverage, README.md:40)
    filt_path = os.path.join(work, f"calls_m{min_cov}.snp")
    with open(snp_path) as f, open(filt_path, "w") as out:
        filter_snp.filter_stream(f, min_cov, 0, out)

    # 3) place contexts -> VCF (alignment-free snp2vcf), 4) sort
    vcf_out = os.path.join(work, "calls.vcf")
    t = time.time()
    place = context2vcf.convert(filt_path, fasta, vcf_out,
                                log=lambda *a: None)
    t_place = round(time.time() - t, 2)
    log(f"[validate_huge] placed {place['placed']} in {t_place}s")
    vcf_sorted = os.path.join(work, "calls.sorted.vcf")
    with open(vcf_out) as f:
        lines = sort_vcf.sort_vcf_lines(f)
    with open(vcf_sorted, "w") as f:
        f.write("\n".join(lines) + "\n")

    # 5) score (vcf_vs_vcf.cpp:268-288 rules)
    s = vcf_vs_vcf.score(vcf_vs_vcf.read_vcf(vcf_sorted),
                         vcf_vs_vcf.read_vcf(vcf_truth), 10)
    rep = {
        "genome_len": genome_len,
        "positions": os.path.getsize(ebwt_path),
        "truth_snps": len(truth.snps),
        "truth_indels": len(truth.indels),
        "placed": place["placed"],
        "unique_variants": place["unique"],
        "dropped": place["dropped"],
        "snp": _rates(s["TP_s"], s["FN_s"], s["FP_s"]),
        "indel": _rates(s["TP_i"], s["FN_i"], s["FP_i"]),
        "call_seconds": t_call,
        "place_seconds": t_place,
        "total_seconds": round(time.time() - t0, 2),
        "device": _device_line(dev),
    }
    os.makedirs(os.path.dirname(os.path.abspath(out_json)), exist_ok=True)
    with open(out_json, "w") as f:
        json.dump(rep, f, indent=1)
    log(json.dumps(rep))
    return rep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("genome_len", type=int)
    ap.add_argument("ebwt")
    ap.add_argument("calls", nargs="?")
    ap.add_argument("report", nargs="?")
    ap.add_argument("--seed", type=lambda s: int(s, 0), default=genhuge.SEED,
                    help="the recipe's seed (default genhuge's, 0xB16B16)")
    ap.add_argument("--min-cov", type=int, default=5,
                    help="filter_snp's m (default 5)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run(args.genome_len, args.ebwt, args.calls, args.report, args.seed,
        device=args.device, min_cov=args.min_cov)
    return 0


if __name__ == "__main__":
    sys.exit(main())
