"""The benchmark's inputs, made on the device from the seed.

One recipe (a configuration file under ``portbench/configs/``) makes a
random genome, a second haplotype with isolated SNPs and indels planted at
least ``min_variant_spacing`` bases apart, and ``coverage / 2`` of uniform
reads of each haplotype with substitution errors: the model of the
upstream tool's ``datasets/simulate`` protocol. Every draw comes from one
``torch.Generator`` seeded with the run's seed, in a few large calls, so a
seed gives the same reads on every run.

The files a traffic mix names are written from those reads:

* ``reads``: the eBWT of both read sets as one collection (mode 1);
* ``a``, ``b``: the eBWT of each read set (mode 2);
* ``merged``, ``da``: the eBWT of both, the first set's reads first, and
  its document array, ``1`` where a suffix is of the second set (mode 3).
"""

from __future__ import annotations

import os

import torch

from .reference import suffixes

EBWT_INPUTS = ("reads", "a", "b", "merged")  # files counted as positions


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def plant_variants(genome: torch.Tensor, g: torch.Generator,
                   recipe: dict) -> torch.Tensor:
    """The second haplotype: candidate sites drawn without replacement in
    [60, n - 60), a site kept where it lies ``min_variant_spacing`` or
    more after the previous candidate; each an indel with probability
    indel_rate / (snp_rate + indel_rate), of 1..max_indel bases, a deletion
    or an insertion of random bases before the site with even odds, else a
    SNP to one of the other three bases."""
    dev = genome.device
    n = genome.shape[0]
    snp, indel = recipe["snp_rate"], recipe["indel_rate"]
    max_indel, spacing = recipe["max_indel"], recipe["min_variant_spacing"]
    m = min(int(n * (snp + indel)), (n - 120) // 60)
    pos = torch.sort(torch.randperm(n - 120, generator=g, device=dev)[:m]
                     + 60).values
    keep = torch.ones_like(pos, dtype=torch.bool)
    keep[1:] = (pos[1:] - pos[:-1]) >= spacing
    pos = pos[keep]
    e = pos.shape[0]
    is_indel = torch.rand(e, generator=g, device=dev) < indel / (snp + indel)
    ln = torch.randint(1, max_indel + 1, (e,), generator=g, device=dev)
    is_del = is_indel & (torch.rand(e, generator=g, device=dev) < 0.5) \
        & (pos + ln + 1 < n)
    is_ins = is_indel & ~is_del
    shift = torch.randint(1, 4, (e,), generator=g, device=dev,
                          dtype=torch.uint8)
    ins = torch.randint(0, 4, (e, max_indel), generator=g, device=dev,
                        dtype=torch.uint8)

    base = genome.clone()
    snp_at = pos[~is_indel]
    base[snp_at] = (genome[snp_at] + shift[~is_indel]) % 4
    kept = torch.ones(n, dtype=torch.bool, device=dev)
    for k in range(max_indel):
        d = is_del & (k < ln)
        kept[pos[d] + k] = False
    ins_len = torch.zeros(n, dtype=torch.int64, device=dev)
    ins_len[pos[is_ins]] = ln[is_ins]
    count = kept.long() + ins_len
    start = torch.cumsum(count, 0) - count
    hap = torch.empty(int(count.sum()), dtype=torch.uint8, device=dev)
    hap[(start + ins_len)[kept]] = base[kept]
    j = torch.arange(max_indel, device=dev)
    slot = is_ins[:, None] & (j[None, :] < ln[:, None])
    hap[(start[pos][:, None] + j[None, :])[slot]] = ins[slot]
    return hap


def sample_reads(hap: torch.Tensor, coverage: float, L: int,
                 error_rate: float, g: torch.Generator) -> torch.Tensor:
    """int(n * coverage / L) reads of L bases at uniform starts, each base
    replaced by one of the other three with probability error_rate;
    (R, L) uint8 codes."""
    dev = hap.device
    n = hap.shape[0]
    R = int(n * coverage / L)
    starts = torch.randint(0, n - L + 1, (R,), generator=g, device=dev)
    reads = hap[starts[:, None] + torch.arange(L, device=dev)]
    err = torch.rand((R, L), generator=g, device=dev) < error_rate
    sub = torch.randint(1, 4, (R, L), generator=g, device=dev,
                        dtype=torch.uint8)
    return torch.where(err, (reads + sub) % 4, reads)


def make_reads(recipe: dict, seed: int, device) -> tuple[torch.Tensor,
                                                          torch.Tensor]:
    """The two read sets, (R1, L) and (R2, L) uint8 codes on ``device``:
    the genome's and the second haplotype's, each at half the coverage."""
    g = generator(seed, device)
    genome = torch.randint(0, 4, (recipe["genome_length"],), generator=g,
                           device=device, dtype=torch.uint8)
    hap2 = plant_variants(genome, g, recipe)
    half = recipe["coverage"] / 2
    L, err = recipe["read_length"], recipe["error_rate"]
    return (sample_reads(genome, half, L, err, g),
            sample_reads(hap2, half, L, err, g))


def ebwt_bytes(reads: torch.Tensor) -> bytes:
    order = suffixes.sort_suffixes(reads)
    return suffixes.to_ascii(suffixes.bwt_codes(reads, order))


def merged_bytes(reads1: torch.Tensor,
                 reads2: torch.Tensor) -> tuple[bytes, bytes]:
    """The eBWT of both sets, the first's reads first, and its document
    array as ASCII ``0``/``1``."""
    reads = torch.cat([reads1, reads2])
    order = suffixes.sort_suffixes(reads)
    bwt = suffixes.to_ascii(suffixes.bwt_codes(reads, order))
    second = order // (reads.shape[1] + 1) >= reads1.shape[0]
    da = (second.to(torch.uint8) + ord("0")).cpu().numpy().tobytes()
    return bwt, da


def write_inputs(names: set[str], reads1: torch.Tensor, reads2: torch.Tensor,
                 directory: str) -> dict[str, str]:
    """Write the named inputs into ``directory``; returns their paths."""
    data: dict[str, bytes] = {}
    if "reads" in names:
        data["reads"] = ebwt_bytes(torch.cat([reads1, reads2]))
    if "a" in names:
        data["a"] = ebwt_bytes(reads1)
    if "b" in names:
        data["b"] = ebwt_bytes(reads2)
    if names & {"merged", "da"}:
        data["merged"], data["da"] = merged_bytes(reads1, reads2)
    unknown = names - set(data)
    if unknown:
        raise ValueError(f"no input named {sorted(unknown)}")
    paths = {}
    for name in sorted(names):
        paths[name] = os.path.join(directory,
                                   f"{name}.da" if name == "da"
                                   else f"{name}.ebwt")
        with open(paths[name], "wb") as f:
            f.write(data[name])
    return paths
