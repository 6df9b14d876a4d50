"""The inputs made from the seed: sizes, determinism, and the eBWT, its
document array and the LCP against independent builds."""

import pytest
import torch

from portbench import gen
from portbench.reference import suffixes

RECIPE = dict(genome_length=3000, coverage=20, read_length=100,
              error_rate=0.01, snp_rate=0.01, indel_rate=0.003, max_indel=5,
              min_variant_spacing=60)


def _strings(reads):
    return ["".join("ACGT"[c] for c in row) for row in reads.tolist()]


@pytest.mark.parametrize("seed", [5, 2**31 + 11])
def test_positions_and_pair_sizes(seed, tmp_path):
    r1, r2 = gen.make_reads(RECIPE, seed, "cpu")
    L = RECIPE["read_length"]
    assert r1.shape == (int(3000 * 10 / L), L)
    paths = gen.write_inputs({"reads", "a", "b", "merged", "da"}, r1, r2,
                             str(tmp_path))
    size = {k: (tmp_path / p.split("/")[-1]).stat().st_size
            for k, p in paths.items()}
    n1, n2 = r1.shape[0] * (L + 1), r2.shape[0] * (L + 1)
    assert (size["a"], size["b"]) == (n1, n2)
    assert size["reads"] == size["merged"] == size["da"] == n1 + n2


def test_same_seed_same_inputs():
    a = gen.make_reads(RECIPE, 99, "cpu")
    b = gen.make_reads(RECIPE, 99, "cpu")
    c = gen.make_reads(RECIPE, 100, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])


def test_variants_planted():
    g = gen.generator(3, "cpu")
    genome = torch.randint(0, 4, (20000,), generator=g, dtype=torch.uint8)
    hap = gen.plant_variants(genome, g, RECIPE)
    assert abs(hap.shape[0] - genome.shape[0]) < 200
    assert not torch.equal(hap[:1000], genome[:1000])


@pytest.mark.parametrize("seed", [1, 2])
def test_ebwt_equals_program_builder(seed):
    from ebwt2indel_torch.tools import ebwt

    r1, r2 = gen.make_reads(RECIPE, seed, "cpu")
    s1, s2 = _strings(r1), _strings(r2)
    assert gen.ebwt_bytes(torch.cat([r1, r2])) == \
        ebwt.ebwt_of_reads(s1 + s2).encode()
    bwt, da = gen.merged_bytes(r1, r2)
    want_bwt, want_da = ebwt.ebwt_and_da_of_two(s1, s2)
    assert (bwt, da) == (want_bwt.encode(), want_da.encode())


def test_lcp_brute_force():
    r1, r2 = gen.make_reads(dict(RECIPE, genome_length=600), 7, "cpu")
    reads = torch.cat([r1, r2])
    L = reads.shape[1]
    order = suffixes.sort_suffixes(reads)
    got = suffixes.lcp(reads, order).tolist()
    text = [s + "#" for s in _strings(reads)]

    def suffix(i):
        r, o = divmod(int(i), L + 1)
        return text[r][o:]

    want = [0]
    for a, b in zip(order[:-1].tolist(), order[1:].tolist()):
        x, y = suffix(a), suffix(b)
        k = 0
        while x[k] == y[k] and x[k] != "#":
            k += 1
        want.append(k)
    assert got == want


def test_first_symbol():
    # symbol j of a word sits at bits 3 * (20 - j) .. 3 * (20 - j) + 2
    x = torch.tensor([1, 7, 1 << 45, (1 << 45) | 5, 1 << 60, 7 << 60,
                      (1 << 63) - 1])
    assert suffixes._first_symbol(x).tolist() == [20, 20, 5, 5, 0, 0, 0]
