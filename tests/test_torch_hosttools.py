"""The port's host tools (``ebwt2indel_torch/tools/``) against the JAX
package's on the same numpy-seeded inputs: byte-identical files and equal
results. They are text tools, so the tolerance is 0. The inputs are built
as ``tests/test_tools.py`` builds them for its reference parity tests."""

import importlib.util
import io
import json
import os

import numpy as np
import pytest
import torch

from ebwt2indel_tpu.tools import build_ebwt as jbuild_ebwt
from ebwt2indel_tpu.tools import context2vcf as jcontext2vcf
from ebwt2indel_tpu.tools import ebwt as jebwt
from ebwt2indel_tpu.tools import filter_snp as jfilter_snp
from ebwt2indel_tpu.tools import sam2vcf as jsam2vcf
from ebwt2indel_tpu.tools import simulate as jsim
from ebwt2indel_tpu.tools import snp2vcf as jsnp2vcf
from ebwt2indel_tpu.tools import snp_vs_vcf as jsnp_vs_vcf
from ebwt2indel_tpu.tools import sort_vcf as jsort_vcf
from ebwt2indel_tpu.tools import vcf_vs_vcf as jvcf_vs_vcf
from ebwt2indel_torch.models import pipeline
from ebwt2indel_torch.tools import (build_ebwt, context2vcf, ebwt, filter_snp,
                                    genhuge, sam2vcf, simulate, snp2vcf,
                                    snp_vs_vcf, sort_vcf, validate_huge,
                                    vcf_vs_vcf)
from ebwt2indel_torch.utils.config import Config
from tests.test_tools import make_sam_dataset, make_snp_file, make_vcf

REPO = os.path.join(os.path.dirname(__file__), "..")
_QUIET = {"log": lambda *a, **k: None}


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """Two intra-op threads for the port's CPU ops in this module. The suite
    runs several workers on one host, and a thread per core in each of them
    oversubscribes it: on an 8-core host, three workers ran these files
    about three times slower with the default than with two threads each.
    Results do not depend on it. The pebwt2indel and resume test files
    import it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("m,M", [(3, 0), (5, 8), (1, 2), (0, 0), (12, 0)])
def test_filter_stream(tmp_path, rng, m, M):
    path = make_snp_file(tmp_path, rng, n=60)
    outs = []
    for mod in (filter_snp, jfilter_snp):
        out = io.StringIO()
        with open(path) as f:
            mod.filter_stream(f, m, M, out)
        outs.append(out.getvalue())
    assert outs[0] == outs[1]
    assert filter_snp.parse_cov(">a_b_c_cov:+7x_d") == \
        jfilter_snp.parse_cov(">a_b_c_cov:+7x_d") == 7


@pytest.mark.parametrize("case", ["fixed", "random", "two_contigs"])
def test_sort_vcf_lines(tmp_path, rng, case):
    if case == "fixed":
        lines = ["##header", "#CHROM\tPOS", "chr2\t5\tx", "chr1\t100\tx",
                 "chr1\t20\tx", "chr1"]
    else:
        make_vcf(tmp_path / "a.vcf", rng, n=80)
        lines = open(tmp_path / "a.vcf").read().splitlines()
        if case == "two_contigs":
            lines += [ln.replace("chr1", "chr0") for ln in lines[2:40]]
            rng.shuffle(lines)
    assert sort_vcf.sort_vcf_lines(lines) == jsort_vcf.sort_vcf_lines(lines)


@pytest.mark.parametrize("window", [10, 3, 40])
def test_read_vcf_and_score(tmp_path, rng, window):
    p1, p2 = str(tmp_path / "a.vcf"), str(tmp_path / "b.vcf")
    make_vcf(p1, rng, n=120)
    make_vcf(p2, rng, n=120)
    with open(p1, "a") as f:  # a multi-ALT row is split on ','
        f.write("chr1\t77\t.\tA\tC,GT\t100\tPASS\tVT=X\n")
    got = [vcf_vs_vcf.read_vcf(p) for p in (p1, p2)]
    want = [jvcf_vs_vcf.read_vcf(p) for p in (p1, p2)]
    for g, w in zip(got, want):
        assert [vars(e) for e in g] == [vars(e) for e in w]
    s = vcf_vs_vcf.score(*got, window)
    assert s == jvcf_vs_vcf.score(*want, window)
    texts = []
    for mod, st in ((vcf_vs_vcf, s), (jvcf_vs_vcf, s)):
        lines = []
        mod.report(st, log=lines.append)
        texts.append(lines)
    assert texts[0] == texts[1]


@pytest.mark.parametrize("max_mism,sample", [(5, "SAMPLE"), (2, "S2"),
                                             (0, "SAMPLE")])
def test_sam2vcf_convert(tmp_path, rng, max_mism, sample):
    fasta, sam = make_sam_dataset(tmp_path, rng)
    outs, stats = [], []
    for mod in (sam2vcf, jsam2vcf):
        out = str(tmp_path / f"{mod.__name__}.vcf")
        stats.append(mod.convert(fasta, sam, out, max_mism, sample,
                                 log=lambda *a: None))
        outs.append(open(out, "rb").read())
    assert outs[0] == outs[1] and stats[0] == stats[1]
    for cigar in ("60M", "5S55M", "30M2I28M", "30M2D28M", "3I57M", "", "9S"):
        assert sam2vcf.parse_cigar(cigar) == jsam2vcf.parse_cigar(cigar)
    assert sam2vcf.help_text() == jsam2vcf.help_text()


@pytest.fixture(scope="module")
def called(tmp_path_factory):
    """A .snp of the port's mode 1 (on the CPU) on a 6 kbp genome with a
    second haplotype, and the genome as FASTA."""
    d = tmp_path_factory.mktemp("torch_hosttools")
    rng = np.random.default_rng(0x5C)
    genome = jsim.random_genome(rng, 6000)
    hap2, truth = jsim.plant_variants(rng, genome, snp_rate=0.004,
                                      indel_rate=0.001)
    reads = jsim.sample_reads(rng, genome, 10, 100) + \
        jsim.sample_reads(rng, hap2, 10, 100)
    (d / "r.ebwt").write_text(jebwt.ebwt_of_reads(reads))
    pipeline.run_one_dataset(Config(input1=str(d / "r.ebwt"),
                                    output=str(d / "calls.snp")),
                             device="cpu", **_QUIET)
    (d / "ref.fasta").write_text(">chr1\n" + genome + "\n")
    with open(d / "ref80.fasta", "w") as f:
        f.write(">chr1\n" + "".join(genome[i: i + 80] + "\n"
                                    for i in range(0, len(genome), 80)))
    return d, truth


@pytest.mark.parametrize("fasta", ["ref.fasta", "ref80.fasta"])
def test_context2vcf_convert(called, fasta):
    d, _ = called
    outs, stats = [], []
    for mod in (context2vcf, jcontext2vcf):
        out = str(d / f"{mod.__name__}_{fasta}.vcf")
        stats.append(mod.convert(str(d / "calls.snp"), str(d / fasta), out,
                                 log=lambda *a: None))
        outs.append(open(out, "rb").read())
    assert outs[0] == outs[1] and stats[0] == stats[1]
    assert stats[0]["placed"] > 0


def _kissnp_calls(path, genome, truth):
    """KisSNP2-style read pairs around each SNP (tests/test_tools.py:137-
    150), one of them with reference and alternative swapped."""
    lines = []
    for i, (pos, ref, alt) in enumerate(truth.snps):
        p = pos - 1
        if p < 40 or p + 31 >= len(genome):
            continue
        if i == 1:
            ref, alt = alt, ref
        left, right = genome[p - 40: p], genome[p + 1: p + 31]
        lines.append(f">SNP_higher_path_{i}|P_1:30_{ref}/{alt}|high|nb_pol_1")
        lines.append(left + ref + right)
        lines.append(f">SNP_lower_path_{i}|P_1:30_{ref}/{alt}|low|nb_pol_1")
        lines.append(left + alt + right)
    path.write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("k_nonis,rlength", [(31, 100), (400, 50)])
def test_snp_vs_vcf_validate(tmp_path, rng, monkeypatch, k_nonis, rlength):
    genome = jsim.random_genome(rng, 4000)
    _, truth = jsim.plant_variants(rng, genome, snp_rate=0.005,
                                   indel_rate=0.0)
    fasta = tmp_path / "ref.fasta"
    fasta.write_text(">chr1\n" + genome + "\n")
    vcf = tmp_path / "truth.vcf"
    jsim.write_vcf(str(vcf), truth)
    calls = tmp_path / "calls.snp"
    _kissnp_calls(calls, genome, truth)
    refd, contigs = sam2vcf.load_fasta(str(fasta))
    N = sum(len(refd[c]) for c in contigs)
    got = []
    for mod in (snp_vs_vcf, jsnp_vs_vcf):
        monkeypatch.setattr(mod.load_vcf_calls, "k_nonis", k_nonis)
        cv, n_snps, nonis = mod.load_vcf_calls(str(vcf), refd, rlength,
                                               log=lambda *a: None)
        s = mod.validate(str(calls), cv, n_snps, N, log=lambda *a: None)
        got.append(([vars(c) for c in cv], n_snps, nonis, s))
    assert got[0] == got[1]
    assert got[0][3]["TP"] > 0


@pytest.mark.parametrize("qual", ["h", "I"])
def test_snp_to_fastq(called, tmp_path, qual):
    d, _ = called
    outs = []
    for mod in (snp2vcf, jsnp2vcf):
        out = tmp_path / f"{mod.__name__}.fastq"
        mod.snp_to_fastq(str(d / "calls.snp"), str(out), qual)
        outs.append(out.read_bytes())
    assert outs[0] == outs[1] and outs[0].startswith(b"@cluster:")


@pytest.mark.parametrize("chrom,sample", [("chr1", "SAMPLE"), ("ctg7", "X")])
def test_write_vcf(tmp_path, chrom, sample):
    outs = []
    for mod in (simulate, jsim):
        rng = np.random.default_rng(0x7CF)
        genome = mod.random_genome(rng, 5000)
        _, truth = mod.plant_variants(rng, genome, snp_rate=0.004,
                                      indel_rate=0.002)
        out = tmp_path / f"{mod.__name__}.vcf"
        mod.write_vcf(str(out), truth, chrom=chrom, sample=sample)
        outs.append(out.read_bytes())
    assert outs[0] == outs[1] and b"VT=INDEL" in outs[0]


@pytest.mark.parametrize("case", ["written", "multiline"])
def test_fasta_io(tmp_path, rng, case):
    reads = ["".join(rng.choice(list("ACGT"), size=int(k)))
             for k in rng.integers(1, 90, size=25)]
    path = tmp_path / "r.fa"
    if case == "written":
        ebwt.write_fasta_reads(str(path), reads)
        want = tmp_path / "want.fa"
        jebwt.write_fasta_reads(str(want), reads)
        assert path.read_bytes() == want.read_bytes()
    else:  # wrapped lines, lower case, blank lines
        path.write_text("".join(f">s{i} x\n{r[:30].lower()}\n\n{r[30:]}\n"
                                for i, r in enumerate(reads)))
    assert ebwt.read_fasta(str(path)) == jebwt.read_fasta(str(path))
    assert ebwt.read_fasta(str(path)) == reads


@pytest.mark.parametrize("merged", [False, True])
def test_build_ebwt_main(tmp_path, rng, merged, capsys):
    genome = "".join(rng.choice(list("ACGT"), size=400))
    fastas = []
    for k in range(2 if merged else 1):
        f = tmp_path / f"r{k}.fa"
        jebwt.write_fasta_reads(str(f), [genome[i: i + 50]
                                         for i in range(k, 350, 11)])
        fastas.append(str(f))
    outs = []
    for mod in (build_ebwt, jbuild_ebwt):
        files = [str(tmp_path / f"{mod.__name__}.{ext}")
                 for ext in (("ebwt", "da") if merged else ("ebwt",))]
        assert mod.main(fastas + files) == 0
        outs.append([open(f, "rb").read() for f in files])
    assert outs[0] == outs[1]
    assert capsys.readouterr().out.count("wrote") == 2
    assert build_ebwt.main(["only-one-arg"]) == 1


def test_simulate_main(tmp_path, capsys):
    """The dataset directory (genome, truth VCF, read FASTAs, eBWTs, DA)
    of both packages' ``simulate.main``, file for file."""
    args = ["3000", "10", "80", "5"]
    assert simulate.main([str(tmp_path / "port")] + args) == 0
    assert jsim.main([str(tmp_path / "jax")] + args) == 0
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names and \
        "merged.da" in names
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    out = capsys.readouterr().out.splitlines()
    assert out[0].replace("port", "jax") == out[1]


def _root_validate_huge():
    spec = importlib.util.spec_from_file_location(
        "root_validate_huge", os.path.join(REPO, "tools", "validate_huge.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def genhuge_calls(tmp_path_factory):
    """genhuge's recipe at 20 kbp with its own seed and with the E. coli
    cell's (0xBE7C), each called by the port's mode 1 on the CPU."""
    d = tmp_path_factory.mktemp("torch_validate")
    out = {}
    for seed in (genhuge.SEED, 0xBE7C):
        path = d / f"{seed}.ebwt"
        genhuge.build(20_000, str(path), seed=seed, log=lambda *a: None)
        pipeline.run_one_dataset(Config(input1=str(path),
                                        output=str(d / f"{seed}.snp")),
                                 device="cpu", **_QUIET)
        out[seed] = path
    return out


@pytest.mark.parametrize("seed", ["genhuge", "ecoli"])
def test_validate_huge_report(genhuge_calls, tmp_path, monkeypatch, seed):
    """On a reused .snp the port's report equals the repo-root tool's
    (genhuge's seed, the only one that tool knows) apart from the seconds,
    plus the device. With the E. coli cell's seed the truth is regenerated
    from that seed: the calls score as well, and scored against genhuge's
    seed they match nothing."""
    seed = genhuge.SEED if seed == "genhuge" else 0xBE7C
    path = genhuge_calls[seed]
    snp = str(path)[: -len(".ebwt")] + ".snp"
    got = validate_huge.run(20_000, str(path), snp,
                            str(tmp_path / "port.json"), seed=seed,
                            device="cpu", log=lambda *a: None)
    assert json.loads((tmp_path / "port.json").read_text()) == got
    assert got["device"] == {"platform": "cpu", "kind": "cpu", "count": 1}
    assert got["call_seconds"] is None
    assert got["snp"]["sensitivity"] >= 0.8 and got["indel"]["TP"] > 0
    timing = ("call_seconds", "place_seconds", "total_seconds")
    if seed == genhuge.SEED:
        # the root tool works in <input dir>/validate; give it its own copy
        root_dir = tmp_path / "root"
        root_dir.mkdir()
        (root_dir / "in.ebwt").write_bytes(path.read_bytes())
        monkeypatch.setattr("sys.argv", [
            "validate_huge.py", "20000", str(root_dir / "in.ebwt"), snp,
            str(tmp_path / "root.json")])
        assert _root_validate_huge().main() == 0
        want = json.loads((tmp_path / "root.json").read_text())
        assert set(got) == set(want) | {"device"}
        for k in want:
            if k not in timing:
                assert got[k] == want[k], k
    else:
        other = validate_huge.run(20_000, str(path), snp,
                                  str(tmp_path / "other.json"),
                                  device="cpu", log=lambda *a: None)
        assert other["snp"]["TP"] == 0
