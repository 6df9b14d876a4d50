"""Mode 3 end to end (a merged eBWT and its document array, ``-d``): the
port's .snp (ebwt2indel_torch, on the CPU) must be byte-identical to the JAX
package's over the flag matrix of tests/test_parity.py, with the stats
equal; and the port's CLI must write what its pipeline writes."""

import numpy as np
import pytest

from ebwt2indel_tpu.models import pipeline as jpipeline
from ebwt2indel_tpu.models import traverse as jtraverse
from ebwt2indel_tpu.tools import ebwt as jebwt
from ebwt2indel_tpu.utils.config import Config
from ebwt2indel_torch import cli
from ebwt2indel_torch.models import pipeline
from ebwt2indel_torch.tools import ebwt
from tests.test_parity import FLAG_SETS, _make_pair_inputs, apply_flags

_QUIET = {"log": lambda *a, **k: None}


@pytest.fixture(scope="module", autouse=True)
def _small_jax_chunks():
    """The JAX queue pays a whole chunk per step on the CPU; a smaller chunk
    changes none of its results (the traversal's writes do not depend on
    visit order) and keeps these tests short."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtraverse, "CHUNK", 4096)
        yield
_STATS = ("events", "cluster_nr", "leaves", "nodes", "lcp_values", "n_min",
          "n_clusters")


@pytest.fixture(scope="module")
def merged(tmp_path_factory):
    """The pair data of tests/test_parity.py as a merged eBWT and DA,
    built once; the port's ebwt_and_da_of_two must give the JAX one's files."""
    d = tmp_path_factory.mktemp("torch_mode3")
    reads1, reads2 = _make_pair_inputs(d, np.random.default_rng(0xEB37))
    bwt, da = jebwt.ebwt_and_da_of_two(reads1, reads2)
    assert ebwt.ebwt_and_da_of_two(reads1, reads2) == (bwt, da)
    (d / "merged.ebwt").write_text(bwt)
    (d / "merged.da").write_text(da)
    return d


def _cfg(d, out, extra=()):
    return apply_flags(Config(input1=str(d / "merged.ebwt"),
                              input_da=str(d / "merged.da"),
                              output=str(d / out)), list(extra))


@pytest.mark.parametrize("extra", FLAG_SETS)
def test_mode3_byte_identical_to_jax(merged, extra):
    name = "".join(extra)
    jst = jpipeline.run_two_datasets_da(_cfg(merged, f"jax{name}.snp", extra),
                                        **_QUIET)
    tst = pipeline.run_two_datasets_da(
        _cfg(merged, f"torch{name}.snp", extra), device="cpu", **_QUIET)
    want = (merged / f"jax{name}.snp").read_bytes()
    assert (merged / f"torch{name}.snp").read_bytes() == want
    assert tuple(extra) == ("-q", "1") or len(want) > 0
    for k in _STATS:
        assert tst[k] == jst[k], k
    assert set(tst["seconds"]) == {"index", "index.pack", "index.upload",
                                   "index.da_side", "leaf_phase",
                                   "node_phase", "node_phase.wait",
                                   "da_wait", "cluster", "cluster.next_set",
                                   "call_emit",
                                   "call_emit.walks", "call_emit.write",
                                   "call_emit.align", "call_emit.format",
                                   "call_emit.da_rank"}


def test_cli_mode3_matches_pipeline(merged, capsys):
    out = str(merged / "cli.snp")
    assert cli.main(["-1", str(merged / "merged.ebwt"), "-d",
                     str(merged / "merged.da"), "-o", out],
                    device="cpu") == 0
    text = capsys.readouterr().out
    assert "This is ebwt2InDel (PyTorch/CUDA build)." in text
    assert "Running on one sample with input Document array." in text
    assert "Stored to file 0 sequences clustered in" in text
    pipeline.run_two_datasets_da(_cfg(merged, "cli_ref.snp"), device="cpu",
                                 **_QUIET)
    got = open(out, "rb").read()
    assert got == (merged / "cli_ref.snp").read_bytes() and got
