"""The node step around its CUDA kernel, on the CPU: the wrapper
(``ops/node_cuda.py``) refuses what the kernel cannot take before it loads
the library, a CPU chunk runs the plain step and still gives the JAX
package's flags and counts, the flags do not depend on the order of the kept
children within one character, and the kernel library is keyed on every
file under ``csrc/``. The kernel itself is held against the plain step on
the card (``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from ebwt2indel_tpu.models import fm_index as jfm
from ebwt2indel_tpu.models import traverse as jtraverse
from ebwt2indel_tpu.ops import packing as jpacking
from ebwt2indel_tpu.utils import dna
from ebwt2indel_torch.models import fm_index as fm
from ebwt2indel_torch.models import traverse
from ebwt2indel_torch.ops import kernels, node_cuda
from tests import oracle

_STATS = ("leaves", "nodes", "lcp_values", "n_min")


def _indexes(seed: int, n_reads: int, length: int):
    rng = np.random.default_rng(seed)
    genome = "".join(rng.choice(list("ACGT"), size=300))
    reads = oracle.random_reads(rng, n_reads, length, mutate_from=genome)
    codes = dna.str_to_codes(oracle.ebwt_from_reads(reads))
    jf = jfm.FMIndex.from_packed(jpacking.pack_codes(codes))
    tf = fm.FMIndex.from_numpy(np.asarray(jf.blocks),
                               np.asarray(jf.block_counts), np.asarray(jf.F),
                               jf.n, jf.term, device="cpu")
    return jf, tf


def _assert_jax_flags(got, jf, K, k_right):
    want = jtraverse.navigate_one_bwt(jf, K, k_right)
    for name in ("thr_K", "thr_R", "minima"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    for k in _STATS:
        assert got.stats[k] == want.stats[k], k


def _step_args(**change):
    """Tensors the wrapper accepts, but on the CPU, with ``change``
    replacing some of them."""
    args = {"blocks": torch.zeros((4, 16), dtype=torch.int32),
            "F": torch.zeros(4, dtype=torch.int64),
            "chunk": torch.zeros((5, 7), dtype=torch.int64),
            "flags": torch.zeros(512, dtype=torch.uint8),
            "stats": torch.zeros(3, dtype=torch.int64)}
    args.update(change)
    return args


_REFUSED = {
    "cpu_tensors": ({}, "CUDA device"),
    "chunk_int32": ({"chunk": torch.zeros((5, 7), dtype=torch.int32)},
                    "int64"),
    "chunk_6_columns": ({"chunk": torch.zeros((5, 6), dtype=torch.int64)},
                        r"\(C, 7\)"),
    "chunk_13_columns": ({"chunk": torch.zeros((5, 13),
                                               dtype=torch.int64)},
                         r"\(C, 7\)"),
    "chunk_1d": ({"chunk": torch.zeros(35, dtype=torch.int64)}, r"\(C, 7\)"),
    "chunk_not_contiguous": ({"chunk": torch.zeros(
        (7, 5), dtype=torch.int64).t()}, "contiguous"),
    "flags_int32": ({"flags": torch.zeros(512, dtype=torch.int32)},
                    "uint8"),
    "flags_bool": ({"flags": torch.zeros(512, dtype=torch.bool)}, "uint8"),
    "stats_short": ({"stats": torch.zeros(2, dtype=torch.int64)}, "stats"),
    "stats_int32": ({"stats": torch.zeros(3, dtype=torch.int32)}, "stats"),
    "F_int32": ({"F": torch.zeros(4, dtype=torch.int32)}, "F must"),
    "blocks_int64": ({"blocks": torch.zeros((4, 16), dtype=torch.int64)},
                     "blocks"),
    "blocks_8_words": ({"blocks": torch.zeros((4, 8), dtype=torch.int32)},
                       "blocks"),
}


@pytest.mark.parametrize("case", sorted(_REFUSED))
def test_wrapper_refuses_before_loading_the_library(case, monkeypatch):
    change, message = _REFUSED[case]

    def load():
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(kernels, "load", load)
    before = node_cuda.LAUNCHES["node_step"]
    with pytest.raises(ValueError, match=message):
        node_cuda.node_step(**_step_args(**change), K=16, k_right=30)
    assert node_cuda.LAUNCHES["node_step"] == before


@pytest.mark.parametrize("seed,n_reads,length,K,k_right", [
    (7, 40, 30, 5, 8), (8, 60, 45, 8, 5),
])
def test_cpu_node_step_is_the_plain_one_and_matches_jax(
        monkeypatch, seed, n_reads, length, K, k_right):
    """A CPU chunk goes to ``_node_body_plain``, once a step, and the
    traversal's flags and counts are the JAX package's."""
    jf, tf = _indexes(seed, n_reads, length)
    plain, steps = traverse._node_body_plain, []
    calls = []

    def counted_plain(*a):
        calls.append(a[1].shape[0])
        return plain(*a)

    body = traverse._node_body

    def counted_body(*a):
        steps.append(a[1].shape[0])
        return body(*a)

    monkeypatch.setattr(traverse, "_node_body_plain", counted_plain)
    monkeypatch.setattr(traverse, "_node_body", counted_body)
    got = traverse.navigate_one_bwt(tf, K, k_right)
    assert calls == steps and sum(calls) == got.stats["nodes"] > 0
    _assert_jax_flags(got, jf, K, k_right)


@pytest.mark.parametrize("seed", [11, 12, 2**31 + 13])
def test_flags_do_not_depend_on_order_within_a_character(monkeypatch, seed):
    """Kept children shuffled within each character's region (the kernel
    keeps ``_char_major``'s order exactly; this is what the order is free
    to be): the traversal still gives the JAX package's flags and counts."""
    jf, tf = _indexes(seed % 1000, 40, 35)
    gen = torch.Generator().manual_seed(seed)
    char_major = traverse._char_major

    def shuffled(children, keep):
        rows = char_major(children, keep)
        parts = torch.split(rows, keep.sum(0).tolist())
        return torch.cat([p[torch.randperm(p.shape[0], generator=gen)]
                          for p in parts])

    monkeypatch.setattr(traverse, "_char_major", shuffled)
    monkeypatch.setattr(traverse, "CHUNK", 13)
    _assert_jax_flags(traverse.navigate_one_bwt(tf, 5, 8), jf, 5, 8)


def test_kernel_library_is_keyed_on_every_file_under_csrc(tmp_path,
                                                          monkeypatch):
    """Headers are not compiled alone but key the library: a changed
    header names another library, so a stale one is never loaded."""
    names = {p.name for p in kernels.KEYED}
    assert "block_rank.cuh" in names and "node_step.cu" in names
    assert {p.name for p in kernels.SOURCES} == \
        {n for n in names if n.endswith(".cu")}
    copies = []
    for p in kernels.KEYED:
        q = tmp_path / p.name
        q.write_bytes(p.read_bytes())
        copies.append(q)
    monkeypatch.setattr(kernels, "KEYED", copies)
    before = kernels.library_path()
    header = tmp_path / "block_rank.cuh"
    header.write_bytes(header.read_bytes() + b"\n")
    assert kernels.library_path() != before
    assert kernels.library_path().parent == kernels.BUILD_DIR
