"""Guards of the PyTorch/CUDA port: it imports neither JAX nor the JAX
package, and its entry points refuse to run without a GPU unless the CPU is
asked for."""

import ast
import importlib
import os

import numpy as np
import pytest
import torch

from ebwt2indel_torch import cli, device
from ebwt2indel_torch.models import fm_index, pipeline
from ebwt2indel_torch.ops import bits
from ebwt2indel_torch.utils.config import Config

REPO = os.path.join(os.path.dirname(__file__), "..")
_FORBIDDEN = ("jax", "jaxlib", "ebwt2indel_tpu")


def _port_files():
    pkg = os.path.join(REPO, "ebwt2indel_torch")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(pkg):
        files += [os.path.join(root, f) for f in names if f.endswith(".py")]
    return sorted(files)


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


_TOOLS = ("build_ebwt", "context2vcf", "ebwt", "filter_snp", "genhuge",
          "pebwt2indel", "run_huge", "sam2vcf", "simulate", "snp2vcf",
          "snp_vs_vcf", "sort_vcf", "tracetop", "validate_huge",
          "vcf_vs_vcf")


def test_port_imports_no_jax():
    files = _port_files()
    tools = os.path.join(REPO, "ebwt2indel_torch", "tools")
    assert {os.path.join(tools, f"{t}.py") for t in _TOOLS} <= set(files)
    for path in files:
        for mod in _imported_modules(path):
            assert mod.split(".")[0] not in _FORBIDDEN, (path, mod)


def test_every_tool_imports_alone():
    """Each tool module imports, and its import loads no JAX module."""
    tools = os.path.join(REPO, "ebwt2indel_torch", "tools")
    names = sorted(f[:-3] for f in os.listdir(tools)
                   if f.endswith(".py") and f != "__init__.py")
    assert names == sorted(_TOOLS)
    for name in names:
        mod = importlib.import_module(f"ebwt2indel_torch.tools.{name}")
        assert mod.__name__.endswith(name)
        assert "ebwt2indel_tpu" not in mod.__dict__


def _needs_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal path cannot run")


def test_default_device_raises_without_cuda():
    _needs_no_cuda()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        device.resolve()
    with pytest.raises(RuntimeError, match="CUDA"):
        fm_index.FMIndex.from_numpy(
            np.zeros((1, 16), np.uint32),
            [[0, 0, 0, 0]], [0, 0, 0, 0], 0, ord("#"))
    with pytest.raises(RuntimeError, match="CUDA"):
        bits.from_numpy(np.zeros(4, np.uint32), [0])
    assert device.resolve("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        device.resolve("meta")


def test_cli_and_pipeline_default_to_cuda(tmp_path):
    _needs_no_cuda()
    path = tmp_path / "r.ebwt"
    path.write_text("AC#G")
    with pytest.raises(RuntimeError, match="CUDA"):
        pipeline.run_one_dataset(
            Config(input1=str(path), output=str(tmp_path / "o.snp")),
            log=lambda *a, **k: None)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["-1", str(path), "-o", str(tmp_path / "o.snp")])
    da = tmp_path / "r.da"
    da.write_text("0101")
    for run, cfg in (
            (pipeline.run_two_datasets,
             Config(input1=str(path), input2=str(path),
                    output=str(tmp_path / "o2.snp"))),
            (pipeline.run_two_datasets_da,
             Config(input1=str(path), input_da=str(da),
                    output=str(tmp_path / "o3.snp")))):
        with pytest.raises(RuntimeError, match="CUDA"):
            run(cfg, log=lambda *a, **k: None)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["-1", str(path), "-2", str(path), "-o",
                  str(tmp_path / "o.snp")])
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["-1", str(path), "-d", str(da), "-o",
                  str(tmp_path / "o.snp")])


def test_tools_default_to_cuda(tmp_path):
    """pebwt2indel and validate_huge run on the card unless asked for the
    CPU, in their functions and their command lines."""
    _needs_no_cuda()
    from ebwt2indel_torch.tools import pebwt2indel, validate_huge

    fa = tmp_path / "r.fa"
    fa.write_text(">r\nACGTACGT\n")
    with pytest.raises(RuntimeError, match="CUDA"):
        pebwt2indel.run(str(fa), 2, 4, str(tmp_path / "out"))
    with pytest.raises(RuntimeError, match="CUDA"):
        pebwt2indel.main([str(fa), "2", "4", str(tmp_path / "out")])
    ebwt_path = tmp_path / "r.ebwt"
    ebwt_path.write_text("AC#G")
    with pytest.raises(RuntimeError, match="CUDA"):
        validate_huge.run(1000, str(ebwt_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        validate_huge.main(["1000", str(ebwt_path)])


@pytest.mark.parametrize("mode, run", [
    (1, "run_one_dataset"), (2, "run_two_datasets"),
    (3, "run_two_datasets_da")])
def test_cli_dispatches_through_the_pipeline_names(tmp_path, monkeypatch,
                                                   capsys, mode, run):
    """With no mesh, ``cli.main`` calls the pipeline function of its mode
    through ``models.pipeline``'s attribute at call time (the benchmark's
    harness wraps those three names to read each run's stats), and prints
    that call's ``seconds`` as the ``[timing] spans`` line."""
    for k in ("EBWT_MESH", "EBWT_COORD", "EBWT_NPROCS", "EBWT_PROCID"):
        monkeypatch.delenv(k, raising=False)
    called = []

    def stand_in(name):
        def fn(cfg, **kw):
            called.append((name, kw["device"]))
            return {"emit_counts": {}, "seconds": {"index": 0.125 * mode}}
        return fn

    for name in ("run_one_dataset", "run_two_datasets",
                 "run_two_datasets_da"):
        monkeypatch.setattr(pipeline, name, stand_in(name))
    path = tmp_path / "r.ebwt"
    path.write_text("AC#G")
    (tmp_path / "r.da").write_text("0101")
    argv = ["-1", str(path), "-o", str(tmp_path / "o.snp")]
    argv += {1: [], 2: ["-2", str(path)], 3: ["-d", str(tmp_path / "r.da")]
             }[mode]
    assert cli.main(argv, device="cpu") == 0
    assert called == [(run, "cpu")]
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == f'[timing] spans {{"index": {0.125 * mode}}}'
