"""What a cell is made of, found by name: its entry in ``BENCHMARK.json``,
its configuration file, its traffic file ``portbench/traffic/<traffic>.json``
and one reader ``portbench/metrics/<metric>.py`` for each metric it
reports. A new cell, configuration, traffic mix or metric is a new file and
a new entry; nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import string
from pathlib import Path

BENCH = Path(__file__).resolve().parent
PLACEHOLDERS = string.Formatter()


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    read: object  # run record -> float | None


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file
    traffic: dict  # the traffic file
    end_to_end: tuple[Metric, ...]
    per_layer: tuple[Metric, ...]

    @property
    def inputs(self) -> set[str]:
        """The inputs the traffic's argv names, besides ``out``."""
        names = {f for a in self.traffic["argv"]
                 for _, f, _, _ in PLACEHOLDERS.parse(a) if f}
        return names - {"out"}


def load_reader(name: str):
    """The ``read`` function of ``portbench/metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _metrics(entries: list, cell: str) -> tuple[Metric, ...]:
    return tuple(Metric(m["name"], m["unit"], load_reader(m["name"]))
                 for m in entries
                 if cell in m.get("workloads", [cell]))


def load(root: Path) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def cell(root: Path, name: str) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json."""
    bench = load(root)
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(by_name)})")
    w = by_name[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=json.loads((Path(root) / conf["file"]).read_text()),
        traffic=json.loads(
            (BENCH / "traffic" / f"{w['traffic']}.json").read_text()),
        end_to_end=_metrics(bench["end_to_end"], name),
        per_layer=_metrics(bench["per_layer"], name),
    )
