"""The benchmark's data: ``BENCHMARK.json`` and the files it names.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. Each is a file of its own, found by name: ``configs/<file>`` as the
configuration's entry says, ``traffic/<traffic>.json``, the limits of the
cell's comparison in ``limits/<cell>.json``, each per-layer metric's
reader in ``metrics/<metric>.py``, and the driver of the system under
test and the plain reference that each configuration names, in
``drivers/<driver>.py`` and ``references/<reference>.py``. Adding a cell, a mix, a
configuration or a metric adds files and entries; no file here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class SpecError(ValueError):
    """A file of the benchmark is missing or malformed."""


def load_json(path: Path) -> dict:
    try:
        return json.loads(path.read_text())
    except FileNotFoundError:
        raise SpecError(f"{path} is missing") from None


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def load_module(path: Path, name: str) -> ModuleType:
    """A module loaded from ``path`` (a metric's reader, a reference)."""
    if not path.exists():
        raise SpecError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    name: str
    config_name: str
    config: dict  # the configuration's file
    traffic_name: str
    traffic: dict  # the traffic mix's file
    limits: dict  # limits/<cell>.json
    chips: int
    end_to_end: List[dict]  # the end-to-end metrics this cell reports
    per_layer: List[dict]  # the per-layer metrics this cell reports

    def reference(self) -> ModuleType:
        ref = self.config["reference"]
        return load_module(HERE / "references" / f"{ref}.py",
                           f"portbench_reference_{ref}")

    def driver(self) -> ModuleType:
        drv = self.config["driver"]
        if not (HERE / "drivers" / f"{drv}.py").exists():
            raise SpecError(f"drivers/{drv}.py is missing")
        return importlib.import_module(f"portbench.drivers.{drv}")

    def reader(self, metric: str) -> ModuleType:
        return load_module(HERE / "metrics" / f"{metric}.py",
                           f"portbench_metric_{metric}")


def _reports(metric: dict, cell: str) -> bool:
    """Whether an end-to-end metric is reported in ``cell``."""
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` under ``root``."""
    bench = benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SpecError(f"no workload {name!r} in BENCHMARK.json; "
                        f"known: {sorted(work)}")
    w = work[name]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[w["config"]]
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in moved)]
    return Cell(
        name=name,
        config_name=w["config"],
        config=load_json(root / entry["file"]),
        traffic_name=w["traffic"],
        traffic=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(HERE / "limits" / f"{name}.json"),
        chips=int(w["chips"]),
        end_to_end=e2e,
        per_layer=layer,
    )

