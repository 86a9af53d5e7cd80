"""Finds what belongs to a cell by the names in ``BENCHMARK.json``.

  * a configuration: the JSON file its entry names (``configs/<name>.json``),
    whose ``reference`` names the plain reference module
    (``reference/<reference>.py``);
  * a traffic mix: ``traffic/<traffic>.json``, whose ``generator`` names the
    general generator that reads it (``generators/<generator>.py``);
  * the limits of the comparison that decides ``correct``:
    ``limits/<workload>.json``;
  * a metric, end-to-end or per-layer: ``metrics/<name>.py``, whose
    ``read(window)`` gives its value or None.

A later cell, mix, configuration or metric is added as files and entries;
nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # benchmark/
ROOT = os.path.dirname(HERE)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file's content
    traffic: dict  # the mix's parameters
    limits: dict  # {number: limit}
    end_to_end: list = field(default_factory=list)  # metric entries this cell reports
    per_layer: list = field(default_factory=list)
    base: str = HERE  # the benchmark's folder

    def reference(self):
        return load_module(os.path.join(self.base, "reference", f"{self.config['reference']}.py"),
                           f"benchmark.reference.{self.config['reference']}")

    def generator(self):
        return load_module(os.path.join(self.base, "generators", f"{self.traffic['generator']}.py"),
                           f"benchmark.generators.{self.traffic['generator']}")

    def read_metrics(self, entries: list, window) -> dict:
        """{name: {"value", "unit"}} of the entries whose reader finds
        something."""
        out = {}
        for m in entries:
            reader = load_module(os.path.join(self.base, "metrics", f"{m['name']}.py"),
                                 f"benchmark.metrics.{m['name'].replace('.', '_')}")
            value = reader.read(window)
            if value is not None:
                out[m["name"]] = {"value": float(value), "unit": m["unit"]}
        return out


def load_benchmark(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def cell(bench: dict, workload: str, root: str = ROOT) -> Cell:
    entries = {w["name"]: w for w in bench["workloads"]}
    if workload not in entries:
        raise SystemExit(f"unknown workload {workload!r}; the benchmark has {sorted(entries)}")
    w = entries[workload]
    config = next(c for c in bench["configs"] if c["name"] == w["config"])
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if workload in m.get("workloads", []) or ("workloads" not in m
                                                        and m["moves"] in moved)]
    base = os.path.join(root, "benchmark")
    return Cell(name=workload, chips=int(w["chips"]),
                config=_json(os.path.join(root, config["file"])),
                traffic=_json(os.path.join(base, "traffic", f"{w['traffic']}.json")),
                limits=_json(os.path.join(base, "limits", f"{workload}.json")),
                end_to_end=e2e, per_layer=layer, base=base)


def pin_caches(root: str = ROOT) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    build = os.path.join(root, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
