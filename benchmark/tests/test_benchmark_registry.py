"""The harness finds every cell's pieces by name, and picks up a cell, mix
and metric added as files and entries alone."""

import json
import os
import re
import shutil

from conftest import ROOT, tiny_cell

from benchmark.common import registry
from benchmark.common.result import Window

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_name_resolves_to_files():
    bench = registry.load_benchmark(ROOT)
    for w in bench["workloads"]:
        cell = registry.cell(bench, w["name"], ROOT)
        assert cell.config["name"] == w["config"]
        assert cell.reference().forward and cell.generator().run
        assert cell.limits and cell.end_to_end and cell.per_layer
        assert "setup_s" in {m["name"] for m in cell.end_to_end}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics", m["name"] + ".py"))


def test_benchmark_json_keeps_to_its_contract():
    bench = registry.load_benchmark(ROOT)
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in bench[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and c["reduced"] == []
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200
    for m in bench["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e and 1 <= len(m["layer"]) <= 200
        for w in m["workloads"]:
            cell = registry.cell(bench, w, ROOT)
            assert m["moves"] in {e["name"] for e in cell.end_to_end}


def test_a_cell_added_as_files_alone_is_found(tmp_path):
    root = str(tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = registry.load_benchmark(ROOT)
    base = os.path.join(root, "benchmark")
    with open(os.path.join(base, "traffic", "train-short.json"), "w") as f:
        json.dump({**tiny_cell("large-train-b24").traffic, "batch": 12}, f)
    with open(os.path.join(base, "limits", "large-train-b12.json"), "w") as f:
        json.dump({"loss": 0.5}, f)
    with open(os.path.join(base, "metrics", "steps_done.py"), "w") as f:
        f.write("def read(w):\n    return w.steps or None\n")
    bench["workloads"].append({"name": "large-train-b12", "config": "cnn_rnn_large-bf16",
                               "traffic": "train-short", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "steps_done", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "device",
                               "moves": "train_audio_s_per_s",
                               "workloads": ["large-train-b12"]})
    for m in bench["end_to_end"]:
        if "large-train-b24" in m.get("workloads", []):
            m["workloads"].append("large-train-b12")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    cell = registry.cell(registry.load_benchmark(root), "large-train-b12", root)
    assert cell.traffic["batch"] == 12 and cell.limits == {"loss": 0.5}
    assert "steps_done" in {m["name"] for m in cell.per_layer}
    assert "train_audio_s_per_s" in {m["name"] for m in cell.end_to_end}
    window = Window(model=cell.config["model"], reference=cell.reference(), frames=938,
                    chunk_s=30.0, steps=3)
    got = cell.read_metrics([m for m in cell.per_layer if m["name"] == "steps_done"],
                            window)
    assert got == {"steps_done": {"value": 3.0, "unit": "steps"}}
