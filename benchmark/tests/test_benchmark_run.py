"""Rehearsals of whole runs on the CPU at a tiny size, in every cell: the
last line's keys, the checks, and each fault of the timed path seen as not
correct."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT, tiny_cell

from benchmark.common import result
from benchmark.common.result import KEYS


def _run(workload, cpu, trace=False, fault=None, seconds=1.5):
    import time

    cell = tiny_cell(workload)
    outcome, device, breakdown = cell.generator().run(
        cell, seed=2**31 + 11, seconds=seconds, trace=trace, device=cpu,
        t_start=time.perf_counter(), fault=fault)
    metrics = cell.read_metrics(cell.per_layer if trace else cell.end_to_end, outcome.window)
    return json.loads(result.last_line(outcome, metrics, device, breakdown if trace else None))


@pytest.mark.parametrize("workload", ["large-train-b24", "cnn_rnn-train-b24"])
@pytest.mark.parametrize("trace", [False, True])
def test_rehearsal_gives_a_correct_line(workload, trace, cpu):
    line = _run(workload, cpu, trace, seconds=4.0 if trace else 1.5)
    assert list(line) == [k for k in KEYS if k in line]
    assert set(line) == set(KEYS) - ({"breakdown"} if not trace else set())
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0, line
    assert list(line["checks"]) == list(json.load(open(
        f"{ROOT}/benchmark/limits/{workload}.json")))
    assert line["device"]["platform"] == "cpu"  # never a card's name from a CPU run
    if not trace:
        assert "setup_s" in line["metrics"]


@pytest.mark.parametrize("workload,fault", [("large-train-b24", "frozen"),
                                            ("large-train-b24", "half_batch"),
                                            ("cnn_rnn-train-b24", "frozen"),
                                            ("cnn_rnn-train-b24", "half_batch")])
def test_a_broken_timed_path_is_not_correct(workload, fault, cpu):
    assert _run(workload, cpu, fault=fault)["correct"] is False


def test_no_card_exits_without_a_result():
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "large-train-b24",
                           "--seed", "5", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_nothing_is_run_in_a_folder_without_the_program(tmp_path):
    import shutil

    shutil.copytree(f"{ROOT}/benchmark", tmp_path / "benchmark")
    shutil.copy(f"{ROOT}/BENCHMARK.json", tmp_path)
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "large-train-b24", "--seed", "5", "--seconds", "1"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
