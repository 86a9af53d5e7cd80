"""No run holds JAX or the JAX package, compared by whole top-level names,
and the reference imports nothing of the program."""

import ast
import os
import subprocess
import sys

from conftest import ROOT

from benchmark.common import result

PORT = "music_transcription_tpu_torch"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "music_transcription_tpu_torch_fake", object())
    assert "music_transcription_tpu_torch_fake" not in result.forbidden_modules()
    monkeypatch.setitem(sys.modules, "music_transcription_tpu.config", object())
    assert result.forbidden_modules() == ["music_transcription_tpu.config"]


def test_a_rehearsal_loads_no_jax():
    code = ("import sys, time, torch; sys.path.insert(0, '.'); sys.path.insert(0, "
            "'benchmark/tests'); from conftest import tiny_cell; "
            "from benchmark.common.result import forbidden_modules; "
            "c = tiny_cell('cnn_rnn-train-b24'); "
            "c.generator().run(c, seed=3, seconds=0.5, trace=False, device=torch.device('cpu'), "
            "t_start=time.perf_counter()); print(forbidden_modules())")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_the_reference_imports_nothing_of_the_program():
    folder = os.path.join(ROOT, "benchmark", "reference")
    for name in os.listdir(folder):
        if not name.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(folder, name)).read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                    else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for m in mods:
                assert m.split(".")[0] not in (PORT, "music_transcription_tpu", "jax", "flax"), \
                    f"{name} imports {m}"
    code = ("import sys; sys.path.insert(0, '.'); import benchmark.reference.cnn_rnn, "
            "benchmark.reference.training; "
            f"print(sorted(m for m in sys.modules if m.split('.')[0] == '{PORT}'))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.stdout.strip() == "[]", proc.stderr[-2000:]
