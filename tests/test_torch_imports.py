"""The PyTorch port, chip_smoke.py and the tests' rank worker
(tests/_torch_dist_worker.py) import neither JAX, flax, optax nor pandas,
nor the JAX package: checked in a fresh interpreter (tests/conftest.py imports jax
into this one) and by scanning the sources' import statements."""

import ast
import json
import os
import pkgutil
import subprocess
import sys

import music_transcription_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.dirname(music_transcription_tpu_torch.__file__)
FORBIDDEN = ("jax", "flax", "optax", "pandas", "music_transcription_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _port_modules():
    names = ["music_transcription_tpu_torch"]
    for info in pkgutil.walk_packages([PKG_DIR], prefix="music_transcription_tpu_torch."):
        names.append(info.name)
    return names


def test_importing_the_port_loads_no_jax():
    modules = _port_modules()
    for name in ("ops.lstm_kernel", "ops.attention_kernel", "ops.conv_kernel", "eval", "evaluate",
                 "native", "preprocess", "data.preprocess", "models.remi_tokenizer",
                 "models.event_tokenizer", "models.transformer", "evaluate_ast", "train_ast",
                 "train.ast_step", "parallel.distributed", "parallel.mesh",
                 "parallel.partitioning"):
        assert f"music_transcription_tpu_torch.{name}" in modules
    code = (
        "import importlib, json, sys\n"
        "sys.path.insert(0, 'tests')\n"
        f"for name in {modules!r} + ['chip_smoke', '_torch_dist_worker']:\n"
        "    importlib.import_module(name)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert [m for m in loaded if _forbidden(m)] == []


def test_sources_have_no_jax_import():
    files = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "tests", "_torch_dist_worker.py")]
    for root, _, names in os.walk(PKG_DIR):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                bad += [(path, a.name) for a in node.names if _forbidden(a.name)]
            elif isinstance(node, ast.ImportFrom) and node.module and _forbidden(node.module):
                bad.append((path, node.module))
    assert len(files) > 15
    assert bad == []
