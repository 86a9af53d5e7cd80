"""``python -m music_transcription_tpu_torch.evaluate_ast`` on the CPU
against the JAX package's ``scripts/evaluate_ast.py``: the same EVAL_AST_*
lines from the same small AST checkpoint (the JAX one as orbax + config.json,
the port's as .pth + .json) on a waveform cache and a tokenized cache built
by the port's preprocessing CLI, and on the raw tree; the flag guards and the
missing card; the AST route of the conversion hint."""

import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from music_transcription_tpu.config import AudioConfig as JAudioConfig
from music_transcription_tpu.config import config_to_dict
from music_transcription_tpu.train.checkpoints import save_checkpoint
from music_transcription_tpu_torch import evaluate_ast as cli
from music_transcription_tpu_torch import preprocess as preprocess_cli
from music_transcription_tpu_torch.checkpoints import state_dict_from_jax
from music_transcription_tpu_torch.config import ModelConfig
from music_transcription_tpu_torch.models.transcription import TranscriptionModel
from music_transcription_tpu_torch.transcribe import CONVERT_HINT
from tests.ast_parity import SMALL, pair
from tests.maestro_fixture import make_maestro_root

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def _eval_lines(text: str) -> dict:
    return dict(line.split("=") for line in text.splitlines() if line.startswith("EVAL_AST_"))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The small fp32 AST model with 1 s chunks, saved both ways; the MAESTRO
    fixture tree; its train split as a waveform cache and a tokenized one."""
    tmp = tmp_path_factory.mktemp("evaluate_ast")
    _, variables, _ = pair("float32")
    sidecar = {"model": dict(SMALL, compute_dtype="float32"),
               "audio": config_to_dict(JAudioConfig(chunk_length=1.0))}
    orbax = str(tmp / "jax_ckpt")
    save_checkpoint(orbax, {"params": variables["params"]})
    with open(os.path.join(orbax, "config.json"), "w") as f:
        json.dump(sidecar, f)
    pth = str(tmp / "model.pth")
    torch.save(state_dict_from_jax(variables, ModelConfig(**sidecar["model"])), pth)
    with open(str(tmp / "model.json"), "w") as f:
        json.dump(sidecar, f)
    root = make_maestro_root(tmp / "maestro")
    caches = {}
    for name, extra in (("wave", ["--waveform"]),
                        ("tokens", ["--waveform", "--tokenize", "--token_len", "64"]),
                        ("mel", ["--n_mels", "32"])):
        caches[name] = str(tmp / f"cache_{name}")
        rc, text = _run(preprocess_cli.main, ["--root_dir", str(root), "--cache_dir",
                                              caches[name], "--splits", "train",
                                              "--chunk_length", "1.0", "-d", "cpu",
                                              "--num_workers", "1", *extra])
        assert rc == 0, text
    spec = importlib.util.spec_from_file_location(
        "jax_evaluate_ast", os.path.join(REPO, "scripts", "evaluate_ast.py"))
    jax_cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_cli)
    return dict(orbax=orbax, pth=pth, root=str(root), tmp=tmp, jax_cli=jax_cli, **caches)


def test_generation_on_a_waveform_cache_matches_jax(setup):
    common = ["--cache_dir", setup["wave"], "--split", "train", "--max_len", "64",
              "--constrained", "--beam", "2", "--frame_f1", "--headless", "--gen_batch_size", "4"]
    rc, text = _run(cli.main, ["--model", setup["pth"], "-d", "cpu", "--out_dir",
                               str(setup["tmp"] / "mids"), *common])
    assert rc == 0, text
    jrc, jtext = _run(setup["jax_cli"].main, ["--model", setup["orbax"], "--device", "cpu",
                                             *common])
    assert jrc == 0, jtext
    lines = _eval_lines(text)
    assert set(lines) == {"EVAL_AST_NOTE_F1", "EVAL_AST_FRAME_F1"}
    assert lines == _eval_lines(jtext)
    assert all(np.isfinite(float(v)) for v in lines.values())
    # per-sample lines (note counts and scores) agree too
    assert ([l for l in text.splitlines() if l.startswith("[")]
            == [l for l in jtext.splitlines() if l.startswith("[")])
    assert os.path.exists(setup["tmp"] / "mids" / "gen_0.mid")
    assert os.path.exists(setup["tmp"] / "mids" / "gt_0.mid")


def test_teacher_forced_on_a_tokenized_cache_matches_jax(setup):
    common = ["--cache_dir", setup["tokens"], "--split", "train", "--teacher_forced",
              "--headless"]
    rc, text = _run(cli.main, ["--model", setup["pth"], "-d", "cpu", *common])
    assert rc == 0, text
    jrc, jtext = _run(setup["jax_cli"].main, ["--model", setup["orbax"], "--device", "cpu",
                                             *common])
    assert jrc == 0, jtext
    lines = _eval_lines(text)
    assert set(lines) == {"EVAL_AST_TF_ACC", "EVAL_AST_TF_PITCH_ACC"}
    assert lines == _eval_lines(jtext)


def test_generation_on_the_raw_tree_and_a_tokenized_cache(setup):
    rc, text = _run(cli.main, ["--model", setup["pth"], "-d", "cpu", "--root_dir",
                               setup["root"], "--split", "validation", "--max_len", "32",
                               "--subset", "2", "--headless"])
    assert rc == 0, text
    assert "Evaluating 2 samples" in text and 0.0 <= float(_eval_lines(text)["EVAL_AST_NOTE_F1"]) <= 1.0
    rc, text = _run(cli.main, ["--model", setup["pth"], "-d", "cpu", "--cache_dir",
                               setup["tokens"], "--split", "train", "--max_len", "32",
                               "--subset", "3", "--headless", "--frame_f1"])
    assert rc == 0, text
    # a tokenized cache holds no rolls: no frame score
    assert set(_eval_lines(text)) == {"EVAL_AST_NOTE_F1"}


def test_flag_guards_and_missing_card(setup, tmp_path, monkeypatch):
    base = ["--model", setup["pth"], "-d", "cpu", "--cache_dir", setup["wave"], "--split", "train"]
    with pytest.raises(SystemExit):
        _run(cli.main, base + ["--teacher_forced", "--beam", "2"])
    with pytest.raises(SystemExit):
        _run(cli.main, base + ["--teacher_forced", "--constrained"])
    rc, text = _run(cli.main, ["--model", setup["pth"], "-d", "cpu", "--cache_dir",
                               setup["mel"], "--split", "train"])
    assert rc == 1 and "holds mel features" in text
    rc, text = _run(cli.main, ["--model", setup["pth"], "-d", "cpu", "--cache_dir",
                               setup["tokens"], "--split", "train", "--tokenizer", "event"])
    assert rc == 1 and "REMI-encoded" in text
    bare = tmp_path / "bare.pth"
    bare.write_bytes(open(setup["pth"], "rb").read())
    rc, text = _run(cli.main, ["--model", str(bare), "-d", "cpu"])
    assert rc == 1 and "no config sidecar" in text
    rc, text = _run(cli.main, ["--model", setup["orbax"], "-d", "cpu"])
    assert rc == 1 and "orbax" in text
    cnn = tmp_path / "cnn.pth"
    cnn_cfg = ModelConfig(model_type="cnn_rnn", n_mels=32, hidden_size=8, num_layers=1)
    torch.save(TranscriptionModel(cnn_cfg).model.state_dict(), cnn)
    (tmp_path / "cnn.json").write_text(json.dumps({"model": config_to_dict(cnn_cfg)}))
    rc, text = _run(cli.main, ["--model", str(cnn), "-d", "cpu"])
    assert rc == 1 and "not an AST checkpoint" in text
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, text = _run(cli.main, ["--model", setup["pth"], "--cache_dir", setup["wave"]])
    assert rc == 1 and "CUDA is not available" in text


def test_convert_hint_carries_a_jax_ast_checkpoint(setup, tmp_path):
    """The conversion hint's AST route (orbax -> the port's state_dict through
    state_dict_from_jax, and the sidecar), run as the hint prints it."""
    hint = CONVERT_HINT.split("python -c ")[-1]
    code = hint.split('"')[1]
    out = str(tmp_path / "converted.pth")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code, setup["orbax"], out],
                          capture_output=True, text=True, cwd=REPO, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got, want = torch.load(out), torch.load(setup["pth"])
    assert sorted(got) == sorted(want) and all(torch.equal(got[k], want[k]) for k in want)
    assert json.load(open(out[:-4] + ".json"))["model"]["model_type"] == "ast"
