"""``python -m music_transcription_tpu_torch.train_ast`` on the CPU: its
parser against ``scripts/train_ast.build_parser()``, its flag guards and
cache refusals (in-process: they exit before training), and the port's CLI run
in subprocesses at the JAX package's own tiny geometry (1 encoder and 1
decoder layer of width 32, 2 s chunks, batch 2, 32 tokens): pretraining ->
``--encoder_init --freeze_encoder`` with scheduled sampling, pitch weights
and note-F1 selection under ``--save_best_every`` -> ``evaluate_ast -d
cpu``; SIGTERM flushing model_best.
The JAX script itself is never run in a subprocess; its guards are called
in-process, where they exit before importing JAX."""

import contextlib
import io
import json
import math
import os
import re
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from music_transcription_tpu_torch import train_ast
from music_transcription_tpu_torch.config import ModelConfig, config_from_dict
from music_transcription_tpu_torch.data import cache as pcache
from music_transcription_tpu_torch.models.transcription import TranscriptionModel
from music_transcription_tpu_torch.models.transformer import encoder_state_dict
from tests.ast_parity import jax_train_ast_script
from tests.maestro_fixture import make_maestro_root

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENC = ["--encoder_layers", "1", "--encoder_dim", "32", "--encoder_heads", "2",
       "--encoder_n_mels", "32"]
TINY = ["--chunk_length", "2.0", "--batch_size", "2", "--max_token_len", "32",
        "--decoder_layers", "1", "--decoder_dim", "32", "--decoder_heads", "2",
        "--no-sanity_checks"]


@pytest.fixture(autouse=True)
def _keep_sigterm():
    # main() routes SIGTERM through KeyboardInterrupt; give this process its own back
    saved = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, saved)


@pytest.fixture(scope="module")
def jax_script():
    return jax_train_ast_script()


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return str(make_maestro_root(tmp_path_factory.mktemp("train_ast_cli") / "maestro"))


def _main(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = train_ast.main(argv)
    return rc, out.getvalue()


def _exit_message(main, argv) -> str:
    with pytest.raises(SystemExit) as e, contextlib.redirect_stdout(io.StringIO()):
        main(argv)
    return str(e.value.code)


def _env():
    # a tiny model: two threads a subprocess, so that parallel test workers
    # are not oversubscribed
    return dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")


def _cli(*args, timeout=300):
    env = _env()
    return subprocess.run([sys.executable, "-m", *args], capture_output=True, text=True,
                          cwd=REPO, env=env, timeout=timeout)


def _log_numbers(path) -> list[float]:
    with open(path) as f:
        return [float(v) for v in re.findall(r"=(-?[\d.]+|nan|inf)", f.read())]


# ------------------------------------------------------------------ parser

def test_parser_matches_jax_apart_from_device(jax_script):
    """Every option string, default, type, choice and action of the JAX
    script; --device takes cuda|cpu (default cuda, -d alias) where JAX's
    takes cpu|tpu."""
    def actions(parser):
        return {a.dest: a for a in parser._actions if a.dest != "help"}

    ours, theirs = actions(train_ast.build_parser()), actions(jax_script.build_parser())
    assert sorted(ours) == sorted(theirs)
    for dest, a in theirs.items():
        b = ours[dest]
        if dest == "device":
            assert (b.option_strings, b.default, b.choices) == (["--device", "-d"], "cuda",
                                                                 ["cuda", "cpu"])
            continue
        assert b.option_strings == a.option_strings, dest
        assert (b.default, b.type, b.choices, b.nargs, type(b)) == (
            a.default, a.type, a.choices, a.nargs, type(a)), dest
    assert len(theirs) == 46


# ------------------------------------------------------- guards and refusals

GUARDS = {
    "save_best_every without val_split": ["--save_best_every", "5"],
    "val_note_f1_every without val_split": ["--val_note_f1_every", "1"],
    "note_f1 without val_note_f1_every": ["--val_split", "validation", "--best_metric",
                                          "note_f1"],
    "val_note_f1_every with pretrain_frames": ["--pretrain_frames", "--val_split",
                                               "validation", "--val_note_f1_every", "1"],
}


@pytest.mark.parametrize("name", list(GUARDS))
def test_flag_guards_give_jax_messages(jax_script, root, name):
    argv = ["--root_dir", root, *GUARDS[name]]
    ours = _exit_message(train_ast.main, argv + ["-d", "cpu"])
    assert ours.startswith("Error: --")
    assert ours == _exit_message(jax_script.main, argv + ["--device", "cpu"])


def test_no_card_exits_1(root):
    rc, out = _main(["--root_dir", root, "--epochs", "1", *TINY])
    assert not torch.cuda.is_available()
    assert rc == 1 and "CUDA is not available" in out


def _cache(path, split, meta, n=4):
    rng = np.random.default_rng(0)
    for i in range(n):
        arrays = {"roll": np.zeros((88, 62), np.float32)}
        if meta.get("return_waveform") or meta.get("tokenize"):
            arrays["waveform"] = (0.1 * rng.standard_normal(32000)).astype(np.float32)
        else:
            arrays["mel"] = rng.standard_normal((32, 62)).astype(np.float32)
        if meta.get("tokenize"):
            arrays["tokens"] = np.zeros(32, np.int64)
        pcache.save_chunk(os.path.join(path, split), i, arrays)
    pcache.save_metadata(path, split, {"num_chunks": n, "chunk_length": 2.0, "overlap": 0.0,
                                       "sr": 16000, "hop_length": 512, **meta})  # meta wins


REFUSALS = {
    "mel cache (train)": (dict(split="train"), [], "holds mel features"),
    "mel cache (validation)": (dict(split="validation"), ["--val_split", "validation"],
                               "(split 'validation') holds mel features"),
    "chunk length": (dict(split="train", return_waveform=True, chunk_length=1.0), [],
                     "chunk_length=1.0s does not match --chunk_length 2.0"),
    "tokens for the event vocabulary": (dict(split="train", tokenize=True,
                                             return_waveform=True),
                                        ["--tokenizer", "event"], "REMI-encoded"),
    "validation under a batch": (None, ["--val_split", "validation", "--batch_size", "64"],
                                 "validation would see zero batches"),
    "pretraining on mel": (dict(split="train"), ["--pretrain_frames"], "has no waveforms"),
    "pretraining chunk length": (dict(split="train", return_waveform=True, chunk_length=1.0),
                                 ["--pretrain_frames"], "chunk_length=1.0s != --chunk_length"),
    "pretraining validation under a batch": (None, ["--pretrain_frames", "--val_split",
                                                    "validation", "--batch_size", "64"],
                                             "chunks < batch_size 64"),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_cache_and_split_refusals(root, tmp_path, name):
    meta, extra, message = REFUSALS[name]
    argv = ["--root_dir", root, "--run_dir", str(tmp_path / "run"), "-d", "cpu", "--epochs",
            "1", "--mock_encoder", *TINY, *ENC, *extra]
    if meta is not None:
        meta = dict(meta)
        split = meta.pop("split")
        cache = str(tmp_path / "cache")
        _cache(cache, split, meta)
        argv += ["--cache_dir", cache]
    text = _exit_message(train_ast.main, argv)
    assert text.startswith("Error: ") and message in text, text
    assert not os.path.exists(tmp_path / "run" / "model_final.pth")


def test_token_range_is_checked_once_when_staged(root, tmp_path, monkeypatch):
    """The JAX loop's ValueError on an out-of-range token id
    (scripts/train_ast.py:887-893), raised before any step: for the staged
    split at staging, on the host."""
    from music_transcription_tpu_torch.train import ast_step

    steps = []
    monkeypatch.setattr(ast_step, "token_step", lambda *a, **k: steps.append(1))
    cache = str(tmp_path / "tokens")
    _cache(cache, "train", {"tokenize": True, "return_waveform": True})
    bad = pcache.load_chunk(os.path.join(cache, "train"), 2)
    bad["tokens"][5] = 600
    pcache.save_chunk(os.path.join(cache, "train"), 2, bad)
    for data in ("on", "off"):
        with pytest.raises(ValueError, match="Token id out of range: min=0, max=600, vocab=512"):
            _main(["--root_dir", root, "--cache_dir", cache, "--run_dir", str(tmp_path / data),
                   "-d", "cpu", "--mock_encoder", "--device_data", data, "--epochs", "1",
                   *TINY, "--batch_size", "4"])
    assert steps == []


# --------------------------------------------------------- the CLI, end to end

@pytest.fixture(scope="module")
def flow(root, tmp_path_factory):
    """Pretraining (2 epochs, validation) then the token model on its
    model_best with --freeze_encoder, scheduled sampling ramped over 2
    epochs, a pitch weight of 3 and note-F1 selection flushed every epoch,
    each in a subprocess of the port."""
    tmp = tmp_path_factory.mktemp("flow")
    pre = _cli("music_transcription_tpu_torch.train_ast", "--root_dir", root,
               "--pretrain_frames", "--epochs", "2", "--val_split", "validation",
               "--val_batches", "1", "--run_dir", str(tmp / "pre"), "-d", "cpu", *TINY, *ENC)
    assert pre.returncode == 0, pre.stdout[-3000:] + pre.stderr[-3000:]
    ast = _cli("music_transcription_tpu_torch.train_ast", "--root_dir", root,
               "--encoder_init", str(tmp / "pre" / "model_best.pth"), "--freeze_encoder",
               "--scheduled_sampling", "0.5", "--ss_ramp_epochs", "2",
               "--pitch_loss_weight", "3", "--epochs", "2", "--val_split", "validation",
               "--val_batches", "1", "--val_note_f1_every", "1", "--val_note_f1_batches", "1",
               "--best_metric", "note_f1", "--save_best_every", "1",
               "--run_dir", str(tmp / "ast"), "-d", "cpu", *TINY, *ENC)
    assert ast.returncode == 0, ast.stdout[-3000:] + ast.stderr[-3000:]
    return dict(tmp=tmp, pre=pre.stdout, ast=ast.stdout)


def test_pretrain_then_frozen_transplant_then_evaluate_ast(flow, root):
    tmp = flow["tmp"]
    pre_log = (tmp / "pre" / "training_log.txt").read_text().splitlines()
    assert len(pre_log) == 2 and all("val_frame_f1=" in line for line in pre_log)
    log = (tmp / "ast" / "training_log.txt").read_text().splitlines()
    assert "ss_p=0.25" in log[0] and "ss_p=0.50" in log[1], log
    for path in (tmp / "pre" / "training_log.txt", tmp / "ast" / "training_log.txt"):
        assert all(math.isfinite(v) for v in _log_numbers(path))
    assert "Initialized encoder from" in flow["ast"] and "(frozen)" in flow["ast"]
    with open(tmp / "pre" / "model_best.json") as f:
        assert set(json.load(f)) == {"pretrain_encoder", "audio"}
    with open(tmp / "ast" / "model_final.json") as f:
        sidecar = json.load(f)
    assert set(sidecar) == {"model", "audio"} and sidecar["model"]["freeze_encoder"]

    # the encoder bit for bit the pretrained one; the decoder trained away from its seeded init
    pre = torch.load(tmp / "pre" / "model_best.pth")
    final = torch.load(tmp / "ast" / "model_final.pth")
    enc = encoder_state_dict(final)
    assert enc and all(torch.equal(v, pre[k]) for k, v in enc.items())
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        init = TranscriptionModel(config_from_dict(ModelConfig, sidecar["model"])).model
    dec = [k for k in final if k.startswith(("dec", "token_emb", "output_fc", "enc_to_dec"))]
    assert all(not torch.equal(final[k], init.state_dict()[k]) for k in dec
               if final[k].dtype.is_floating_point and "k.bias" not in k)

    from music_transcription_tpu_torch import evaluate_ast

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = evaluate_ast.main(["--model", str(tmp / "ast" / "model_best.pth"), "--root_dir",
                                root, "--split", "validation", "--max_len", "32", "--headless",
                                "-d", "cpu"])
    f1 = [float(line.split("=")[1]) for line in out.getvalue().splitlines()
          if line.startswith("EVAL_AST_NOTE_F1=")]
    assert rc == 0 and len(f1) == 1 and 0.0 <= f1[0] <= 1.0, out.getvalue()[-2000:]


def test_resume_loads_the_weights_and_trains_staged_compact(flow, root, tmp_path):
    """--resume reads a model_final.pth (the weights; Adam starts cold), here
    through --device_data on --compact_data with real steps; a pretraining
    checkpoint does not load into the token model."""
    final = str(flow["tmp"] / "ast" / "model_final.pth")
    rc, out = _main(["--root_dir", root, "--resume", final, "--epochs", "1", "--device_data",
                     "on", "--compact_data", "--run_dir", str(tmp_path / "r"), "-d", "cpu",
                     *TINY, *ENC])
    assert rc == 0 and f"Resumed params from {final}" in out
    assert "Staging 5 items" in out
    assert all(math.isfinite(v) for v in _log_numbers(tmp_path / "r" / "training_log.txt"))
    with pytest.raises(RuntimeError, match="Missing key"):
        _main(["--root_dir", root, "--resume", str(flow["tmp"] / "pre" / "model_best.pth"),
               "--epochs", "1", "--run_dir", str(tmp_path / "bad"), "-d", "cpu", *TINY, *ENC])


def test_note_f1_selection_keeps_a_copy_of_the_best_state(flow):
    """--best_metric note_f1 with --save_best_every 1: model_best is written
    during the run, before the exit's model_final, and holds the best
    epoch's weights, not the final ones."""
    run, out = flow["tmp"] / "ast", flow["ast"]
    log = (run / "training_log.txt").read_text().splitlines()
    assert len(log) == 2 and all("val_note_f1=" in line for line in log), log
    best = re.search(r"Best val_note_f1 ([\d.]+) at epoch (\d)", out)
    assert best and int(best.group(2)) == 1, out[-2000:]
    assert 0 <= out.find(f"Saved {run / 'model_best.pth'}") < out.find(
        f"Saved {run / 'model_final.pth'}")
    b, f = torch.load(run / "model_best.pth"), torch.load(run / "model_final.pth")
    assert sorted(b) == sorted(f) and any(not torch.equal(b[k], f[k]) for k in f)


def test_sigterm_flushes_model_best(root, tmp_path):
    run = tmp_path / "run"
    env = _env()
    proc = subprocess.Popen(
        [sys.executable, "-m", "music_transcription_tpu_torch.train_ast", "--root_dir", root,
         "--pretrain_frames", "--epochs", "10000", "--val_split", "validation",
         "--val_batches", "1", "--run_dir", str(run), "-d", "cpu", *TINY, *ENC],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO, env=env)
    log = run / "training_log.txt"
    deadline = time.time() + 120
    while time.time() < deadline and not (log.exists() and log.read_text()):
        time.sleep(0.5)
    assert log.exists(), "training never reached epoch 1"
    proc.send_signal(signal.SIGTERM)
    out, _ = proc.communicate(timeout=60)
    assert (run / "model_best.pth").exists() and (run / "model_best.json").exists(), out[-2000:]
    assert (run / "model_final.pth").exists(), out[-2000:]
