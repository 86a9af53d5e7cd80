"""PyTorch port: its workflow script ``music_transcription_tpu_torch/example.sh``
on the CPU (``DEVICE=cpu``).

Checked: the ``ast`` mode end to end at the JAX example test's settings
(cache -> encoder pretraining -> decoder training on the frozen encoder ->
note-level evaluation); the ``eval`` mode on a tiny trained run, whose
``EVAL_MEAN_F1`` equals the evaluation CLI's for the same checkpoint and
flags; ``latest_checkpoint`` takes the newest run's ``model_best.pth`` over
its ``model_final.pt``; the usage message.
"""

import os
import subprocess

import numpy as np
import pytest

from music_transcription_tpu_torch import evaluate as eval_cli
from music_transcription_tpu_torch.config import AudioConfig
from music_transcription_tpu_torch.data import cache as C
from music_transcription_tpu_torch.train import __main__ as train_cli
from music_transcription_tpu_torch.train import loop
from tests.maestro_fixture import make_maestro_root

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "music_transcription_tpu_torch", "example.sh")


def _run(mode, env, cwd, timeout=600):
    """The script's ``mode``; its CLIs with one intra-op thread each, since
    the test processes share the CPU."""
    return subprocess.run(["bash", SCRIPT, *([mode] if mode else [])],
                          env=dict(os.environ, OMP_NUM_THREADS="1", **env),
                          capture_output=True, text=True, timeout=timeout, cwd=str(cwd))


def test_ast_mode_runs_the_recipe(tmp_path):
    root = make_maestro_root(tmp_path / "maestro")
    proc = _run("ast", dict(
        ROOT_DIR=str(root),
        AST_CACHE_DIR=str(tmp_path / "cache"),
        AST_CHUNK_LENGTH="2.0",
        AST_PRETRAIN_EPOCHS="1",
        AST_EPOCHS="1",
        AST_BATCH_SIZE="2",
        AST_OUT=str(tmp_path / "out"),
        DEVICE="cpu",
        NUM_WORKERS="1",
        EVAL_SPLIT="validation",  # the fixture has no test pieces
        AST_EXTRA_ARGS=("--encoder_layers 1 --encoder_dim 32 --encoder_heads 2 "
                        "--encoder_n_mels 32 --decoder_layers 1 --decoder_dim 32 "
                        "--decoder_heads 2 --max_token_len 32 --no-sanity_checks"),
    ), tmp_path)
    assert proc.returncode == 0, f"{proc.stdout[-3000:]}{proc.stderr[-2000:]}"
    out = proc.stdout
    assert "EVAL_AST_NOTE_F1=" in out
    assert (tmp_path / "out" / "pretrain" / "model_best.pth").exists()
    assert (tmp_path / "out" / "decoder" / "model_best.pth").exists()
    # the decoder stage really transplanted the pretrained encoder
    assert "Initialized encoder" in out and "frozen" in out


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A cache of 6 train and 3 validation chunks (n_mels 16, 1 s) and a
    2-epoch run of a tiny cnn_rnn_large on it under ``outputs/``."""
    base = tmp_path_factory.mktemp("flow")
    cache = base / "cache"
    acfg = AudioConfig(n_mels=16, chunk_length=1.0)
    t = acfg.mel_frames_per_chunk
    rng = np.random.default_rng(0)
    for split, n in (("train", 6), ("validation", 3)):
        for i in range(n):
            C.save_chunk(cache / split, i, {
                "mel": (rng.standard_normal((16, t)) * 10 - 40).astype(np.float32),
                "roll": (rng.random((88, t)) > 0.9).astype(np.uint8)})
        C.save_metadata(cache, split, {"num_chunks": n, "chunk_length": 1.0, "overlap": 0.0,
                                       "n_mels": 16, "sr": acfg.sample_rate,
                                       "hop_length": acfg.hop_length})
    run = base / "outputs" / "run1"
    mp = pytest.MonkeyPatch()
    mp.setattr(loop, "install_graceful_sigterm", lambda: None)
    try:
        assert train_cli.main([
            "--cache_dir", str(cache), "--root_dir", str(base / "no_raw"), "--n_mels", "16",
            "--hidden_size", "8", "--num_layers", "1", "--chunk_length", "1.0",
            "--batch_size", "2", "--epochs", "2", "--num_workers", "0", "-d", "cpu",
            "--run_dir", str(run)]) == 0
    finally:
        mp.undo()
    return base, cache, run


def test_eval_mode_scores_the_latest_run_as_the_cli_does(trained, capsys):
    base, cache, run = trained
    proc = _run("eval", dict(OUT_ROOT=str(base / "outputs"), CACHE_DIR=str(cache),
                             ROOT_DIR=str(base / "no_raw"), EVAL_SPLIT="validation",
                             DEVICE="cpu", EVAL_EXTRA_ARGS="--headless"), base)
    assert proc.returncode == 0, f"{proc.stdout[-3000:]}{proc.stderr[-2000:]}"
    best = run / "checkpoints" / "model_best.pth"
    assert f"=== Evaluating {best} on split 'validation'" in proc.stdout
    flow = [ln for ln in proc.stdout.splitlines() if ln.startswith("EVAL_")]
    assert eval_cli.main(["--model", str(best), "--split", "validation", "--cache_dir",
                          str(cache), "--root_dir", str(base / "no_raw"), "--tune_threshold",
                          "--device", "cpu", "--headless"]) == 0
    cli = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("EVAL_")]
    assert any(ln.startswith("EVAL_MEAN_F1=") for ln in flow) and flow == cli


def _latest(out_root):
    return subprocess.run(["bash", "-c", f'source "{SCRIPT}"; latest_checkpoint'],
                          env=dict(os.environ, OUT_ROOT=str(out_root)),
                          capture_output=True, text=True, timeout=60)


def test_latest_checkpoint_prefers_model_best_of_the_newest_run(tmp_path):
    assert _latest(tmp_path).returncode == 1  # no run yet
    old, new = tmp_path / "2026-01-01_00-00-00", tmp_path / "2026-01-02_00-00-00"
    for run in (old, new):
        (run / "checkpoints").mkdir(parents=True)
        (run / "checkpoints" / "model_final.pt").write_bytes(b"")
    (old / "checkpoints" / "model_best.pth").write_bytes(b"")
    os.utime(old, (1, 1))  # the older run by mtime, as ls -t orders them
    proc = _latest(tmp_path)
    assert (proc.returncode, proc.stdout.strip()) == (0, f"{new}/checkpoints/model_final.pt")
    (new / "checkpoints" / "model_best.pth").write_bytes(b"")
    os.utime(old, (1, 1))
    proc = _latest(tmp_path)
    assert (proc.returncode, proc.stdout.strip()) == (0, f"{new}/checkpoints/model_best.pth")


def test_no_mode_prints_the_usage(tmp_path):
    proc = _run(None, {}, tmp_path, timeout=60)
    assert proc.returncode == 1 and proc.stdout.startswith("Usage: ")
    assert "{preprocess|train|eval|ast|all}" in proc.stdout
