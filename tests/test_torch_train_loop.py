"""PyTorch port: the training CLI (``python -m music_transcription_tpu_torch.train``)
and loop, on the CPU, on a tiny seeded cache (cnn_rnn_large, n_mels 16,
hidden 8, 1 s chunks).

Checked: the run's artifacts and profiler trace; that ``model_best`` holds
the best epoch's weights (its validation loss is the best one logged) at
either flush cadence, also after an abort, and serves through
``Transcriber``; ``--resume auto`` continuing from the newest epoch
checkpoint; training through slab rotation; the abort after too many skipped
steps; exit 67 at a tiny RSS watermark; exit 66 from the stall watchdog;
``--background``; the errors for a missing card and for the parallel
settings a one-process run cannot take.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from music_transcription_tpu_torch.config import AudioConfig
from music_transcription_tpu_torch.data import cache as C
from music_transcription_tpu_torch.train import __main__ as cli
from music_transcription_tpu_torch.train import loop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_MELS, CHUNK = 16, 1.0


@pytest.fixture(scope="module")
def cache_dir(tmp_path_factory):
    """6 train and 3 validation chunks of seeded mel and roll."""
    root = tmp_path_factory.mktemp("cache")
    acfg = AudioConfig(n_mels=N_MELS, chunk_length=CHUNK)
    t = acfg.mel_frames_per_chunk
    rng = np.random.default_rng(0)
    for split, n in (("train", 6), ("validation", 3)):
        for i in range(n):
            C.save_chunk(root / split, i, {
                "mel": (rng.standard_normal((N_MELS, t - i % 2)) * 10 - 40).astype(np.float32),
                "roll": (rng.random((88, t - i % 2)) > 0.9).astype(np.uint8)})
        C.save_metadata(root, split, {"num_chunks": n, "chunk_length": CHUNK, "overlap": 0.0,
                                      "n_mels": N_MELS, "sr": acfg.sample_rate,
                                      "hop_length": acfg.hop_length})
    return str(root)


@pytest.fixture
def in_process(monkeypatch):
    """main() in this process, leaving the test runner's SIGTERM handler alone."""
    monkeypatch.setattr(loop, "install_graceful_sigterm", lambda: None)


def _argv(cache_dir, run_dir, *extra):
    return ["--cache_dir", cache_dir, "--root_dir", os.path.join(cache_dir, "no_raw"),
            "--model_type", "cnn_rnn_large", "--n_mels", str(N_MELS), "--hidden_size", "8",
            "--num_layers", "2", "--chunk_length", str(CHUNK), "--batch_size", "2",
            "--lr", "1e-3", "--num_workers", "0", "-d", "cpu", "--run_dir", str(run_dir),
            *extra]


def _log_epochs(run_dir):
    with open(os.path.join(run_dir, "training_log.txt")) as f:
        rows = [line.split() for line in f if line.strip()]
    return [(int(r[1]), float(r[3].split("=")[1])) for r in rows]


@pytest.mark.parametrize("save_best_every", [1, 3])
def test_cli_trains_and_writes_artifacts(cache_dir, tmp_path, in_process, save_best_every):
    run = tmp_path / "run"
    assert cli.main(_argv(cache_dir, run, "--epochs", "3", "--save_every", "2",
                          "--device_data", "on", "--profile_steps", "1",
                          "--save_best_every", str(save_best_every))) == 0
    names = set(os.listdir(run))
    assert {"parameters.json", "parameters.txt", "training_log.txt", "checkpoints"} <= names
    assert (run / "profile" / "trace.json").exists()
    ckpts = set(os.listdir(run / "checkpoints"))
    assert {"model_best.pth", "model_best.json", "model_epoch_2.pt", "model_epoch_2.json",
            "model_final.pt", "model_final.json"} <= ckpts
    assert "model_epoch_1.pt" not in ckpts and "model_epoch_3.pt" not in ckpts
    manifest = json.loads((run / "parameters.json").read_text())
    assert manifest["model"]["lstm_backend"] == "scan"  # auto on the CPU
    assert manifest["train"]["batch_size"] == 2 and manifest["devices"] == ["cpu"]
    epochs = _log_epochs(run)
    assert [e for e, _ in epochs] == [1, 2, 3]

    # model_best holds the best epoch, whatever the flush cadence: its step
    # (6 chunks / batch 2 = 3 steps per epoch, after the profiled step) and
    # its validation loss
    best_epoch, best_val = min(epochs, key=lambda e: e[1])
    sidecar = json.loads((run / "checkpoints" / "model_best.json").read_text())
    assert sidecar["step"] == 1 + 3 * best_epoch
    from music_transcription_tpu_torch.data.cache import HybridMaestroDataset
    from music_transcription_tpu_torch.data.pipeline import Loader
    from music_transcription_tpu_torch.transcribe import Transcriber, load_model

    loaded = load_model(run / "checkpoints" / "model_best.pth", device="cpu")
    acfg = loaded.audio_cfg
    assert (acfg.n_mels, acfg.chunk_length) == (N_MELS, CHUNK)
    val = HybridMaestroDataset(cache_dir, cache_dir, "validation", chunk_length=CHUNK,
                               verbose=False)
    val_loss = loop.evaluate(loaded.model, Loader(val, 2, num_workers=0,
                                                  pad_to=acfg.mel_frames_per_chunk,
                                                  pad_last_batch=True))
    assert abs(val_loss - best_val) <= 1e-5
    # it serves: a short waveform through the port's Transcriber
    server = Transcriber(run / "checkpoints" / "model_best.pth", device="cpu")
    roll = server.transcribe_array(np.zeros(int(1.5 * acfg.sample_rate), np.float32))
    assert roll is not None


def test_cli_trains_through_slab_rotation(cache_dir, tmp_path, in_process, monkeypatch):
    """--device_data slab on the CPU: 6 train chunks of 3,844 staged bytes
    (bf16 mel, uint8 roll, lengths) in slabs of 10 kB: 3 slabs of 2, one step
    each; validation staged whole."""
    from music_transcription_tpu_torch.data import pipeline

    made = []

    class Recorded(pipeline.SlabRotatingLoader):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    monkeypatch.setattr(pipeline, "SlabRotatingLoader", Recorded)
    run = tmp_path / "run"
    assert cli.main(_argv(cache_dir, run, "--epochs", "2", "--device_data", "slab",
                          "--slab_gb", "1e-5")) == 0
    (loader,) = made
    assert (loader.item_bytes, loader.n_slabs, loader.items_per_slab, len(loader)) == (
        3844, 3, 2, 3)
    assert [s["items"] for s in loader.stage_log] == [2] * 6  # 3 slabs in each epoch
    assert torch.load(run / "checkpoints" / "model_final.pt")["step"] == 6
    epochs = _log_epochs(run)
    assert [e for e, _ in epochs] == [1, 2] and all(np.isfinite(v) for _, v in epochs)


def test_resume_auto_continues_from_the_newest_epoch(cache_dir, tmp_path, in_process, capsys):
    run = tmp_path / "run"
    argv = _argv(cache_dir, run, "--save_every", "1", "--resume", "auto")
    assert cli.main(argv + ["--epochs", "2"]) == 0
    step_2 = torch.load(run / "checkpoints" / "model_epoch_2.pt")["step"]
    assert step_2 == 6
    capsys.readouterr()
    assert cli.main(argv + ["--epochs", "3"]) == 0
    out = capsys.readouterr().out
    assert "model_epoch_2.pt" in out and "Resuming from epoch 2; starting at 3" in out
    assert [e for e, _ in _log_epochs(run)] == [1, 2, 3]
    assert torch.load(run / "checkpoints" / "model_final.pt")["step"] == 9


def test_rss_watermark_exits_67_after_a_checkpoint(cache_dir, tmp_path, in_process):
    run = tmp_path / "run"
    argv = _argv(cache_dir, run, "--epochs", "3", "--save_every", "0", "--resume", "auto")
    assert cli.main(argv + ["--rss_watermark_gb", "0.001"]) == 67
    ckpts = os.listdir(run / "checkpoints")
    assert "model_epoch_1.pt" in ckpts and "model_final.pt" not in ckpts
    assert cli.main(argv) == 0  # the supervisor's rerun finishes epochs 2 and 3
    assert [e for e, _ in _log_epochs(run)] == [1, 2, 3]


def test_abort_flushes_the_retained_best_state(cache_dir, tmp_path, in_process, monkeypatch):
    """An abort in epoch 3 (NaN abort, Ctrl-C, SIGTERM) still writes the best
    of epochs 1-2, held back by the flush cadence; no model_final."""
    real_epoch, calls = loop.train_one_epoch, []

    def aborting(*args, **kwargs):
        calls.append(1)
        if len(calls) == 3:
            raise loop.TrainingUnstableError("abort")
        return real_epoch(*args, **kwargs)

    monkeypatch.setattr(loop, "train_one_epoch", aborting)
    run = tmp_path / "run"
    with pytest.raises(loop.TrainingUnstableError):
        cli.main(_argv(cache_dir, run, "--epochs", "5", "--save_every", "0",
                       "--save_best_every", "100"))
    epochs = _log_epochs(run)
    best_epoch = min(epochs, key=lambda e: e[1])[0]
    sidecar = json.loads((run / "checkpoints" / "model_best.json").read_text())
    assert len(epochs) == 2 and sidecar["step"] == 3 * best_epoch
    assert not (run / "checkpoints" / "model_final.pt").exists()


def test_too_many_skipped_steps_abort(cache_dir):
    from music_transcription_tpu_torch.config import ModelConfig, TrainConfig
    from music_transcription_tpu_torch.parallel.train_step import init_train_state

    state = init_train_state(ModelConfig(n_mels=N_MELS, hidden_size=8, num_layers=1),
                             TrainConfig(), "cpu")
    t = AudioConfig(n_mels=N_MELS, chunk_length=CHUNK).mel_frames_per_chunk
    mel = np.full((2, 1, N_MELS, t), np.nan, np.float32)
    batch = (mel, np.zeros((2, 88, t), np.float32), np.array([t, t], np.int32))
    with pytest.raises(loop.TrainingUnstableError):
        loop.train_one_epoch(state, [batch, batch], dropout_seed=1, max_grad_norm=1.0,
                             max_nan=1, verbose=False)
    assert state.step == 2  # both steps counted, neither applied


def test_background_run_detaches_and_trains(cache_dir, tmp_path):
    run = tmp_path / "run"
    proc = subprocess.run([sys.executable, "-m", "music_transcription_tpu_torch.train",
                           *_argv(cache_dir, run, "--epochs", "1", "--background")],
                          capture_output=True, text=True, cwd=REPO, timeout=120)
    assert proc.returncode == 0 and "Training started in background" in proc.stdout
    pid = int(proc.stdout.split("(pid ")[1].split(")")[0])
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            break
        time.sleep(0.5)
    assert (run / "checkpoints" / "model_final.pt").exists(), (run / "train.log").read_text()
    assert "Training complete" in (run / "train.log").read_text()


def test_stall_watchdog_exits_66(cache_dir, tmp_path):
    """A train step that hangs: the watchdog ends the process with 66."""
    code = ("import sys, time\n"
            "from music_transcription_tpu_torch.train import loop, __main__ as cli\n"
            "loop.train_step = lambda *a, **k: time.sleep(60)\n"
            "sys.exit(cli.main(sys.argv[1:]))\n")
    proc = subprocess.run(
        [sys.executable, "-c", code] + _argv(cache_dir, tmp_path / "run", "--epochs", "1",
                                             "--stall_timeout", "1"),
        capture_output=True, text=True, cwd=REPO, timeout=120)
    assert proc.returncode == 66, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "stall-watchdog" in proc.stderr


def test_refusals(cache_dir, tmp_path, in_process):
    # no card: the module entry point exits 1 and says why
    if not torch.cuda.is_available():
        proc = subprocess.run([sys.executable, "-m", "music_transcription_tpu_torch.train",
                               "--run_dir", str(tmp_path / "x")],
                              capture_output=True, text=True, cwd=REPO, timeout=120)
        assert proc.returncode == 1 and "CUDA is not available" in proc.stdout
    # in a one-process run: more ranks than were launched, and state
    # sharding with nothing to shard over, as the JAX package says
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        cli.main(_argv(cache_dir, tmp_path / "dp", "--data_parallel", "2"))
    for how in ("zero1", "fsdp"):
        with pytest.raises(ValueError, match="resolved to a single device"):
            cli.main(_argv(cache_dir, tmp_path / how, "--partitioning", how))
    # the 2-D mesh and tensor parallelism wait for slice 5b
    with pytest.raises(NotImplementedError, match="slice 5b"):
        cli.main(_argv(cache_dir, tmp_path / "tp", "--partitioning", "tp"))
    with pytest.raises(NotImplementedError, match="slice 5b"):
        cli.main(_argv(cache_dir, tmp_path / "mp", "--model_parallel", "2",
                       "--partitioning", "fsdp"))
    # model_parallel with replicated state only repeats work: JAX's refusal
    with pytest.raises(ValueError, match="would replicate all work"):
        cli.main(_argv(cache_dir, tmp_path / "mp_dp", "--model_parallel", "2"))
