"""The hFT-Transformer's data and training CLI path in the port, on the CPU:
velocity rolls from MIDI, the dataset, preprocessing and staging (0-127
kept exactly), the training CLI at hop 256 on overlapped 3.072 s segments
from a velocity cache, and the checkpoint's sidecar read back."""

import csv
import json
import os
import wave

import numpy as np
import pytest
import torch

from music_transcription_tpu_torch.config import (AudioConfig, ModelConfig, config_from_dict,
                                                  config_to_dict)
from music_transcription_tpu_torch.data import cache as C
from music_transcription_tpu_torch.data import midi as M
from music_transcription_tpu_torch.data.maestro import MaestroDataset
from music_transcription_tpu_torch.data.pipeline import DeviceStagedLoader, Loader
from music_transcription_tpu_torch.data.preprocess import preprocess_split
from music_transcription_tpu_torch.train import __main__ as cli
from music_transcription_tpu_torch.train import loop

# segments of 192 frames at hop 256 overlapping by a third, the margins' 1.024 s
N_MELS, SEGMENT, OVERLAP = 16, 3.072, 1 / 3
ACFG = AudioConfig(n_mels=N_MELS, hop_length=256, chunk_length=SEGMENT)
# (split, seconds, notes (pitch, start, end, velocity))
PIECES = [("train", 7.0, [(60, 0.5, 1.5, 90), (64, 2.0, 3.2, 33), (72, 4.0, 6.5, 127)]),
          ("train", 6.5, [(48, 0.2, 5.0, 1), (52, 1.0, 2.0, 64)]),
          ("validation", 4.0, [(55, 1.0, 2.0, 100)])]


def _write_wav(path, y, sr=16000):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(y, -1, 1) * 32767).astype("<i2").tobytes())


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A MAESTRO-like tree: tones under notes of several velocities."""
    root = str(tmp_path_factory.mktemp("maestro_v"))
    rows = []
    for i, (split, dur, notes) in enumerate(PIECES):
        t = np.arange(int(dur * 16000)) / 16000
        y = sum(v / 400 * np.sin(2 * np.pi * 440 * 2 ** ((p - 69) / 12) * t) * ((t >= s) & (t < e))
                for p, s, e, v in notes)
        _write_wav(os.path.join(root, f"2018/p{i}.wav"), y)
        M.save_midi(M.notes_to_midi([M.Note(p, s, e, v) for p, s, e, v in notes]),
                    os.path.join(root, f"2018/p{i}.midi"))
        rows.append({"split": split, "year": 2018, "midi_filename": f"2018/p{i}.midi",
                     "audio_filename": f"2018/p{i}.wav", "duration": dur})
    with open(os.path.join(root, "maestro-v3.0.0.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    return root


def test_keys_roll_keeps_velocities():
    midi = M.notes_to_midi([M.Note(60, 0.0, 1.0, 90), M.Note(62, 0.5, 1.0, 1),
                            M.Note(64, 0.0, 1.0, 100), M.Note(64, 0.5, 1.0, 60)])
    roll = midi.keys_roll(fs=10.0, velocity=True)
    binary = midi.keys_roll(fs=10.0)
    assert np.array_equal(roll > 0, binary > 0) and roll.dtype == np.float32
    assert set(roll[60 - 21]) == {90.0} and set(roll[62 - 21, 5:]) == {1.0}
    assert roll[64 - 21, :5].tolist() == [100.0] * 5
    assert roll[64 - 21, 5:].tolist() == [127.0] * 5  # two notes summed, held at 127


def test_dataset_and_preprocessing_keep_velocities(root, tmp_path):
    plain = MaestroDataset(root, split="train", audio_cfg=ACFG, chunk_length=SEGMENT)
    ds = MaestroDataset(root, split="train", audio_cfg=ACFG, chunk_length=SEGMENT,
                        velocity=True)
    assert len(ds) == len(plain) > 0
    seen = set()
    for i in range(len(ds)):
        (mel, roll), (mel0, roll0) = ds[i], plain[i]
        assert np.array_equal(mel, mel0) and np.array_equal(roll > 0, roll0 > 0)
        assert roll.shape[-1] <= 192 and np.array_equal(roll, np.rint(roll))
        seen |= set(np.unique(roll).tolist())
    assert seen == {0.0, 1.0, 33.0, 64.0, 90.0, 127.0}
    cache = str(tmp_path / "cache")
    stats = preprocess_split(root_dir=root, cache_dir=cache, split="train", audio_cfg=ACFG,
                             chunk_length=SEGMENT, device="cpu", verbose=False, compact=True,
                             velocity=True)
    assert stats["failed"] == 0 and C.load_metadata(cache, "train")["velocity"] is True
    with np.load(C.chunk_path(os.path.join(cache, "train"), 0)) as z:
        assert z["roll"].dtype == np.uint8  # whole numbers 0-127: exact
    for i in range(len(ds)):
        assert np.array_equal(C.load_chunk(os.path.join(cache, "train"), i)["roll"], ds[i][1])
    # a binary cache's metadata has no velocity key, as the JAX package writes it
    preprocess_split(root_dir=root, cache_dir=str(tmp_path / "binary"), split="train",
                     audio_cfg=ACFG, chunk_length=SEGMENT, device="cpu", verbose=False)
    assert "velocity" not in C.load_metadata(str(tmp_path / "binary"), "train")


def test_staging_keeps_velocities_and_refuses_fractions(root):
    ds = MaestroDataset(root, split="train", audio_cfg=ACFG, chunk_length=SEGMENT,
                        velocity=True)
    staged = DeviceStagedLoader(ds, 2, device="cpu", pad_to=192, num_workers=0,
                                bf16_fields=(0,), velocity_fields=(1,))
    assert staged.arrays[1].dtype == torch.uint8
    for a, b in zip(staged, Loader(ds, 2, pad_to=192, num_workers=0), strict=True):
        assert a[1].dtype == torch.float32 and torch.equal(a[1], torch.as_tensor(b[1]))

    class Halves:
        def __len__(self):
            return 2

        def __getitem__(self, i):
            return np.zeros((N_MELS, 4), np.float32), np.full((88, 4), 0.5, np.float32)

    with pytest.raises(ValueError, match="velocity"):
        DeviceStagedLoader(Halves(), 1, device="cpu", num_workers=0, velocity_fields=(1,))


@pytest.fixture(scope="module")
def velocity_cache(root, tmp_path_factory):
    """Both splits preprocessed at hop 256, 3.072 s segments overlapping by
    1.024 s (a third) in the training split, velocity rolls, compact."""
    cache = str(tmp_path_factory.mktemp("hft_cache"))
    for split, overlap in (("train", OVERLAP), ("validation", 0.0)):
        preprocess_split(root_dir=root, cache_dir=cache, split=split, audio_cfg=ACFG,
                         chunk_length=SEGMENT, overlap=overlap, device="cpu", verbose=False,
                         compact=True, velocity=True)
    return cache


def _argv(cache, run, *extra):
    return ["--cache_dir", cache, "--root_dir", os.path.join(cache, "no_raw"),
            "--model_type", "hft", "--n_mels", str(N_MELS), "--hidden_size", "16",
            "--num_layers", "2", "--num_attention_heads", "2",
            "--dropout", "0.1", "--chunk_length", str(SEGMENT), "--chunk_overlap",
            repr(OVERLAP), "--batch_size", "2", "--epochs", "2", "--lr", "1e-3",
            "--num_workers", "0", "-d", "cpu", "--run_dir", str(run), *extra]


def test_cli_trains_hft_on_a_velocity_cache(velocity_cache, tmp_path, monkeypatch):
    monkeypatch.setattr(loop, "install_graceful_sigterm", lambda: None)
    run = tmp_path / "run"
    assert cli.main(_argv(velocity_cache, run, "--device_data", "on")) == 0
    manifest = json.loads((run / "parameters.json").read_text())
    assert manifest["model"]["model_type"] == "hft" and manifest["audio"]["hop_length"] == 256
    assert manifest["train"]["chunk_overlap"] == OVERLAP
    # the sidecar round trip: the config back from its JSON, the weights into it
    from music_transcription_tpu_torch.transcribe import load_model

    sidecar = json.loads((run / "checkpoints" / "model_best.json").read_text())
    cfg = config_from_dict(ModelConfig, sidecar["model"])
    assert config_to_dict(cfg) == sidecar["model"] and cfg.is_hft and cfg.input_frames == 192
    loaded = load_model(run / "checkpoints" / "model_best.pth", device="cpu")
    assert loaded.model.config == cfg and loaded.audio_cfg.hop_length == 256
    mel = torch.from_numpy(C.load_chunk(os.path.join(velocity_cache, "validation"), 0)["mel"])
    out = loaded.model(mel[None, :, :192])
    assert out["velocity_time"].shape == (1, 88, 128, 128)
    assert loaded.model.predict(mel[None, :, :192]).shape == (1, 88, 128)


def test_cli_refuses_a_binary_cache_and_a_wrong_segment(root, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(loop, "install_graceful_sigterm", lambda: None)
    binary = str(tmp_path / "binary")
    for split, overlap in (("train", OVERLAP), ("validation", 0.0)):
        preprocess_split(root_dir=root, cache_dir=binary, split=split, audio_cfg=ACFG,
                         chunk_length=SEGMENT, overlap=overlap, device="cpu", verbose=False)
    assert cli.main(_argv(binary, tmp_path / "r1")) == 1
    assert "--velocity" in capsys.readouterr().out
    argv = _argv(binary, tmp_path / "r2")
    argv[argv.index("--chunk_length") + 1] = "3.0"
    assert cli.main(argv) == 1
    assert "segments of 192 frames" in capsys.readouterr().out
