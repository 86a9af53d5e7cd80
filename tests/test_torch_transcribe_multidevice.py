"""PyTorch port: serving across devices, the counterpart of
tests/test_transcribe_e2e.py's sharded inference: 5 chunks split over
replicas on ``["cpu"] * 3`` and ``["cpu", "cpu"]`` (padded to 6, blocks of 2
or 3) give the one-device roll exactly, and the JAX package's
``transcribe_chunks`` on an 8-device mesh (padded to 8) gives the same roll
from the same weights; ``Transcriber(devices=...)`` and ``transcribe_audio``
serve a WAV through the replicas; an explicit list that names a card raises
without one, as ``resolve_device`` does."""

import json
import wave

import jax
import numpy as np
import pytest
import torch

from music_transcription_tpu import transcribe as JT
from music_transcription_tpu.config import AudioConfig as JAudioConfig
from music_transcription_tpu.config import ModelConfig as JModelConfig
from music_transcription_tpu.config import config_to_dict
from music_transcription_tpu.models.transcription import TranscriptionModel as JModel
from music_transcription_tpu.parallel.mesh import make_mesh
from music_transcription_tpu.train.checkpoints import save_checkpoint, save_torch_checkpoint
from music_transcription_tpu_torch import transcribe as T
from music_transcription_tpu_torch.data.midi import load_midi

THRESHOLD = 0.5


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A random small cnn_rnn_large, as an orbax checkpoint for JAX and as
    .pth + .json for the port, and 5 chunks of seeded audio."""
    d = tmp_path_factory.mktemp("multidevice")
    mcfg = JModelConfig(model_type="cnn_rnn_large", n_mels=32, hidden_size=16, num_layers=1,
                        compute_dtype="float32")
    acfg = JAudioConfig(n_mels=32, chunk_length=1.0)
    jm = JModel(mcfg)
    variables = jm.init(jax.random.key(3), jm.example_input(batch=1, t=8))
    sidecar = {"model": config_to_dict(mcfg), "audio": config_to_dict(acfg)}
    save_checkpoint(d / "orbax", dict(variables))
    (d / "orbax" / "config.json").write_text(json.dumps(sidecar))
    save_torch_checkpoint(str(d / "small.pth"), variables, mcfg)
    (d / "small.json").write_text(json.dumps(sidecar))
    rng = np.random.default_rng(0)
    t = np.arange(acfg.chunk_samples) / acfg.sample_rate
    tone = 0.3 * np.sin(2 * np.pi * 440.0 * t)
    chunks = (tone[None] * rng.random((5, 1)) + 0.05 * rng.standard_normal(
        (5, acfg.chunk_samples))).astype(np.float32)
    return dict(dir=d, pth=d / "small.pth", chunks=chunks)


@pytest.fixture(scope="module")
def one_device(ckpt):
    loaded = T.load_model(ckpt["pth"], device="cpu")
    return loaded, T.transcribe_chunks(loaded, ckpt["chunks"], threshold=THRESHOLD)


@pytest.mark.parametrize("n", [2, 3])
def test_replicas_give_the_one_device_roll(ckpt, one_device, n):
    loaded, single = one_device
    replicas = T.replicate_model(loaded.model, T.serving_devices(devices=["cpu"] * n))
    assert len(replicas) == n and replicas[0] is loaded.model
    assert all(r is not loaded.model for r in replicas[1:])
    got = T.transcribe_chunks(loaded, ckpt["chunks"], threshold=THRESHOLD, replicas=replicas)
    assert got.shape == single.shape == (88, 5 * loaded.audio_cfg.mel_frames_per_chunk)
    assert np.array_equal(got, single)
    # overlapped chunks stitch the replicas' rolls as one device's
    hop = loaded.audio_cfg.mel_frames_per_chunk // 2
    assert np.array_equal(
        T.transcribe_chunks(loaded, ckpt["chunks"], threshold=THRESHOLD, hop_frames=hop,
                            replicas=replicas),
        T.transcribe_chunks(loaded, ckpt["chunks"], threshold=THRESHOLD, hop_frames=hop))


def test_replicas_match_jax_on_an_8_device_mesh(ckpt, one_device):
    loaded, single = one_device
    jloaded = JT.load_model(str(ckpt["dir"] / "orbax"))
    ref = JT.transcribe_chunks(jloaded, ckpt["chunks"], threshold=THRESHOLD, mesh=make_mesh(8))
    replicas = T.replicate_model(loaded.model, T.serving_devices(devices=["cpu"] * 2))
    got = T.transcribe_chunks(loaded, ckpt["chunks"], threshold=THRESHOLD, replicas=replicas)
    assert ref.shape == got.shape and ref.sum() > 0, "the comparison needs notes"
    assert np.array_equal(got, np.asarray(ref))
    assert np.array_equal(single, np.asarray(ref))


def test_transcriber_serves_a_wav_on_replicas(ckpt, tmp_path):
    sr = 16000
    y = np.concatenate(list(ckpt["chunks"]))
    wav = tmp_path / "a.wav"
    with wave.open(str(wav), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(y, -1, 1) * 32767).astype("<i2").tobytes())
    server = T.Transcriber(ckpt["pth"], device="cpu", devices=["cpu", "cpu", "cpu"])
    assert len(server.replicas) == 3 and server.devices == [torch.device("cpu")] * 3
    one = T.Transcriber(ckpt["pth"], device="cpu")
    assert len(one.replicas) == 1 and one.devices == [torch.device("cpu")]
    got = server.transcribe_file(wav, tmp_path / "replicas.mid")
    want = one.transcribe_file(wav, tmp_path / "one.mid")
    spans = [[(n.pitch, n.start, n.end) for n in load_midi(p).instruments[0].notes]
             for p in (got, want)]
    assert spans[0] == spans[1] and spans[0], "the comparison needs notes"
    out = T.transcribe_audio(wav, ckpt["pth"], tmp_path / "cli.mid", verbose=False,
                             device="cpu", devices=["cpu", "cpu"])
    assert [(n.pitch, n.start, n.end) for n in load_midi(out).instruments[0].notes] == spans[1]


def test_a_device_list_naming_a_card_raises_without_one(ckpt, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.Transcriber(ckpt["pth"], device="cpu", devices=["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="devices is empty"):
        T.serving_devices(devices=[])
