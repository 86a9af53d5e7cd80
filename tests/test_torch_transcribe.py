"""PyTorch port: the serving path end to end on the CPU.

Golden test: ``assets/demo_checkpoint`` converted by the JAX package to
``.pth`` + ``.json``, transcribed by ``python -m music_transcription_tpu_torch
-d cpu``, must decode the fixture's notes (tolerances of
tests/test_golden_e2e.py) and the same notes as the JAX pipeline. The
overlap and long-window routes agree with the JAX Transcriber on a small
random model; entry points default to CUDA and raise without it.
"""

import json
import os
import shutil
import subprocess
import sys
import wave

import jax
import numpy as np
import pytest
import torch

from music_transcription_tpu.config import AudioConfig as JAudioConfig
from music_transcription_tpu.config import ModelConfig as JModelConfig
from music_transcription_tpu.config import config_to_dict
from music_transcription_tpu.data.midi import load_midi as j_load_midi
from music_transcription_tpu.models.transcription import TranscriptionModel as JModel
from music_transcription_tpu.train.checkpoints import load_checkpoint, save_torch_checkpoint
from music_transcription_tpu.transcribe import Transcriber as JTranscriber
from music_transcription_tpu.transcribe import stitch_rolls as j_stitch_rolls
from music_transcription_tpu.transcribe import transcribe_audio as j_transcribe_audio
from music_transcription_tpu_torch import __main__ as cli
from music_transcription_tpu_torch.data.midi import load_midi
from music_transcription_tpu_torch.transcribe import (
    Transcriber,
    load_model,
    stitch_rolls,
    transcribe_audio,
)
from tests.maestro_fixture import make_maestro_root

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "assets", "demo_checkpoint")


def _spans(notes):
    return [(n.pitch, n.start, n.end) for n in notes]


def _write_wav(path, y, sr=16000):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(y, -1, 1) * 32767).astype("<i2").tobytes())


@pytest.fixture(scope="module")
def demo_pth(tmp_path_factory):
    """The demo orbax checkpoint as .pth + .json, converted by the JAX package."""
    d = tmp_path_factory.mktemp("demo")
    with open(os.path.join(CKPT, "config.json")) as f:
        cfg = json.load(f)
    save_torch_checkpoint(str(d / "demo.pth"), load_checkpoint(CKPT), JModelConfig(**cfg["model"]))
    shutil.copy(os.path.join(CKPT, "config.json"), d / "demo.json")
    return d / "demo.pth"


def test_golden_cli_two_note_piece(tmp_path, demo_pth):
    root = make_maestro_root(tmp_path / "maestro")
    wav = os.path.join(root, "2017", "piece0.wav")
    out = tmp_path / "port.mid"
    proc = subprocess.run(
        [sys.executable, "-m", "music_transcription_tpu_torch", wav, str(demo_pth),
         "-d", "cpu", "-t", "0.35", "-o", str(out)],
        capture_output=True, text=True, cwd=REPO, timeout=600,
    )
    assert proc.returncode == 0, f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}"
    notes = load_midi(str(out)).instruments[0].notes
    # ground truth: 60 @ 0.5-1.5, 64 @ 2.0-3.0 (maestro_fixture.py specs)
    assert [n.pitch for n in notes] == [60, 64], notes
    want = {60: (0.5, 1.5), 64: (2.0, 3.0)}
    for n in notes:
        s, e = want[n.pitch]
        assert abs(n.start - s) <= 0.10, (n.pitch, n.start, s)
        assert abs(n.end - e) <= 0.15, (n.pitch, n.end, e)
    # the JAX pipeline behind main.py, on the orbax checkpoint itself
    j_transcribe_audio(wav, CKPT, str(tmp_path / "jax.mid"), threshold=0.35, verbose=False)
    assert _spans(notes) == _spans(j_load_midi(str(tmp_path / "jax.mid")).instruments[0].notes)


def test_stitch_rolls_matches_jax():
    rng = np.random.default_rng(0)
    for n, t, hop in ((1, 50, 30), (3, 50, 30), (4, 63, 47), (2, 40, 40), (5, 20, 7)):
        rolls = (rng.random((n, 88, t)) > 0.5).astype(np.float32)
        np.testing.assert_array_equal(stitch_rolls(rolls, hop), j_stitch_rolls(rolls, hop))


@pytest.fixture(scope="module")
def small_pth(tmp_path_factory):
    """A random small cnn_rnn_large as .pth + .json, written by the JAX package."""
    d = tmp_path_factory.mktemp("small")
    mcfg = JModelConfig(model_type="cnn_rnn_large", n_mels=32, hidden_size=16, num_layers=1,
                        compute_dtype="float32")
    acfg = JAudioConfig(n_mels=32, chunk_length=2.0)
    jm = JModel(mcfg)
    variables = jm.init(jax.random.key(3), jm.example_input(batch=1, t=8))
    save_torch_checkpoint(str(d / "small.pth"), variables, mcfg)
    (d / "small.json").write_text(json.dumps({"model": config_to_dict(mcfg),
                                              "audio": config_to_dict(acfg)}))
    return d / "small.pth"


@pytest.mark.parametrize("route", [{"overlap": 0.5}, {"window": 4.0}])
def test_overlap_and_window_match_jax(small_pth, route):
    rng = np.random.default_rng(1)
    sr = 16000
    t = np.arange(int(7.3 * sr)) / sr
    y = (0.3 * np.sin(2 * np.pi * 440.0 * t) * (t > 1.0) + 0.02 * rng.standard_normal(t.size))
    y = y.astype(np.float32)
    ref = JTranscriber(str(small_pth), threshold=0.5, **route).transcribe_array(y)
    got = Transcriber(small_pth, threshold=0.5, device="cpu", **route).transcribe_array(y)
    assert ref, "the comparison needs notes"
    assert _spans(got) == _spans(ref)


def test_transcribe_file_matches_jax(small_pth, tmp_path):
    sr = 16000
    t = np.arange(int(3.5 * sr)) / sr
    wav = tmp_path / "a.wav"
    _write_wav(wav, 0.3 * np.sin(2 * np.pi * 440.0 * t) * (t > 0.5))
    ref = JTranscriber(str(small_pth)).transcribe_file(wav, tmp_path / "jax.mid")
    got = Transcriber(small_pth, device="cpu").transcribe_file(wav)
    assert got == str(tmp_path / "a_transcription.mid")
    ref_notes = j_load_midi(ref).instruments[0].notes
    assert ref_notes, "the comparison needs notes"
    assert _spans(load_midi(got).instruments[0].notes) == _spans(ref_notes)


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch, capsys, tmp_path, demo_pth):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wav = tmp_path / "a.wav"
    _write_wav(wav, np.zeros(16000))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Transcriber(demo_pth)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        transcribe_audio(wav, demo_pth, verbose=False)
    monkeypatch.setattr(sys, "argv", ["music_transcription_tpu_torch", str(wav), str(demo_pth)])
    with pytest.raises(SystemExit) as exc:
        cli.main()
    assert exc.value.code == 1
    assert "CUDA is not available" in capsys.readouterr().out


def test_orbax_directory_raises_with_the_conversion_command():
    with pytest.raises(ValueError, match="save_torch_checkpoint"):
        load_model(CKPT, device="cpu")


def test_constrained_and_beam_raise_for_cnn_rnn(demo_pth):
    for kw in ({"constrained": True}, {"beam": 4}):
        with pytest.raises(ValueError, match="AST checkpoints"):
            Transcriber(demo_pth, device="cpu", **kw)
