"""PyTorch port: the host kit (``native.py``, ``csrc/hostkit.cpp``) against
the JAX package's native library and against the numpy paths, on the cases
of tests/test_native.py; and its build (by a hash of the source, into
``build/host/``, safe when processes build at once)."""

import os
import subprocess
import sys
import wave

import numpy as np
import pytest

from music_transcription_tpu import native as jnative
from music_transcription_tpu_torch import native
from music_transcription_tpu_torch.data import audio as A
from music_transcription_tpu_torch.data import midi as M

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_wav(path, y, sr=16000, channels=1):
    y = np.asarray(y)
    if y.ndim == 1:
        y = y[:, None]
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(y, -1, 1) * 32767).astype("<i2").tobytes())


def test_builds_here_into_build_host():
    assert native.available()
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert native.BUILD_DIR.relative_to(REPO).parts == ("build", "host")
    assert path.name.startswith("libhostkit-") and path.suffix == ".so"


def test_processes_building_at_once_each_load_a_whole_library(tmp_path):
    code = ("import sys\n"
            "from pathlib import Path\n"
            "from music_transcription_tpu_torch import native\n"
            "native.BUILD_DIR = Path(sys.argv[1])\n"
            "assert native.available()\n"
            "print(native.library_path())\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, [e for _, e in outs]
    assert len({o.strip() for o, _ in outs}) == 1
    assert [p.name for p in tmp_path.iterdir()] == [native.library_path().name]


def test_wav_info(tmp_path):
    p = tmp_path / "a.wav"
    _write_wav(p, np.zeros(1234), sr=22050)
    info, ref = native.wav_info(p), jnative.wav_info(p)
    assert (info.format, info.channels, info.sample_rate, info.bits, info.n_frames) == (
        1, 1, 22050, 16, 1234)
    for field, _ in native._WavInfo._fields_:
        assert getattr(info, field) == getattr(ref, field), field


def test_decode_mono_matches_numpy_and_jax(tmp_path):
    y = (np.random.default_rng(0).random(5000) * 2 - 1).astype(np.float32)
    p = tmp_path / "m.wav"
    _write_wav(p, y)
    got = native.decode_wav(p)
    np.testing.assert_array_equal(got, A._load_wav_numpy(p, True, 0.0, None)[0])
    np.testing.assert_array_equal(got, jnative.decode_wav(p))


def test_decode_stereo_window_matches_numpy_and_jax(tmp_path):
    y = (np.random.default_rng(1).random((4000, 2)) * 2 - 1).astype(np.float32)
    p = tmp_path / "s.wav"
    _write_wav(p, y, channels=2)
    got = native.decode_wav(p, start_frame=500, n_frames=1000)
    assert got.shape == (1000,)
    np.testing.assert_array_equal(got, jnative.decode_wav(p, start_frame=500, n_frames=1000))
    ref, _ = A._load_wav_numpy(p, True, 500 / 16000, 1000 / 16000)  # frames 500 to 1500
    assert ref.shape == (1000,) and np.abs(got - ref).max() < 1e-7


@pytest.mark.parametrize("sr", [16000, 44100], ids=["native_rate", "resampled"])
def test_load_wav_through_the_kit_equals_numpy(tmp_path, monkeypatch, sr):
    y = (np.random.default_rng(2).random(2 * sr) * 2 - 1).astype(np.float32)
    p = tmp_path / "n.wav"
    _write_wav(p, y, sr=sr)
    calls = []
    real = native.decode_wav
    monkeypatch.setattr(native, "decode_wav", lambda *a: calls.append(a) or real(*a))
    via_kit, out_sr = A.load_wav(p, sr=16000, offset=0.1, duration=0.25)
    assert calls and out_sr == 16000 and via_kit.shape == (4000,)
    monkeypatch.setattr(native, "available", lambda: False)
    via_numpy, _ = A.load_wav(p, sr=16000, offset=0.1, duration=0.25)
    np.testing.assert_array_equal(via_kit, via_numpy)


def test_fill_roll_matches_numpy_and_jax():
    rng = np.random.default_rng(3)
    notes = [M.Note(pitch=int(rng.integers(21, 109)), start=float(rng.random() * 2), end=0.0,
                    velocity=int(rng.integers(1, 127))) for _ in range(50)]
    for n in notes:
        n.end = n.start + float(rng.random())
    fs, n_cols = 31.25, 100
    args = ([n.pitch for n in notes], [n.start for n in notes], [n.end for n in notes],
            [n.velocity for n in notes], fs, n_cols)
    got = native.fill_roll(*args)
    np.testing.assert_array_equal(got, M._fill_roll_numpy(notes, fs, n_cols))
    np.testing.assert_array_equal(got, jnative.fill_roll(*args))


def test_instrument_roll_same_with_and_without_the_kit(monkeypatch):
    inst = M.Instrument(notes=[M.Note(pitch=60, start=0.0, end=0.5, velocity=50),
                               M.Note(pitch=64, start=0.25, end=1.0, velocity=70)])
    ref = np.zeros((128, 100))
    ref[60, 0:50] += 50
    ref[64, 25:100] += 70
    np.testing.assert_array_equal(M.MidiFile(instruments=[inst]).piano_roll(fs=100), ref)
    monkeypatch.setattr(native, "available", lambda: False)
    np.testing.assert_array_equal(M.MidiFile(instruments=[inst]).piano_roll(fs=100), ref)
