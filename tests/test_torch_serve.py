"""PyTorch port: the resident server (``python -m music_transcription_tpu_torch.serve``)
on the CPU, on the demo checkpoint converted by the JAX package.

Checked: watch mode (``--once``) over two WAVs and a non-audio file, and
stdin mode, write MIDI whose notes equal the JAX ``Transcriber``'s for the
same files; a failing file prints ``ERROR`` and serving goes on (stdin then
exits 1); outputs already written are skipped; the refusals (no card, an
orbax directory, a missing watch directory); the flag set is the JAX
script's.
"""

import argparse
import importlib.util
import io
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from music_transcription_tpu.config import ModelConfig as JModelConfig
from music_transcription_tpu.data.midi import load_midi as j_load_midi
from music_transcription_tpu.train.checkpoints import load_checkpoint, save_torch_checkpoint
from music_transcription_tpu.transcribe import Transcriber as JTranscriber
from music_transcription_tpu_torch import serve
from music_transcription_tpu_torch.data.midi import load_midi
from tests.maestro_fixture import make_maestro_root

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "assets", "demo_checkpoint")
THRESHOLD = 0.35  # the demo checkpoint's notes at the golden test's threshold


def _spans(path, loader=load_midi):
    return [(n.pitch, n.start, n.end) for n in loader(str(path)).instruments[0].notes]


@pytest.fixture(scope="module")
def demo_pth(tmp_path_factory):
    """The demo orbax checkpoint as .pth + .json, converted by the JAX package."""
    d = tmp_path_factory.mktemp("demo")
    with open(os.path.join(CKPT, "config.json")) as f:
        cfg = json.load(f)
    save_torch_checkpoint(str(d / "demo.pth"), load_checkpoint(CKPT), JModelConfig(**cfg["model"]))
    shutil.copy(os.path.join(CKPT, "config.json"), d / "demo.json")
    return d / "demo.pth"


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    """The fixture's two 2017 pieces (4 s, two notes; 6.5 s, one note)."""
    root = make_maestro_root(tmp_path_factory.mktemp("maestro"))
    return [os.path.join(root, "2017", f"piece{i}.wav") for i in (0, 1)]


@pytest.fixture(scope="module")
def jax_notes(wavs, tmp_path_factory):
    """The JAX Transcriber's notes of each WAV, on the orbax checkpoint."""
    out = tmp_path_factory.mktemp("jax_out")
    server = JTranscriber(CKPT, threshold=THRESHOLD)
    return {w: _spans(server.transcribe_file(w, str(out / os.path.basename(w))), j_load_midi)
            for w in wavs}


def test_watch_once_matches_jax_and_skips_non_audio(demo_pth, wavs, jax_notes, tmp_path,
                                                    capsys):
    watch, out = tmp_path / "incoming", tmp_path / "done"
    watch.mkdir()
    for w in wavs:
        shutil.copy(w, watch)
    (watch / "notes.txt").write_text("not audio")
    argv = ["--model", str(demo_pth), "--watch_dir", str(watch), "--out_dir", str(out),
            "--once", "--device", "cpu", "--threshold", str(THRESHOLD)]
    assert serve.main(argv) == 0
    lines = capsys.readouterr().out.splitlines()
    assert sorted(os.listdir(out)) == ["piece0.mid", "piece1.mid"]
    for w in wavs:
        name = os.path.basename(w)
        assert any(line.startswith(f"{watch / name} -> {out / name[:-4]}.mid (")
                   for line in lines), lines
        assert _spans(out / (name[:-4] + ".mid")) == jax_notes[w]
    assert _spans(out / "piece0.mid")[0][0] == 60  # the fixture's notes, not an empty roll
    # a second pass finds both outputs written and transcribes nothing
    assert serve.main(argv) == 0
    assert " -> " not in capsys.readouterr().out


def test_watch_writes_next_to_the_input_without_out_dir(demo_pth, wavs, jax_notes, tmp_path):
    shutil.copy(wavs[0], tmp_path)
    assert serve.main(["--model", str(demo_pth), "--watch_dir", str(tmp_path), "--once",
                       "--device", "cpu", "--threshold", str(THRESHOLD)]) == 0
    assert _spans(tmp_path / "piece0.mid") == jax_notes[wavs[0]]


def test_stdin_in_process_serves_every_path(demo_pth, wavs, jax_notes, tmp_path, monkeypatch,
                                            capsys):
    monkeypatch.setattr(sys, "stdin", io.StringIO("\n".join(wavs) + "\n\n"))
    assert serve.main(["--model", str(demo_pth), "--stdin", "--out_dir", str(tmp_path),
                       "--device", "cpu", "--threshold", str(THRESHOLD)]) == 0
    assert capsys.readouterr().out.count(" -> ") == 2
    for w in wavs:
        assert _spans(tmp_path / os.path.basename(w).replace(".wav", ".mid")) == jax_notes[w]


def test_stdin_cli_goes_on_after_a_failure_and_exits_1(demo_pth, wavs, jax_notes, tmp_path):
    missing = str(tmp_path / "missing.wav")
    proc = subprocess.run(
        [sys.executable, "-m", "music_transcription_tpu_torch.serve", "--model", str(demo_pth),
         "--stdin", "--out_dir", str(tmp_path / "out"), "--device", "cpu",
         "--threshold", str(THRESHOLD)],
        input=f"{missing}\n{wavs[0]}\n", capture_output=True, text=True, cwd=REPO, timeout=300)
    assert proc.returncode == 1, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert f"ERROR {missing}:" in proc.stderr
    assert f"{wavs[0]} -> {tmp_path / 'out' / 'piece0.mid'}" in proc.stdout
    assert _spans(tmp_path / "out" / "piece0.mid") == jax_notes[wavs[0]]


def test_a_failing_file_in_watch_mode_does_not_stop_serving(demo_pth, wavs, tmp_path, capsys):
    (tmp_path / "a_broken.wav").write_bytes(b"RIFF not a wav")
    shutil.copy(wavs[0], tmp_path)
    assert serve.main(["--model", str(demo_pth), "--watch_dir", str(tmp_path), "--once",
                       "--out_dir", str(tmp_path / "out"), "--device", "cpu"]) == 0
    captured = capsys.readouterr()
    assert f"ERROR {tmp_path / 'a_broken.wav'}:" in captured.err
    assert os.listdir(tmp_path / "out") == ["piece0.mid"]


def test_refusals(demo_pth, tmp_path, capsys):
    if not torch.cuda.is_available():
        assert serve.main(["--model", str(demo_pth), "--stdin"]) == 1
        assert "CUDA is not available" in capsys.readouterr().out
    assert serve.main(["--model", str(demo_pth), "--watch_dir", str(tmp_path / "nowhere"),
                       "--once", "--device", "cpu"]) == 1
    assert "does not exist" in capsys.readouterr().err
    with pytest.raises(ValueError, match="save_torch_checkpoint"):
        serve.main(["--model", CKPT, "--stdin", "--device", "cpu"])
    with pytest.raises(SystemExit):  # one mode is required
        serve.main(["--model", str(demo_pth), "--device", "cpu"])


def _options(parser: argparse.ArgumentParser) -> dict:
    return {a.option_strings[0]: (a.default, a.choices) for a in parser._actions
            if a.option_strings and a.dest != "help"}


def test_flags_are_the_jax_scripts():
    spec = importlib.util.spec_from_file_location("jax_serve", os.path.join(REPO, "scripts",
                                                                          "serve.py"))
    jax_serve = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_serve)
    ours, theirs = _options(serve.build_parser()), _options(jax_serve.build_parser())
    assert set(ours) == set(theirs)
    assert ours.pop("--device") == ("cuda", ["cuda", "cpu"])
    theirs.pop("--device")
    assert ours == theirs
    assert serve.AUDIO_EXTS == jax_serve.AUDIO_EXTS
