"""PyTorch port: the visualization CLI (``python -m music_transcription_tpu_torch.visualize``)
on the CPU.

Checked: ``sample`` plots the arrays of the JAX ``MaestroDataset``'s item;
``transcribe`` on the demo checkpoint (converted by the JAX package) plots
a log-mel within ``DB_TOL`` of JAX's ``log_mel_numpy`` and a predicted roll
equal to JAX's ``transcribe_chunks`` (and the MIDI's ground-truth roll
equal to JAX's), and writes a PNG; without matplotlib both plotting modes
exit 1 naming it; ``sheet`` without music21 exits 1 with the JAX script's
message; ``transcribe`` exits 1 without a card unless asked for the CPU.
"""

import importlib.util
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from music_transcription_tpu.config import AudioConfig as JAudioConfig
from music_transcription_tpu.config import ModelConfig as JModelConfig
from music_transcription_tpu.data import audio as j_audio
from music_transcription_tpu.data.maestro import MaestroDataset as JMaestroDataset
from music_transcription_tpu.data.midi import load_midi as j_load_midi
from music_transcription_tpu.ops.mel import log_mel_numpy as j_log_mel_numpy
from music_transcription_tpu.train.checkpoints import load_checkpoint, save_torch_checkpoint
from music_transcription_tpu.transcribe import load_model as j_load_model
from music_transcription_tpu.transcribe import transcribe_chunks as j_transcribe_chunks
from music_transcription_tpu_torch import visualize
from music_transcription_tpu_torch.transcribe import load_model
from tests.maestro_fixture import make_maestro_root

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "assets", "demo_checkpoint")
DB_TOL = 6e-2  # tests/test_torch_mel.py: fp32 paths against the float64 oracle, in dB
THRESHOLD = 0.35


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
def maestro_root(tmp_path_factory):
    return make_maestro_root(tmp_path_factory.mktemp("maestro"))


@pytest.fixture
def plotted(monkeypatch):
    """What ``_plot`` was given, each call, while it still draws."""
    calls, draw = [], visualize._plot

    def record(mel, rolls, out_path, fs, title=""):
        calls.append((mel, rolls, out_path, fs, title))
        draw(mel, rolls, out_path, fs, title)

    monkeypatch.setattr(visualize, "_plot", record)
    return calls


def _equal(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("split,index", [("train", 0), ("train", 3), ("validation", 1)])
def test_sample_plots_the_jax_dataset_item(maestro_root, tmp_path, plotted, split, index):
    png = tmp_path / "sample.png"
    assert visualize.main(["sample", "--root_dir", maestro_root, "--split", split,
                           "--index", str(index), "--n_mels", "32", "--chunk_length", "2.0",
                           "-o", str(png)]) == 0
    assert png.stat().st_size > 0
    (mel, rolls, out, fs, title), = plotted
    ref_mel, ref_roll = JMaestroDataset(maestro_root, split=split, chunk_length=2.0,
                                        audio_cfg=JAudioConfig(n_mels=32, chunk_length=2.0))[index]
    _equal(mel, ref_mel)
    assert list(rolls) == ["ground-truth piano roll"]
    _equal(rolls["ground-truth piano roll"], ref_roll)
    assert (out, fs, title) == (str(png), JAudioConfig().frame_rate, f"{split}[{index}]")


def test_transcribe_plots_what_jax_computes(demo_pth, maestro_root, tmp_path, plotted):
    wav = os.path.join(maestro_root, "2017", "piece1.wav")  # 6.5 s: 4 chunks of 2 s
    mid = wav.replace(".wav", ".midi")
    png = tmp_path / "viz.png"
    assert visualize.main(["transcribe", wav, str(demo_pth), "-d", "cpu", "-t", str(THRESHOLD),
                           "--reference_midi", mid, "-o", str(png)]) == 0
    assert png.stat().st_size > 0
    (mel, rolls, _, fs, title), = plotted
    assert title == "piece1.wav"

    ref = j_load_model(CKPT)
    acfg = ref.audio_cfg
    y, _ = j_audio.load_audio(wav, sr=acfg.sample_rate, mono=True)
    ref_mel = j_log_mel_numpy(y, acfg)
    assert mel.shape == ref_mel.shape and fs == acfg.frame_rate
    assert np.abs(mel - ref_mel).max() < DB_TOL
    chunks = j_audio.split_into_chunks(y, acfg.chunk_samples)
    assert chunks.shape[0] == 4
    ref_pred = np.asarray(j_transcribe_chunks(ref, chunks, threshold=THRESHOLD))
    _equal(rolls["predicted piano roll"], ref_pred[:, : ref_mel.shape[1]])
    assert rolls["predicted piano roll"].sum() > 0  # the piece's note, not an empty roll
    ref_gt = j_load_midi(mid).keys_roll(fs=acfg.frame_rate)[:, : ref_mel.shape[1]]
    _equal(rolls["ground-truth piano roll"], ref_gt)


def test_transcribe_rolls_takes_a_loaded_model(demo_pth, maestro_root):
    wav = os.path.join(maestro_root, "2017", "piece0.wav")
    mel, rolls = visualize.transcribe_rolls(load_model(demo_pth, device="cpu"), wav, THRESHOLD)
    assert list(rolls) == ["predicted piano roll"]
    assert rolls["predicted piano roll"].shape == (88, mel.shape[1])
    assert set(np.flatnonzero(rolls["predicted piano roll"].any(axis=1)) + 21) == {60, 64}


def test_without_matplotlib_the_plots_exit_1(demo_pth, maestro_root, tmp_path, monkeypatch,
                                             capsys):
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import matplotlib raises
    wav = os.path.join(maestro_root, "2017", "piece0.wav")
    for argv in (["sample", "--root_dir", maestro_root, "-o", str(tmp_path / "s.png")],
                 ["transcribe", wav, str(demo_pth), "-d", "cpu", "-o", str(tmp_path / "t.png")]):
        assert visualize.main(argv) == 1
        assert "matplotlib" in capsys.readouterr().out
    assert os.listdir(tmp_path) == []


def test_sheet_without_music21_says_what_jax_says(maestro_root, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "music21", None)
    mid = os.path.join(maestro_root, "2017", "piece0.midi")
    assert visualize.main(["sheet", mid]) == 1
    ours = capsys.readouterr().out
    spec = importlib.util.spec_from_file_location(
        "jax_visualize", os.path.join(REPO, "scripts", "visualize.py"))
    jax_visualize = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_visualize)
    assert jax_visualize.main(["sheet", mid]) == 1
    assert ours == capsys.readouterr().out and "music21" in ours


def test_transcribe_needs_a_card_unless_asked_for_the_cpu(demo_pth, maestro_root, capsys):
    wav = os.path.join(maestro_root, "2017", "piece0.wav")
    if not torch.cuda.is_available():
        assert visualize.main(["transcribe", wav, str(demo_pth)]) == 1
        assert "CUDA is not available" in capsys.readouterr().out
    with pytest.raises(ValueError, match="save_torch_checkpoint"):
        visualize.main(["transcribe", wav, CKPT, "-d", "cpu"])
