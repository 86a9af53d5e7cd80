"""The port's token route of transcribe on the CPU: an AST .pth + .json
served by Transcriber and the CLI with --beam and --constrained, its rolls
against the JAX package's transcribe_chunks on the same weights; the guards
(--window and --overlap refused for AST checkpoints, --beam and
--constrained for CNN-RNN ones, no card without -d cpu)."""

import json
import os
import sys
import wave

import numpy as np
import pytest
import torch

from music_transcription_tpu.config import AudioConfig as JAudioConfig
from music_transcription_tpu.config import config_to_dict
from music_transcription_tpu.transcribe import LoadedModel as JLoadedModel
from music_transcription_tpu.transcribe import transcribe_chunks as j_transcribe_chunks
from music_transcription_tpu_torch import __main__ as main_cli
from music_transcription_tpu_torch.checkpoints import state_dict_from_jax
from music_transcription_tpu_torch.config import ModelConfig
from music_transcription_tpu_torch.data.midi import load_midi
from music_transcription_tpu_torch.models.transcription import TranscriptionModel
from music_transcription_tpu_torch.transcribe import Transcriber, transcribe_chunks
from tests.ast_parity import SMALL, pair, waves


@pytest.fixture(scope="module")
def ast_pth(tmp_path_factory):
    """The small fp32 AST model with 1 s chunks as .pth + .json."""
    tmp = tmp_path_factory.mktemp("ast_serving")
    _, variables, _ = pair("float32")
    cfg = dict(SMALL, compute_dtype="float32")
    pth = str(tmp / "ast.pth")
    torch.save(state_dict_from_jax(variables, ModelConfig(**cfg)), pth)
    with open(str(tmp / "ast.json"), "w") as f:
        json.dump({"model": cfg, "audio": config_to_dict(JAudioConfig(chunk_length=1.0))}, f)
    return pth


@pytest.mark.parametrize("constrained,beam", [(False, 1), (True, 2)])
def test_token_route_rolls_match_jax(ast_pth, constrained, beam):
    jm, variables, _ = pair("float32")
    server = Transcriber(ast_pth, device="cpu", constrained=constrained, beam=beam)
    assert server.loaded.model.config.attention_backend == "xla"  # left as loaded
    y = waves(1, 2.6, seed=21)[0]
    chunks = server.split(y)  # 3 chunks of 1 s, the last zero-padded
    got = transcribe_chunks(server.loaded, chunks, constrained=constrained, beam=beam)
    acfg = JAudioConfig(chunk_length=1.0)
    ref = j_transcribe_chunks(JLoadedModel(model=jm, variables=variables, audio_cfg=acfg),
                              chunks, constrained=constrained, beam=beam)
    assert got.shape == ref.shape == (88, 3 * acfg.roll_frames_per_chunk)
    np.testing.assert_array_equal(got, ref)
    notes = server.transcribe_array(y)
    assert all(n.end > n.start for n in notes)


def test_cli_serves_an_ast_checkpoint(ast_pth, tmp_path, monkeypatch):
    sr = 16000
    wav, mid = str(tmp_path / "in.wav"), str(tmp_path / "out.mid")
    with wave.open(wav, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((waves(1, 2.0, seed=22)[0] * 32767 * 0.5).astype("<i2").tobytes())
    for extra in (["--beam", "2"], ["--constrained"]):
        monkeypatch.setattr(sys, "argv", ["prog", wav, ast_pth, "-o", mid, "-d", "cpu", *extra])
        main_cli.main()
        assert os.path.exists(mid)
        load_midi(mid)
        os.remove(mid)


def test_guards(ast_pth, tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="--window applies to CNN-RNN"):
        Transcriber(ast_pth, device="cpu", window=120.0)
    with pytest.raises(ValueError, match="overlap applies to CNN-RNN"):
        Transcriber(ast_pth, device="cpu", overlap=0.2)
    cnn = str(tmp_path / "cnn.pth")
    cnn_cfg = ModelConfig(model_type="cnn_rnn", n_mels=32, hidden_size=8, num_layers=1)
    torch.save(TranscriptionModel(cnn_cfg).model.state_dict(), cnn)
    with open(str(tmp_path / "cnn.json"), "w") as f:
        json.dump({"model": config_to_dict(cnn_cfg)}, f)
    with pytest.raises(ValueError, match="beam search applies to AST"):
        Transcriber(cnn, device="cpu", beam=4)
    with pytest.raises(ValueError, match="constrained decoding applies to AST"):
        Transcriber(cnn, device="cpu", constrained=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Transcriber(ast_pth, beam=4)
