"""PyTorch port on a CUDA card: each hand-written kernel against its plain
version, and the serving path on the card against the CPU.

Every test needs a card, carries the ``gpu`` marker and skips without one.
This file imports neither JAX nor the JAX package, so it runs on a machine
without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import json
import wave

import numpy as np
import pytest
import torch

from music_transcription_tpu_torch.config import AudioConfig, ModelConfig, config_to_dict
from music_transcription_tpu_torch.data.midi import load_midi
from music_transcription_tpu_torch.models.transcription import TranscriptionModel
from music_transcription_tpu_torch.ops import attention_kernel as AK
from music_transcription_tpu_torch.ops import lstm_kernel as LK
from music_transcription_tpu_torch.ops.mel import log_mel_batch
from music_transcription_tpu_torch.transcribe import transcribe_audio

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def test_log_mel_on_card_matches_cpu(cuda):
    y = torch.from_numpy((0.1 * np.random.default_rng(5).standard_normal((3, 16000))).astype(np.float32))
    cpu = log_mel_batch(y, AudioConfig())
    card = log_mel_batch(y.to(cuda), AudioConfig()).cpu()
    assert float((card - cpu).abs().max()) < 6e-2  # dB, the frontend's parity bound


@pytest.mark.parametrize("two_b,t,h", [(2, 5, 16), (6, 37, 48), (8, 938, 512), (32, 938, 256),
                                       (8, 17, 99)])
def test_lstm_kernel_matches_plain(cuda, two_b, t, h):
    rng = np.random.default_rng(two_b + t + h)
    xw = torch.from_numpy(rng.standard_normal((two_b, t, 4 * h)).astype(np.float32)).to(cuda)
    k = 1.0 / np.sqrt(h)
    wh = torch.from_numpy(rng.uniform(-k, k, (2, h, 4 * h)).astype(np.float32)).to(cuda)
    before = LK.lstm_recurrence.launches
    got = LK.lstm_recurrence(xw, wh)
    ref = LK.lstm_recurrence_plain(xw, wh)
    torch.cuda.synchronize()
    assert LK.lstm_recurrence.launches == before + 1
    # fp32; the summation order differs over up to 938 sequential steps
    assert float((got - ref).abs().max()) < 1e-4


# |got - ref| <= rtol |ref| + ptol (P|V|) element by element, with P|V| the
# plain version's output for |v|. bf16: both round the output to bf16 and
# every probability to bf16 at different points (the kernel before dividing
# by the row sum, the plain version after), which bounds the difference by
# 2^-7 |ref| + 2^-8 (P|V|); the test allows twice that. fp32: only the
# summation order differs.
FLASH_TOL = {torch.bfloat16: (2.0**-6, 2.0**-7), torch.float32: (1e-5, 1e-5)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("b,t,nh,d", [(1, 37, 2, 192), (2, 130, 8, 192), (1, 100, 2, 24),
                                      (1, 70, 1, 18)])
def test_flash_kernel_matches_plain(cuda, b, t, nh, d, dtype):
    rng = np.random.default_rng(t + d)
    # q scaled up so the +-10 clamp binds on part of the logits
    q, k, v = (torch.from_numpy((m * rng.standard_normal((b, t, nh, d))).astype(np.float32))
               .to(cuda, dtype) for m in (4.0, 1.0, 1.0))
    before = AK.flash_attention_clamped.launches
    got = AK.flash_attention_clamped(q, k, v, d**-0.5, 10.0)
    ref = AK.attention_clamped_plain(q, k, v, d**-0.5, 10.0)
    torch.cuda.synchronize()
    assert AK.flash_attention_clamped.launches == before + 1
    assert got.dtype == dtype
    rtol, ptol = FLASH_TOL[dtype]
    ref_abs_v = AK.attention_clamped_plain(q, k, v.abs(), d**-0.5, 10.0).float()
    got, ref = got.float(), ref.float()
    assert bool(((got - ref).abs() <= rtol * ref.abs() + ptol * ref_abs_v).all())


def test_wrappers_raise_on_inputs_the_kernels_do_not_take(cuda):
    x = torch.zeros(2, 3, 8, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError):
        LK.lstm_recurrence(x, torch.zeros(2, 2, 8, device=cuda, dtype=torch.float16))
    q = torch.zeros(1, 4, 1, 8, device=cuda, dtype=torch.float16)  # fp16: bf16 or fp32 only
    with pytest.raises(ValueError):
        AK.flash_attention_clamped(q, q, q, 1.0)


@pytest.mark.parametrize("dtype,attention,rel_tol", [("float32", "xla", 1e-4),
                                                     ("float32", "pallas", 1e-4),
                                                     ("bfloat16", "pallas", 5e-2)])
def test_model_on_card_matches_cpu(cuda, dtype, attention, rel_tol):
    torch.manual_seed(0)
    cfg = ModelConfig(n_mels=64, hidden_size=32, num_layers=2, compute_dtype=dtype,
                      attention_backend=attention)
    cpu_m = TranscriptionModel(cfg).eval()
    card_m = TranscriptionModel(cfg).eval()
    card_m.load_state_dict(cpu_m.state_dict())
    card_m.to(cuda)
    mel = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 1, 64, 50)).astype(np.float32))
    k1, k3 = LK.lstm_recurrence.launches, AK.flash_attention_clamped.launches
    with torch.inference_mode():
        ref = cpu_m(mel, return_all_heads=True)
        got = card_m(mel.to(cuda), return_all_heads=True)
    assert LK.lstm_recurrence.launches == k1 + 3  # 2 rnn_main layers + rnn_local
    assert AK.flash_attention_clamped.launches == k3 + (attention == "pallas")
    for head in ("frame", "onset", "offset"):
        scale = float(ref[head].abs().max())
        assert float((got[head].cpu() - ref[head]).abs().max()) <= rel_tol * scale, head


def test_transcribe_audio_on_card(cuda, tmp_path):
    torch.manual_seed(0)
    mcfg = ModelConfig(n_mels=64, hidden_size=32, num_layers=1)
    acfg = AudioConfig(n_mels=64, chunk_length=2.0)
    torch.save(TranscriptionModel(mcfg).model.state_dict(), tmp_path / "m.pth")
    (tmp_path / "m.json").write_text(json.dumps({"model": config_to_dict(mcfg),
                                                 "audio": config_to_dict(acfg)}))
    sr, n = 16000, 16000 * 5
    y = 0.3 * np.sin(2 * np.pi * 440.0 * np.arange(n) / sr)
    with wave.open(str(tmp_path / "a.wav"), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((y * 32767).astype("<i2").tobytes())
    before = LK.lstm_recurrence.launches
    out = transcribe_audio(tmp_path / "a.wav", tmp_path / "m.pth", tmp_path / "a.mid",
                           verbose=False)
    assert LK.lstm_recurrence.launches == before + 2  # one forward: rnn_main + rnn_local
    load_midi(out)
