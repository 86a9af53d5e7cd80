"""The work counts against hand counts at small sizes."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import tiny_cell

from benchmark.common.inputs import seeded_weights
from benchmark.common.work import recurrence_bound_s
from benchmark.common.device import PEAK_BYTES, PEAK_FP32


def _lstm_flops(t, i, h):
    return 2 * 2 * t * (i * 4 * h + h * 4 * h)


@pytest.mark.parametrize("workload", ["large-train-b24", "cnn_rnn-train-b24"])
def test_forward_flops_match_the_products_counted(workload):
    from music_transcription_tpu_torch.config import ModelConfig, config_from_dict
    from music_transcription_tpu_torch.models.transcription import TranscriptionModel

    cell = tiny_cell(workload)
    cfg, ref = cell.config["model"], cell.reference()
    t = 7
    with torch.device("meta"):
        skeleton = TranscriptionModel(config_from_dict(ModelConfig, cfg)).model
    w = seeded_weights(skeleton, 1, torch.device("cpu"))
    mel = torch.randn(1, 1, cfg["n_mels"], t)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        ref.forward(w, mel, cfg)
    counted = counter.get_total_flops()  # convolutions and products; not the LSTM's
    hidden, layers, mels = cfg["hidden_size"], cfg["num_layers"], cfg["n_mels"]
    if cfg["model_type"] == "cnn_rnn":
        lstm = _lstm_flops(t, 64 * (mels // 4), hidden) + (layers - 1) * _lstm_flops(
            t, 2 * hidden, hidden)
    else:
        lstm_in = 256 * (mels // 8)
        lstm = (_lstm_flops(t, lstm_in, hidden) + (layers - 1) * _lstm_flops(t, 2 * hidden, hidden)
                + _lstm_flops(t, lstm_in, hidden // 2))
    assert ref.forward_flops(cfg, t) == pytest.approx(counted + lstm, rel=1e-12)


def test_large_model_count_at_full_size():
    """326 GFLOP a 30 s chunk: the JAX script's stage count plus the heads."""
    cell = tiny_cell("large-train-b24")
    cfg = {**cell.config["model"], "n_mels": 320, "hidden_size": 512, "num_layers": 3,
           "num_attention_heads": 8}
    flops = cell.reference().forward_flops(cfg, 938)
    assert 3 * 24 * flops == pytest.approx(23.5e12, rel=0.01)


def test_recurrence_bounds():
    two_b, t, h = 48, 938, 512
    k2a = 2.0 * two_b * t * h * 4 * h / PEAK_FP32
    assert recurrence_bound_s(two_b, t, h, "K2a") == pytest.approx(k2a)
    assert recurrence_bound_s(two_b, t, h, "K2b") == pytest.approx(2 * k2a)
    tiny = 4.0 * (16 + 32 + 2 * 4) / PEAK_BYTES  # xw 2x1x8, W_hh 2x2x8, h and c 2x1x2
    assert recurrence_bound_s(2, 1, 2, "K2a") == pytest.approx(tiny)
