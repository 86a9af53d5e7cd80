"""The hFT cell (``hft-train-b8``) rehearsed on the CPU at a tiny size:
the drawn velocity cache, a whole run's last line with and without the
trace (the three per-layer metrics read from the split), each fault of the
timed path seen as not correct, the float8 control's readings, and the
reference's work count at the published widths."""

import json
import time

import numpy as np
import pytest
import torch

from conftest import ROOT

from benchmark.common import registry, result
from benchmark.common.result import KEYS

WORKLOAD = "hft-train-b8"
# every width cut; velocities within the tiny model's classes
TINY_HFT = dict(n_mels=16, hidden_size=16, num_layers=2, num_attention_heads=2, ffn_dim=24,
                conv_channels=2, conv_kernel=3, segment_frames=8, margin_frames=4,
                velocity_classes=10, compute_dtype="float32")
TINY_TRAFFIC = dict(batch=4, cache_segments=12, validation_segments=3, velocities=[1, 9],
                    notes=[0, 12], note_frames=[2, 10], traced_min_s=0.05, traced_min_steps=2)
LAYERS = ("freq_encoder_ms.train", "freq_decoder_ms.train", "time_encoder_ms.train")


def _cell():
    cell = registry.cell(registry.load_benchmark(ROOT), WORKLOAD, ROOT)
    cell.config["model"].update(TINY_HFT)
    cell.traffic.update(TINY_TRAFFIC)
    return cell


def _run(cpu, trace=False, fault=None, seconds=1.5):
    cell = _cell()
    outcome, device, breakdown = cell.generator().run(
        cell, seed=2**31 + 23, seconds=seconds, trace=trace, device=cpu,
        t_start=time.perf_counter(), fault=fault)
    metrics = cell.read_metrics(cell.per_layer if trace else cell.end_to_end, outcome.window)
    return json.loads(result.last_line(outcome, metrics, device, breakdown if trace else None))


def test_the_cache_holds_velocities_of_notes(cpu):
    gen = _cell().generator()
    mel, roll = gen.velocity_cache(40, 16, 24, 5, cpu, notes=[0, 60], note_frames=[5, 120],
                                   velocities=[1, 127])
    assert mel.dtype == np.float16 and roll.dtype == np.uint8 and roll.shape == (40, 88, 24)
    assert roll.max() <= 127 and len(np.unique(roll)) > 50
    again = gen.velocity_cache(40, 16, 24, 5, cpu, notes=[0, 60], note_frames=[5, 120],
                               velocities=[1, 127])
    assert np.array_equal(roll, again[1]) and np.array_equal(mel, again[0])
    keys_on = (roll > 0).any(-1).sum(-1)
    assert keys_on.min() < keys_on.max() <= 60  # segments differ in density


@pytest.mark.parametrize("trace", [False, True])
def test_rehearsal_gives_a_correct_line(trace, cpu):
    line = _run(cpu, trace, seconds=4.0 if trace else 1.5)
    assert list(line) == [k for k in KEYS if k in line]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0, line
    assert list(line["checks"]) == list(json.load(open(
        f"{ROOT}/benchmark/limits/{WORKLOAD}.json")))
    assert line["device"]["platform"] == "cpu"
    if trace:  # the CPU has no device events for the split to give the spans
        assert "mfu.train" in line["metrics"] and not set(LAYERS) & set(line["metrics"])
    else:
        assert {"setup_s", "train_audio_s_per_s"} <= set(line["metrics"])  # no peak on the CPU


@pytest.mark.parametrize("fault", ["frozen", "half_batch"])
def test_a_broken_timed_path_is_not_correct(fault, cpu):
    assert _run(cpu, fault=fault)["correct"] is False


def test_grad_small_holds_the_small_leaves_and_not_the_nought_ones():
    gen = _cell().generator()
    ref = {"raw_grad": {**{f"w{i}": 1.0 for i in range(9)}, "freq_pos.weight": 1e-4,
                        "freq_encoder.0.self_attn.k.bias": 1e-9}}
    raw = {**ref["raw_grad"], "freq_pos.weight": 1.02e-4, "freq_encoder.0.self_attn.k.bias": 7e-9}
    assert gen.grad_small(ref, raw) == pytest.approx(0.02)  # the k bias's round-off is not read
    assert gen.grad_small(ref, {**raw, "freq_pos.weight": 0.0}) == 1.0
    assert gen.grad_small(ref, {**raw, "w0": 0.0}) == pytest.approx(0.02)  # a moved leaf: not here


def test_a_small_leaf_that_does_not_learn_is_not_correct(cpu, monkeypatch):
    """The first block's q bias, whose gradient at this size is under a
    thousandth of the median leaf's, trained with a zero gradient: no
    number but ``grad_small`` sees it."""
    from music_transcription_tpu_torch.parallel import train_step as ts

    leaf = "freq_encoder.0.self_attn.q.bias"
    build = ts.init_train_state

    def init(*a, **k):
        state = build(*a, **k)
        dict(state.model.model.named_parameters())[leaf].register_hook(torch.zeros_like)
        return state

    monkeypatch.setattr(ts, "init_train_state", init)
    line = _run(cpu)
    checks = {k: (c["value"], c["limit"]) for k, c in line["checks"].items()}
    assert line["correct"] is False and checks["grad_small"][0] == 1.0, checks
    assert all(v <= lim for k, (v, lim) in checks.items() if k != "grad_small")


def test_the_float8_control_reads_further_than_the_program(cpu):
    cell = _cell()
    low = cell.generator().control(cell, seed=9, device=cpu, precision="float8")
    assert set(low) >= set(cell.limits) and low["loss"] > 0


def test_forward_flops_at_the_published_widths():
    cell = registry.cell(registry.load_benchmark(ROOT), WORKLOAD, ROOT)
    flops = cell.reference().forward_flops(cell.config["model"], 192)
    assert 249e9 < flops < 250e9  # frequency encoder 133, decoder 76, time encoder 40 GFLOP


def test_the_reference_forward_is_the_programs_at_a_tiny_size(cpu):
    """The harness's copy of the reference against the port's model in fp32
    inference: the same eight outputs."""
    from music_transcription_tpu_torch.config import ModelConfig, config_from_dict
    from music_transcription_tpu_torch.models.transcription import TranscriptionModel

    cell = _cell()
    model = TranscriptionModel(config_from_dict(ModelConfig, cell.config["model"])).eval()
    w = {k: v.detach() for k, v in model.model.state_dict().items()}
    mel = torch.randn(2, 1, 16, 16)
    with torch.no_grad():
        got = model(mel)
        want = cell.reference().forward(w, mel, cell.config["model"])
    for k, v in want.items():
        assert torch.allclose(got[k], v, atol=1e-4, rtol=1e-4), k


def test_the_layer_readers_read_the_split():
    from benchmark.common.result import Window
    from benchmark.common.spans import Split

    cell = registry.cell(registry.load_benchmark(ROOT), WORKLOAD, ROOT)
    layers = [m for m in cell.per_layer if m["name"] in LAYERS]
    assert len(layers) == 3
    window = Window(model=cell.config["model"], reference=None, frames=192, chunk_s=2.048)
    assert cell.read_metrics(layers, window) == {}  # no split: nothing, no error
    window.split = Split(seconds={"model.freq_encoder": 0.3, "model.freq_decoder": 0.12,
                                  "train.loss": 0.01}, total=0.5, steps=4)
    got = cell.read_metrics(layers, window)
    assert got == {"freq_encoder_ms.train": {"value": 75.0, "unit": "ms/step"},
                   "freq_decoder_ms.train": {"value": 30.0, "unit": "ms/step"}}
