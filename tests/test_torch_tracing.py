"""PyTorch port: the spans of ``tracing.py``. Without a profiler a span is
one shared no-op context that enters no record function; under a CPU
``torch.profiler`` session a train step of each model records every span,
nested as the layers are, the staged loaders' gathers record theirs, an
evaluation forward records the model's, and the step computes bit for bit
what it computes untraced."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from music_transcription_tpu_torch import tracing
from music_transcription_tpu_torch.config import ModelConfig, TrainConfig
from music_transcription_tpu_torch.data.pipeline import DeviceStagedLoader, SlabRotatingLoader
from music_transcription_tpu_torch.parallel.train_step import init_train_state, train_step

B, N_MELS, T = 2, 32, 24
MODELS = {
    "cnn_rnn_large": dict(model_type="cnn_rnn_large", n_mels=N_MELS, hidden_size=16,
                          num_layers=2, num_attention_heads=2),
    "cnn_rnn": dict(model_type="cnn_rnn", n_mels=N_MELS, hidden_size=16, num_layers=2),
}
STEP_SPANS = ("train.forward", "train.loss", "train.backward", "train.clip",
              "train.host_read", "train.update")
MODEL_SPANS = {"cnn_rnn_large": ("model.cnn", "model.rnn", "model.attention", "model.heads"),
               "cnn_rnn": ("model.cnn", "model.rnn", "model.heads")}
PREFIXES = ("train.", "model.", "data.")
CPU = torch.device("cpu")


def _state(model_type):
    return init_train_state(ModelConfig(**MODELS[model_type]), TrainConfig(), CPU)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    mel = torch.from_numpy((rng.standard_normal((B, 1, N_MELS, T)) * 3).astype(np.float32))
    roll = torch.from_numpy((rng.random((B, 88, T)) > 0.9).astype(np.float32))
    return mel, roll, torch.tensor([T, T - 5], dtype=torch.int32)


def _chunks(n=4):
    rng = np.random.default_rng(1)
    return [(rng.standard_normal((N_MELS, T)).astype(np.float32),
             (rng.random((88, T)) > 0.9).astype(np.float32)) for _ in range(n)]


def _spans(prof) -> dict[str, list[tuple[int, int]]]:
    """{span name: [(start, end)]} of the program's spans in a profile."""
    out: dict[str, list[tuple[int, int]]] = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(PREFIXES):
            out.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def _inside(child, parent) -> bool:
    return parent[0] <= child[0] and child[1] <= parent[1]


def test_off_without_a_profiler_is_one_shared_no_op(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *a, **k):
        entered.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    assert not torch.autograd._profiler_enabled()
    first, second = tracing.span("train.step"), tracing.span("model.cnn")
    assert first is second
    with first:
        with second:
            pass
    state = _state("cnn_rnn")
    train_step(state, _batch(), 0, max_grad_norm=1.0)
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("model.cnn"):
            pass
    assert entered == ["model.cnn"]


@pytest.mark.parametrize("model_type", sorted(MODELS))
def test_a_traced_step_records_every_span_nested(model_type):
    state = _state(model_type)
    loader = DeviceStagedLoader(_chunks(), B, device=CPU, num_workers=0, pad_to=T)
    batches = iter(loader)
    train_step(state, next(batches), 0, max_grad_norm=1.0)  # the first step, untraced
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        train_step(state, next(batches), 0, max_grad_norm=1.0)
    got = _spans(prof)
    names = ("data.gather", "train.step") + STEP_SPANS + MODEL_SPANS[model_type]
    assert sorted(got) == sorted(names)
    assert all(len(v) == 1 for v in got.values()), got
    step, forward = got["train.step"][0], got["train.forward"][0]
    gather = got["data.gather"][0]
    assert gather[1] <= step[0]  # the batch is gathered before the step
    for name in STEP_SPANS:
        assert _inside(got[name][0], step), name
    starts = [got[n][0][0] for n in STEP_SPANS]
    assert starts == sorted(starts)
    for a, b in zip(STEP_SPANS, STEP_SPANS[1:]):
        assert got[a][0][1] <= got[b][0][0], (a, b)
    layers = MODEL_SPANS[model_type]
    for name in layers:
        assert _inside(got[name][0], forward), name
    for a, b in zip(layers, layers[1:]):
        assert got[a][0][1] <= got[b][0][0], (a, b)


def test_the_slab_loader_gathers_inside_its_span():
    loader = SlabRotatingLoader(_chunks(6), B, device=CPU, num_workers=0, pad_to=T,
                                slab_bytes=1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        batches = list(loader)
    assert len(batches) == len(loader) and len(_spans(prof)["data.gather"]) == len(batches)
    assert set(_spans(prof)) == {"data.gather"}


@pytest.mark.parametrize("model_type", sorted(MODELS))
def test_an_evaluation_forward_carries_the_model_spans(model_type):
    model = _state(model_type).model
    model.eval()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        model(_batch()[0])
    got = _spans(prof)
    assert sorted(got) == sorted(MODEL_SPANS[model_type])


@pytest.mark.parametrize("model_type", sorted(MODELS))
def test_a_step_is_bit_identical_with_and_without_a_profiler(model_type):
    plain, traced = _state(model_type), _state(model_type)
    batches = [_batch(0), _batch(1)]
    outs = {}
    for name, state in (("plain", plain), ("traced", traced)):
        outs[name] = []
        for i, batch in enumerate(batches):
            if name == "traced" and i == 1:
                with profile(activities=[ProfilerActivity.CPU]):
                    outs[name].append(train_step(state, batch, 7, max_grad_norm=1.0))
            else:
                outs[name].append(train_step(state, batch, 7, max_grad_norm=1.0))
    assert outs["plain"] == outs["traced"]
    p_params = dict(plain.model.named_parameters())
    for n, p in traced.model.named_parameters():
        assert torch.equal(p, p_params[n]), n
        assert (p.grad is None) == (p_params[n].grad is None), n
        if p.grad is not None:
            assert torch.equal(p.grad, p_params[n].grad), n
    p_buffers = dict(plain.model.named_buffers())
    for n, b in traced.model.named_buffers():
        assert torch.equal(b, p_buffers[n]), n
    for p, q in zip(plain.optimizer.param_groups[0]["params"],
                    traced.optimizer.param_groups[0]["params"]):
        for k, v in plain.optimizer.state[p].items():
            assert torch.equal(v, traced.optimizer.state[q][k]), k
