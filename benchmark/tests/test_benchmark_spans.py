"""The program's spans as the benchmark reads them: on a CPU profile of
one tiny train step of each model, every backward node and every operation
under ``train.backward`` reaches a model span or the loss through its
sequence number; device events laid on that profile take the span of their
launch; ``sync_idle_ms.train`` sums the idle gaps inside the guard's spans
and reads nothing where there is nothing to read."""

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from conftest import ROOT

from benchmark.common import registry, spans
from benchmark.common.device import Event, Trace
from benchmark.common.result import Window

B, N_MELS, T = 2, 32, 24
MODELS = {
    "cnn_rnn_large": dict(model_type="cnn_rnn_large", n_mels=N_MELS, hidden_size=16,
                          num_layers=2, num_attention_heads=2, compute_dtype="float32"),
    "cnn_rnn": dict(model_type="cnn_rnn", n_mels=N_MELS, hidden_size=16, num_layers=2,
                    compute_dtype="float32"),
}
FORWARD_SPANS = {"model.cnn", "model.rnn", "model.attention", "model.heads", "train.loss"}


def _profiled_step(model_type):
    """The kineto events of one traced step, its batch gathered inside the
    profile, after one untraced step."""
    from music_transcription_tpu_torch.config import ModelConfig, TrainConfig
    from music_transcription_tpu_torch.data.pipeline import DeviceStagedLoader
    from music_transcription_tpu_torch.parallel.train_step import init_train_state, train_step

    rng = np.random.default_rng(0)
    items = [(rng.standard_normal((N_MELS, T)).astype(np.float32) * 3,
              (rng.random((88, T)) > 0.9).astype(np.float32)) for _ in range(2 * B)]
    cpu = torch.device("cpu")
    state = init_train_state(ModelConfig(**MODELS[model_type]), TrainConfig(), cpu)
    batches = iter(DeviceStagedLoader(items, B, device=cpu, num_workers=0, pad_to=T))
    train_step(state, next(batches), 0, max_grad_norm=1.0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        train_step(state, next(batches), 0, max_grad_norm=1.0)
    return list(prof.profiler.kineto_results.events())


@pytest.fixture(scope="module", params=sorted(MODELS))
def step_events(request):
    return request.param, _profiled_step(request.param)


def _interval(events, name):
    (e,) = [e for e in events if e.name() == name]
    return e.start_ns(), e.start_ns() + e.duration_ns()


def test_backward_reaches_a_model_span_or_the_loss(step_events):
    _, events = step_events
    a = spans.Attribution(events)
    nodes = [e for e in events if e.name().startswith(spans.BACKWARD_OP)]
    assert nodes
    for node in nodes:
        if node.name().endswith("AccumulateGrad"):
            assert a.forward_start(node) is None
            continue
        start = a.forward_start(node)
        assert start is not None, node.name()
        assert a.innermost(start) in FORWARD_SPANS, (node.name(), a.innermost(start))
    b0, b1 = _interval(events, "train.backward")
    ops = [e for e in events if e.device_type() == DeviceType.CPU and b0 <= e.start_ns() <= b1
           and not e.is_user_annotation() and not e.name().startswith(spans.BACKWARD_OP)]
    assert ops
    for e in ops:
        node = a.node_at(e.start_thread_id(), e.start_ns())
        got = a.span_of_launch(e.start_thread_id(), e.start_ns())
        if node is None or node.name().endswith("AccumulateGrad"):
            assert got == "train.backward", e.name()  # the seed gradient, the leaves'
        else:
            assert got in FORWARD_SPANS, (e.name(), node.name(), got)


class _Fake:
    """A kineto event made up: a runtime call or the device event it launched."""

    def __init__(self, name, start, duration, corr, thread=0, device=False):
        self._v = (name, start, duration, corr, thread, device)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def correlation_id(self):
        return self._v[3]

    def start_thread_id(self):
        return self._v[4]

    def device_type(self):
        return DeviceType.CUDA if self._v[5] else DeviceType.CPU

    def is_user_annotation(self):
        return False

    def sequence_nr(self):
        return -1


def _launch_every_op(events):
    """A made-up kernel of 1 us launched at the start of every host
    operation, and one whose launch the profile does not hold."""
    made = []
    ops = [e for e in events if e.device_type() == DeviceType.CPU
           and not e.is_user_annotation()]
    for i, e in enumerate(ops):
        corr = 10**9 + i
        made.append(_Fake("cudaLaunchKernel", e.start_ns(), 1, corr, e.start_thread_id()))
        made.append(_Fake(f"kernel_{i}", e.start_ns() + 10, 1000, corr, device=True))
    made.append(_Fake("launched_before_the_stretch", 0, 5000, 7, device=True))
    return made


def test_device_events_take_the_span_of_their_launch(step_events):
    model_type, events = step_events
    split = spans.Attribution(events + _launch_every_op(events)).split()
    assert split.steps == 1
    assert split.unattributed == pytest.approx(5e-6)
    assert split.total == pytest.approx(sum(split.seconds.values()) + split.unattributed)
    assert split.attributed_share() >= 0.97, split.line()
    for metric, names in spans.METRIC_SPANS.items():
        got = split.ms_per_step(*names)
        if metric == "attention_ms.train" and model_type == "cnn_rnn":
            assert got is None
        else:
            assert got is not None and got > 0, metric
    line = split.line()
    assert "unattributed" in line and "model.rnn" in line and line.count("\n") == 0


def test_a_split_of_nothing_reads_nothing():
    split = spans.Attribution([]).split()
    assert split.steps == 0 and split.ms_per_step("model.cnn") is None
    assert split.attributed_share() == 0.0


def _reader(name):
    return registry.load_module(f"{ROOT}/benchmark/metrics/{name}.py", name.replace(".", "_"))


def _window(trace, steps=1):
    return Window(model={}, reference=None, frames=1, chunk_s=1.0, trace=trace,
                  traced_steps=steps)


def test_sync_idle_sums_the_gaps_in_the_guards_spans():
    read = _reader("sync_idle_ms.train").read
    device = [Event("k", 0, 100), Event("k", 200, 300), Event("k", 310, 400),
              Event("k", 1000, 1100)]
    host = [Event("train.host_read", 100, 190), Event("train.update", 300, 305),
            Event("aten::mm", 400, 1000)]
    trace = Trace(device=device, host=host, wall_s=1e-6)
    assert read(_window(trace, steps=2)) == pytest.approx(1e3 * (100 + 10) / 1e9 / 2)


@pytest.mark.parametrize("trace", [
    None,
    Trace(device=[Event("k", 0, 100), Event("k", 200, 300)],
          host=[Event("aten::mm", 0, 300)], wall_s=1e-6),
    Trace(device=[], host=[Event("train.host_read", 0, 300)], wall_s=1e-6),
])
def test_sync_idle_reads_nothing_without_its_spans_or_a_card(trace):
    assert _reader("sync_idle_ms.train").read(_window(trace)) is None
