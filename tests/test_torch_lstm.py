"""PyTorch port: the fused-direction BiLSTM and the K1 recurrence wrapper.

The plain recurrence is held against the JAX Pallas kernel run in interpret
mode (as tests/test_lstm_pallas.py runs it) and against the JAX scan
BiLSTM, at atol 1e-5 in fp32; a stack with loaded weights against
torch.nn.LSTM. The hand-written kernel is held against the plain version on
the card in tests/test_torch_gpu.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from music_transcription_tpu.ops import lstm as JL
from music_transcription_tpu.ops import lstm_pallas as JLP
from music_transcription_tpu_torch.ops import lstm as L
from music_transcription_tpu_torch.ops import lstm_kernel as LK

ATOL = 1e-5  # fp32, same math, another summation order


@pytest.fixture
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _torch_layers(jax_layers):
    return [{k: torch.from_numpy(np.array(v)) for k, v in layer.items()} for layer in jax_layers]


@pytest.mark.parametrize("b,t,h", [(3, 17, 8), (1, 9, 16), (2, 1, 4)])
def test_plain_recurrence_matches_pallas_interpret(interpret_pallas, b, t, h):
    rng = np.random.default_rng(b * 100 + t)
    xw = rng.standard_normal((2 * b, t, 4 * h)).astype(np.float32)
    wh = (0.5 * rng.standard_normal((2, h, 4 * h))).astype(np.float32)
    ref = np.asarray(JLP.lstm_recurrence_pallas(jnp.asarray(xw), jnp.asarray(wh)))
    got = LK.lstm_recurrence_plain(torch.from_numpy(xw), torch.from_numpy(wh)).numpy()
    assert got.shape == ref.shape == (2 * b, t, h)
    assert np.abs(got - ref).max() < ATOL


def test_wrapper_takes_plain_version_for_cpu_tensors():
    rng = np.random.default_rng(1)
    xw = torch.from_numpy(rng.standard_normal((4, 7, 32)).astype(np.float32))
    wh = torch.from_numpy(rng.standard_normal((2, 8, 32)).astype(np.float32))
    before = LK.lstm_recurrence.launches
    assert torch.equal(LK.lstm_recurrence(xw, wh), LK.lstm_recurrence_plain(xw, wh))
    assert LK.lstm_recurrence.launches == before  # no kernel launch on the CPU


@pytest.mark.parametrize("proj_dtype", ["float32", "bfloat16"])
def test_bilstm_layer_matches_jax(proj_dtype):
    rng = np.random.default_rng(2)
    params = JL.init_bilstm_params(jax.random.key(0), 12, 8, 1)
    x = rng.standard_normal((3, 17, 12)).astype(np.float32)
    ref = np.asarray(JL.bilstm_layer(jnp.asarray(x), params[0], proj_dtype=jnp.dtype(proj_dtype)))
    got = L.bilstm_layer(torch.from_numpy(x), _torch_layers(params)[0],
                         proj_dtype=getattr(torch, proj_dtype),
                         recurrence=LK.lstm_recurrence_plain).numpy()
    assert got.shape == (3, 17, 16)
    assert np.abs(got - ref).max() < ATOL


def test_bilstm_stack_matches_jax_scan_and_pallas(interpret_pallas):
    rng = np.random.default_rng(3)
    params = JL.init_bilstm_params(jax.random.key(1), 10, 8, 2)
    x = rng.standard_normal((2, 9, 10)).astype(np.float32)
    got = L.bilstm_stack(torch.from_numpy(x), _torch_layers(params)).numpy()
    for ref in (JL.bilstm_stack(jnp.asarray(x), params),
                JLP.bilstm_stack_pallas(jnp.asarray(x), params)):
        assert np.abs(got - np.asarray(ref)).max() < ATOL


def test_bilstm_stack_matches_torch_lstm():
    torch.manual_seed(0)
    i, h, b, t, layers = 12, 16, 2, 11, 2
    lstm = torch.nn.LSTM(i, h, num_layers=layers, batch_first=True, bidirectional=True)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((b, t, i)).astype(np.float32))
    with torch.no_grad():
        ref, _ = lstm(x)
        stack = []
        for li in range(layers):
            layer = {}
            for d, sfx in (("fwd", ""), ("bwd", "_reverse")):
                layer[f"wi_{d}"] = getattr(lstm, f"weight_ih_l{li}{sfx}").t()
                layer[f"wh_{d}"] = getattr(lstm, f"weight_hh_l{li}{sfx}").t()
                layer[f"b_{d}"] = getattr(lstm, f"bias_ih_l{li}{sfx}") + getattr(lstm, f"bias_hh_l{li}{sfx}")
            stack.append(layer)
        got = L.bilstm_stack(x, stack)
    assert np.abs(got.numpy() - ref.numpy()).max() < 2e-5


def test_inter_layer_dropout_only_in_training():
    rng = np.random.default_rng(5)
    params = _torch_layers(JL.init_bilstm_params(jax.random.key(2), 6, 4, 2))
    x = torch.from_numpy(rng.standard_normal((2, 5, 6)).astype(np.float32))
    base = L.bilstm_stack(x, params, dropout_rate=0.5, training=False)
    assert torch.equal(base, L.bilstm_stack(x, params))
    torch.manual_seed(0)
    assert not torch.equal(base, L.bilstm_stack(x, params, dropout_rate=0.5, training=True))
    one = params[:1]  # no dropout after the last layer
    assert torch.equal(L.bilstm_stack(x, one, dropout_rate=0.5, training=True), L.bilstm_stack(x, one))

