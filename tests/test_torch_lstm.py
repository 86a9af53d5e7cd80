"""PyTorch port: the fused-direction BiLSTM and the recurrence wrappers
(K1; K2a/K2b and the ``LSTMRecurrence`` autograd Function).

The plain recurrence is held against the JAX Pallas kernel run in interpret
mode (as tests/test_lstm_pallas.py runs it) and against the JAX scan
BiLSTM, at atol 1e-5 in fp32; a stack with loaded weights against
torch.nn.LSTM. K2a's plain version (h and c) is held against
``_lstm_recurrence_fwd_impl``, K2b's and ``LSTMRecurrence``'s gradients
against the JAX custom VJP (``jax.grad`` through ``lstm_recurrence``), within
1e-5 of the gradient's largest magnitude, and against autograd through the
plain forward. The faulty plain versions (a barrier that races) must miss
JAX by more than the card checks' tolerances. The hand-written kernels are
held against the plain versions on the card in tests/test_torch_gpu.py.
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

    def gen():
        return torch.Generator().manual_seed(0)

    dropped = L.bilstm_stack(x, params, dropout_rate=0.5, training=True, generator=gen())
    assert not torch.equal(base, dropped)
    # the masks come from the generator passed in, and only from it
    assert torch.equal(dropped, L.bilstm_stack(x, params, dropout_rate=0.5, training=True,
                                               generator=gen()))
    with pytest.raises(ValueError, match="explicit torch.Generator"):
        L.bilstm_stack(x, params, dropout_rate=0.5, training=True)
    one = params[:1]  # no dropout after the last layer
    assert torch.equal(L.bilstm_stack(x, one, dropout_rate=0.5, training=True, generator=gen()),
                       L.bilstm_stack(x, one))


def _recurrence_inputs(b, t, h, seed):
    rng = np.random.default_rng(seed)
    xw = rng.standard_normal((2 * b, t, 4 * h)).astype(np.float32)
    wh = (0.5 * rng.standard_normal((2, h, 4 * h))).astype(np.float32)
    dh = rng.standard_normal((2 * b, t, h)).astype(np.float32)
    return xw, wh, dh


def _close(got, ref, rel=1e-5):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= rel * max(1.0, np.abs(ref).max())


SHAPES = [(3, 17, 8), (1, 9, 16), (2, 1, 4)]


@pytest.mark.parametrize("b,t,h", SHAPES)
def test_k2a_plain_matches_pallas_fwd_impl(interpret_pallas, b, t, h):
    xw, wh, _ = _recurrence_inputs(b, t, h, seed=10 + t)
    ref_h, (_, _, c_tm, _) = JLP._lstm_recurrence_fwd_impl(jnp.asarray(xw), jnp.asarray(wh))
    got_h, got_c = LK.lstm_recurrence_fwd_plain(torch.from_numpy(xw), torch.from_numpy(wh))
    _close(got_h.numpy(), ref_h)
    _close(got_c.numpy(), np.swapaxes(np.asarray(c_tm)[:t], 0, 1))
    # the CPU wrapper is the plain version, with no launch counted
    before = LK.lstm_recurrence_fwd.launches
    h2, c2 = LK.lstm_recurrence_fwd(torch.from_numpy(xw), torch.from_numpy(wh))
    assert torch.equal(h2, got_h) and torch.equal(c2, got_c)
    assert LK.lstm_recurrence_fwd.launches == before


@pytest.mark.parametrize("b,t,h", SHAPES)
def test_k2b_plain_and_lstm_recurrence_match_jax_custom_vjp(interpret_pallas, b, t, h):
    xw, wh, dh = _recurrence_inputs(b, t, h, seed=20 + t)
    # the JAX package's custom VJP: K2b for dxw, the einsum for dW_hh
    _, residuals = JLP._lstm_recurrence_fwd(jnp.asarray(xw), jnp.asarray(wh))
    ref_dxw, ref_dwh = JLP._lstm_recurrence_bwd(residuals, jnp.asarray(dh))
    # and jax.grad through it
    grad_xw, grad_wh = jax.grad(lambda a, w: jnp.sum(JLP.lstm_recurrence(a, w) * dh),
                                argnums=(0, 1))(jnp.asarray(xw), jnp.asarray(wh))
    _close(grad_xw, ref_dxw)
    _close(grad_wh, ref_dwh)

    txw, twh, tdh = (torch.from_numpy(a) for a in (xw, wh, dh))
    h_seq, c_seq = LK.lstm_recurrence_fwd_plain(txw, twh)
    dxw = LK.lstm_recurrence_bwd_plain(txw, twh, h_seq, c_seq, tdh)
    _close(dxw.numpy(), ref_dxw)
    _close(LK.recurrent_weight_grad(h_seq, dxw).numpy(), ref_dwh)

    a, w = txw.clone().requires_grad_(), twh.clone().requires_grad_()
    before = LK.lstm_recurrence_bwd.launches
    got_xw, got_wh = torch.autograd.grad(LK.LSTMRecurrence.apply(a, w), (a, w), tdh)
    assert LK.lstm_recurrence_bwd.launches == before  # CPU: the plain version
    _close(got_xw.numpy(), grad_xw)
    _close(got_wh.numpy(), grad_wh)


@pytest.mark.parametrize("b,t,h", SHAPES)
def test_lstm_recurrence_matches_autograd_through_plain(b, t, h):
    xw, wh, dh = (torch.from_numpy(a) for a in _recurrence_inputs(b, t, h, seed=30 + t))
    grads = []
    for fn in (LK.LSTMRecurrence.apply, LK.lstm_recurrence_plain):
        a, w = xw.clone().requires_grad_(), wh.clone().requires_grad_()
        out = fn(a, w)
        grads.append((out.detach(),) + torch.autograd.grad(out, (a, w), dh))
    for got, ref in zip(*grads):
        _close(got.numpy(), ref.numpy())


def test_recurrence_routes_on_grad_mode():
    """A gradient wanted -> LSTMRecurrence (its output has a grad_fn); under
    no_grad or inference_mode -> K1, as in serving."""
    xw, wh, _ = (torch.from_numpy(a) for a in _recurrence_inputs(1, 5, 4, seed=40))
    a, w = xw.clone().requires_grad_(), wh.clone().requires_grad_()
    out = LK.recurrence(a, w)
    assert out.grad_fn is not None and "LSTMRecurrence" in type(out.grad_fn).__name__
    with torch.no_grad():
        assert LK.recurrence(a, w).grad_fn is None
    with torch.inference_mode():
        assert torch.equal(LK.recurrence(a, w), LK.lstm_recurrence_plain(xw, wh))
    assert LK.recurrence(xw, wh).grad_fn is None



@pytest.mark.parametrize("b,t,h", [(3, 40, 16), (2, 24, 8)])
def test_faulty_plain_versions_fail_the_kernel_tolerances(interpret_pallas, b, t, h):
    """What K1/K2a and K2b would give with a barrier that lets one step run
    early (h_{t-2} read at step T // 2; the dh carry one step stale there):
    the plain versions agree with JAX's kernels, the faulty ones agree up to
    that step and then miss by more than the card's tolerances (1e-4 for h
    and c, 1e-4 of the largest |dxw|)."""
    xw, wh, dh = _recurrence_inputs(b, t, h, seed=50 + t)
    ref_h, (_, _, c_tm, _) = JLP._lstm_recurrence_fwd_impl(jnp.asarray(xw), jnp.asarray(wh))
    ref_h, ref_c = np.asarray(ref_h), np.swapaxes(np.asarray(c_tm)[:t], 0, 1)
    _, residuals = JLP._lstm_recurrence_fwd(jnp.asarray(xw), jnp.asarray(wh))
    ref_dxw = np.asarray(JLP._lstm_recurrence_bwd(residuals, jnp.asarray(dh))[0])

    txw, twh, tdh = (torch.from_numpy(a) for a in (xw, wh, dh))
    h_seq, c_seq = LK.lstm_recurrence_fwd_plain(txw, twh)
    _close(h_seq.numpy(), ref_h)
    _close(c_seq.numpy(), ref_c)
    fh, fc = LK.faulty_fwd_plain(txw, twh)
    assert torch.equal(fh[:, :t // 2], h_seq[:, :t // 2])
    assert max(np.abs(fh.numpy() - ref_h).max(), np.abs(fc.numpy() - ref_c).max()) > 1e-4

    dxw = LK.lstm_recurrence_bwd_plain(txw, twh, h_seq, c_seq, tdh)
    _close(dxw.numpy(), ref_dxw)
    faulty = LK.faulty_bwd_plain(txw, twh, h_seq, c_seq, tdh)
    assert torch.equal(faulty[:, t // 2 + 1:], dxw[:, t // 2 + 1:])
    assert np.abs(faulty.numpy() - ref_dxw).max() > 1e-4 * np.abs(ref_dxw).max()


def test_floor_runs_only_on_a_card():
    """The sequential floor has nothing to compute, so no plain version: on
    the CPU it raises instead of launching."""
    with pytest.raises(ValueError, match="CUDA device"):
        LK.lstm_recurrence_floor(8, 938, 512, device="cpu")
