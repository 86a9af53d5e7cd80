"""PyTorch port: the train and eval steps against the JAX package's
``make_train_step`` / ``make_eval_step``.

A small cnn_rnn_large (n_mels 32, hidden 16, 2 layers) with
``lstm_backend="pallas"``, the JAX Pallas kernels in interpret mode (as
tests/test_lstm_pallas.py runs them), weights crossed over with
``state_dict_from_jax``. Dropout is 0 on both sides (the model's fixed
Dropout2d rates too): the two packages draw their masks from different
generators, so parity is held without them.

Tolerances: the loss within 1e-5 relative; BatchNorm running statistics
within 1e-5 of each tensor's largest magnitude; parameters after an Adam
step within 2 lr absolute: a gradient that is zero up to rounding (a
convolution's bias ahead of a BatchNorm has one) may take the other sign and
move its parameter by lr the other way; and all but 1 in 200 parameter
elements within 1e-2 lr, which a wrong gradient or Adam moment would not
meet. bf16 compute: the loss within 1e-3 relative, the running statistics
within 1e-3, the parameters within 2 lr and all but 1 in 20 within 1e-2 lr.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from music_transcription_tpu.config import ModelConfig as JModelConfig
from music_transcription_tpu.config import TrainConfig as JTrainConfig
from music_transcription_tpu.models.transcription import TranscriptionModel as JModel
from music_transcription_tpu.models.transcription import param_count
from music_transcription_tpu.parallel.train_step import init_train_state, make_eval_step, make_train_step
from music_transcription_tpu.train.optim import make_optimizer as j_make_optimizer
from music_transcription_tpu_torch.checkpoints import optimizer_state_from_jax, state_dict_from_jax
from music_transcription_tpu_torch.config import ModelConfig, TrainConfig
from music_transcription_tpu_torch.models.cnn_rnn import BiLSTMStack, CNNRNNLarge
from music_transcription_tpu_torch.models.transcription import TranscriptionModel
from music_transcription_tpu_torch.parallel.train_step import (
    TrainState,
    dropout_generator,
    eval_step,
    train_step,
)
from music_transcription_tpu_torch.train.optim import make_optimizer

LR = 1e-3
B, N_MELS, T = 2, 32, 24


def _cfg(dtype):
    return dict(model_type="cnn_rnn_large", n_mels=N_MELS, hidden_size=16, num_layers=2,
                dropout=0.0, compute_dtype=dtype, lstm_backend="pallas")


def _batch():
    rng = np.random.default_rng(0)
    # centred: flax's fast variance E[x^2] - E[x]^2 loses digits to
    # cancellation when |mean| >> std, in both packages alike
    mel = (rng.standard_normal((B, 1, N_MELS, T)) * 10).astype(np.float32)
    roll = (rng.random((B, 88, T)) > 0.9).astype(np.float32)
    return mel, roll, np.array([T, T - 5], np.int32)


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _port_state_dict(state, dtype):
    return state_dict_from_jax(_host({"params": state["params"],
                                      "batch_stats": state["batch_stats"]}),
                               ModelConfig(**_cfg(dtype)))


def _port(state, dtype, *, with_opt=False, step=0):
    """The port's TrainState holding the JAX state's weights (and Adam state)."""
    pm = TranscriptionModel(ModelConfig(**_cfg(dtype)))
    pm.model.load_state_dict(_port_state_dict(state, dtype), strict=True)
    opt = make_optimizer(pm.parameters(), TrainConfig(learning_rate=LR))
    if with_opt:
        opt.state.update(optimizer_state_from_jax(_host(state["opt_state"]),
                                                  ModelConfig(**_cfg(dtype)), pm.model))
    return TrainState(pm, opt, step=step)


def _torch_batch(batch):
    return tuple(torch.from_numpy(a) for a in batch)


@pytest.fixture(scope="module")
def no_dropout():
    """Pallas in interpret mode; every dropout the identity in both packages."""
    mp = pytest.MonkeyPatch()
    mp.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    mp.setattr(CNNRNNLarge, "CHANNEL_DROPOUT", (0.0, 0.0, 0.0))
    yield
    mp.undo()


def _jax_run(dtype, steps):
    jm = JModel(JModelConfig(**_cfg(dtype)))
    tx = j_make_optimizer(JTrainConfig(learning_rate=LR))
    states = [init_train_state(jm, tx, jax.random.key(0), jm.example_input(batch=1, t=T))]
    step = jax.jit(make_train_step(jm, tx))
    batch = tuple(jnp.asarray(a) for a in _batch())
    metrics = []
    for _ in range(steps):
        s, m = step(states[-1], batch, jax.random.key(1))
        states.append(s)
        metrics.append({k: float(v) for k, v in m.items()})
    return jm, states, metrics


@pytest.fixture(scope="module")
def jax_fp32(no_dropout):
    return _jax_run("float32", 2)


def _assert_close_state(got: dict, ref: dict, stats_rtol: float = 1e-5,
                        loose_share: float = 5e-3):
    loose = total = 0
    for key, want in ref.items():
        have = got[key]
        if "running" in key:
            tol = stats_rtol * float(want.abs().max())
        elif key.endswith("num_batches_tracked") or key.startswith("bias_hh") or ".bias_hh" in key:
            continue
        else:
            tol = 2 * LR
        diff = (have.float() - want.float()).abs()
        assert float(diff.max()) <= tol, (key, float(diff.max()), tol)
        if "running" not in key:
            loose += int((diff > 1e-2 * LR).sum())
            total += diff.numel()
    assert loose <= loose_share * total, (loose, total)


def test_trainable_parameter_count_equals_jax(jax_fp32):
    jm, states, _ = jax_fp32
    pm = _port(states[0], "float32").model
    n = sum(p.numel() for p in pm.parameters() if p.requires_grad)
    assert n == param_count(_host({"params": states[0]["params"]}))
    # one trainable bias per layer and direction; bias_hh is a buffer
    names = [k for k, _ in pm.named_parameters()]
    assert not [k for k in names if "bias_hh" in k]
    assert sum("rnn_main.bias_ih" in k for k in names) == 2 * 2


def test_one_step_matches_jax(jax_fp32):
    _, states, metrics = jax_fp32
    st = _port(states[0], "float32")
    m = train_step(st, _torch_batch(_batch()), 1, max_grad_norm=1.0)
    assert m["skipped"] == 0.0 and st.step == 1
    assert abs(m["loss"] - metrics[0]["loss"]) <= 1e-5 * abs(metrics[0]["loss"])
    assert abs(m["grad_norm"] - metrics[0]["grad_norm"]) <= 1e-4 * metrics[0]["grad_norm"]
    _assert_close_state(st.model.model.state_dict(), _port_state_dict(states[1], "float32"))


def test_second_step_continues_a_jax_state(jax_fp32):
    _, states, metrics = jax_fp32
    st = _port(states[1], "float32", with_opt=True, step=1)
    m = train_step(st, _torch_batch(_batch()), 1, max_grad_norm=1.0)
    assert abs(m["loss"] - metrics[1]["loss"]) <= 1e-5 * abs(metrics[1]["loss"])
    _assert_close_state(st.model.model.state_dict(), _port_state_dict(states[2], "float32"))


def test_eval_loss_matches_jax(jax_fp32):
    jm, states, _ = jax_fp32
    ref = float(jax.jit(make_eval_step(jm))(states[1], tuple(jnp.asarray(a) for a in _batch())))
    got = float(eval_step(_port(states[1], "float32").model, _torch_batch(_batch())))
    assert abs(got - ref) <= 1e-5 * abs(ref)


def test_bf16_step_matches_jax(no_dropout):
    _, states, metrics = _jax_run("bfloat16", 1)
    st = _port(states[0], "bfloat16")
    m = train_step(st, _torch_batch(_batch()), 1, max_grad_norm=1.0)
    assert abs(m["loss"] - metrics[0]["loss"]) <= 1e-3 * abs(metrics[0]["loss"])
    _assert_close_state(st.model.model.state_dict(), _port_state_dict(states[1], "bfloat16"),
                        stats_rtol=1e-3, loose_share=5e-2)


def test_nan_guard_keeps_parameters_adam_state_and_bn_statistics():
    torch.manual_seed(0)
    pm = TranscriptionModel(ModelConfig(**_cfg("float32")))
    st = TrainState(pm, make_optimizer(pm.parameters(), TrainConfig(learning_rate=LR)))
    good = _torch_batch(_batch())
    assert train_step(st, good, 1, max_grad_norm=1.0)["skipped"] == 0.0
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    adam = {id(p): {k: v.clone() for k, v in s.items()} for p, s in st.optimizer.state.items()}
    bad = (good[0].clone(), good[1], good[2])
    bad[0][0, 0, 3, 5] = float("nan")
    m = train_step(st, bad, 1, max_grad_norm=1.0)
    assert m["skipped"] == 1.0 and not np.isfinite(m["loss"])
    assert st.step == 2
    for k, v in pm.state_dict().items():
        assert torch.equal(v, before[k]), k
    for p, s in st.optimizer.state.items():
        for k, v in s.items():
            assert torch.equal(v, adam[id(p)][k])


def test_fresh_lstm_bias_is_a_sum_of_two_uniform_draws():
    torch.manual_seed(0)
    hidden = 64
    stack = BiLSTMStack(8, hidden, 1)
    k = 1.0 / np.sqrt(hidden)
    b = torch.cat([stack.bias_ih_l0, stack.bias_ih_l0_reverse]).detach()
    assert float(b.abs().max()) <= 2 * k
    # a single U(-k, k) draw never leaves [-k, k]; the sum of two often does
    assert float((b.abs() > k).float().mean()) > 0.05
    assert not stack.bias_hh_l0.any()


def test_loaded_bias_hh_is_folded_into_bias_ih():
    torch.manual_seed(1)
    ref = torch.nn.LSTM(6, 4, num_layers=2, batch_first=True, bidirectional=True)
    stack = BiLSTMStack(6, 4, 2)
    stack.load_state_dict(ref.state_dict(), strict=True)
    assert not any(b.any() for n, b in stack.named_buffers() if "bias_hh" in n)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 7, 6)).astype(np.float32))
    with torch.no_grad():
        got = stack.eval()(x, torch.float32)
        want, _ = ref(x)
    assert float((got - want).abs().max()) < 2e-5


def test_dropout_masks_follow_seed_and_step():
    torch.manual_seed(2)
    cfg = ModelConfig(**{**_cfg("float32"), "dropout": 0.2})
    pm = TranscriptionModel(cfg).train()
    x = torch.from_numpy(_batch()[0])

    def run(step):
        with torch.no_grad():
            return pm(x, return_all_heads=True, generator=dropout_generator(1, step, "cpu"))

    first, again, other = run(0), run(0), run(1)
    for head in ("frame", "onset", "offset"):
        assert torch.equal(first[head], again[head])
        assert not torch.equal(first[head], other[head])
    with pytest.raises(ValueError, match="explicit torch.Generator"):
        pm(x)
