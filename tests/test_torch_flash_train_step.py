"""PyTorch port: a train step through the clamped flash attention
(``attention_backend="pallas"``) against the JAX package's
``make_train_step``, and against the port's own materialized-scores route.

The model, batch, weights and tolerances are those of
tests/test_torch_train_step.py (a small cnn_rnn_large, fp32, dropout 0 on
both sides, the JAX Pallas kernels in interpret mode), with the attention on
the flash route: on the CPU the port's step runs ``FlashAttentionClamped``
through the plain versions of K3 with lse, K4a and K4b. The port's gradients
on the two attention routes agree within 3e-5 absolute plus 1e-3 relative,
the JAX package's bound for its own pallas-vs-xla gradients.
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
from music_transcription_tpu.parallel.train_step import init_train_state, make_train_step
from music_transcription_tpu.train.optim import make_optimizer as j_make_optimizer
from music_transcription_tpu_torch.checkpoints import state_dict_from_jax
from music_transcription_tpu_torch.config import ModelConfig, TrainConfig
from music_transcription_tpu_torch.models.cnn_rnn import CNNRNNLarge
from music_transcription_tpu_torch.models.transcription import TranscriptionModel
from music_transcription_tpu_torch.ops import attention_kernel as AK
from music_transcription_tpu_torch.parallel.train_step import TrainState, dropout_generator, train_step
from music_transcription_tpu_torch.train.optim import make_optimizer
from tests.test_torch_train_step import LR, T, _assert_close_state, _batch, _host


def _cfg(attention="pallas"):
    return dict(model_type="cnn_rnn_large", n_mels=32, hidden_size=16, num_layers=2, dropout=0.0,
                compute_dtype="float32", lstm_backend="pallas", attention_backend=attention)


@pytest.fixture(scope="module")
def no_dropout():
    """Pallas in interpret mode; every dropout the identity in both packages."""
    mp = pytest.MonkeyPatch()
    mp.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    mp.setattr(CNNRNNLarge, "CHANNEL_DROPOUT", (0.0, 0.0, 0.0))
    yield
    mp.undo()


def _state_dict(state):
    return state_dict_from_jax(_host({"params": state["params"], "batch_stats": state["batch_stats"]}),
                               ModelConfig(**_cfg()))


def test_flash_step_matches_jax(no_dropout):
    jm = JModel(JModelConfig(**_cfg()))
    tx = j_make_optimizer(JTrainConfig(learning_rate=LR))
    state = init_train_state(jm, tx, jax.random.key(0), jm.example_input(batch=1, t=T))
    new_state, metrics = jax.jit(make_train_step(jm, tx))(
        state, tuple(jnp.asarray(a) for a in _batch()), jax.random.key(1))
    pm = TranscriptionModel(ModelConfig(**_cfg()))
    pm.model.load_state_dict(_state_dict(state), strict=True)
    st = TrainState(pm, make_optimizer(pm.parameters(), TrainConfig(learning_rate=LR)))
    counters = (AK.flash_attention_clamped_fwd, AK.flash_attention_clamped_dq,
                AK.flash_attention_clamped_dkv)
    before = [c.launches for c in counters]
    m = train_step(st, tuple(torch.from_numpy(a) for a in _batch()), 1, max_grad_norm=1.0)
    assert [c.launches for c in counters] == before  # CPU tensors: the plain versions
    assert m["skipped"] == 0.0
    assert abs(m["loss"] - float(metrics["loss"])) <= 1e-5 * abs(float(metrics["loss"]))
    assert abs(m["grad_norm"] - float(metrics["grad_norm"])) <= 1e-4 * float(metrics["grad_norm"])
    _assert_close_state(pm.model.state_dict(), _state_dict(new_state))


def test_flash_route_gradients_match_materialized_route(no_dropout):
    torch.manual_seed(3)
    models = {route: TranscriptionModel(ModelConfig(**_cfg(route))) for route in ("xla", "pallas")}
    models["pallas"].load_state_dict(models["xla"].state_dict())
    mel, roll, lengths = (torch.from_numpy(a) for a in _batch())
    grads = {}
    for route, m in models.items():
        m.train()
        out = m(mel, return_all_heads=True, generator=dropout_generator(1, 0, "cpu"))
        m.loss(out, roll, lengths).backward()
        grads[route] = {k: p.grad for k, p in m.named_parameters()}
    assert float(grads["pallas"]["model.attention.qkv.weight"].abs().max()) > 0
    for name, ref in grads["xla"].items():
        np.testing.assert_allclose(grads["pallas"][name].numpy(), ref.numpy(), atol=3e-5,
                                   rtol=1e-3, err_msg=name)
