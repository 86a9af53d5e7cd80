"""PyTorch port: the data-parallel train and eval steps at world 2 (two gloo
ranks on the CPU, ``tests/_torch_dist_worker.py``) against the JAX
package's ``jit_data_parallel(make_train_step(...), make_mesh(2))`` and
``make_eval_step_shardmap`` on a 2-device mesh, and against the port's own
one-process step.

A small cnn_rnn_large (n_mels 32, hidden 16, 2 layers, fp32), JAX's
weights crossed over with ``state_dict_from_jax``, a global batch of 8 (4
rows a rank), dropout 0 in both packages. The bounds are those of
tests/test_torch_train_step.py: the loss within 1e-5 relative, BatchNorm
running statistics within 1e-5 of each tensor's largest magnitude,
parameters after an Adam step within 2 lr and all but 1 in 200 within
1e-2 lr. Two broken runs show the bounds can see what they guard: with
sync-BN off the running statistics fail theirs, and on a batch whose ranks
hold different valid lengths a plain average of the ranks' losses fails
the loss bound where the frame-weighted step holds it.
"""

import json

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist_worker import assert_close_state, spawn
from music_transcription_tpu.config import ModelConfig as JModelConfig
from music_transcription_tpu.config import TrainConfig as JTrainConfig
from music_transcription_tpu.models.transcription import TranscriptionModel as JModel
from music_transcription_tpu.parallel.mesh import make_mesh as j_make_mesh
from music_transcription_tpu.parallel.mesh import replicate as j_replicate
from music_transcription_tpu.parallel.mesh import shard_batch as j_shard_batch
from music_transcription_tpu.parallel.train_step import (
    init_train_state,
    jit_data_parallel,
    make_eval_step,
    make_eval_step_shardmap,
    make_train_step,
)
from music_transcription_tpu.train.optim import make_optimizer as j_make_optimizer
from music_transcription_tpu_torch.checkpoints import state_dict_from_jax
from music_transcription_tpu_torch.config import ModelConfig, TrainConfig
from music_transcription_tpu_torch.models.cnn_rnn import CNNRNNLarge
from music_transcription_tpu_torch.models.transcription import TranscriptionModel
from music_transcription_tpu_torch.parallel.train_step import TrainState, train_step
from music_transcription_tpu_torch.train.optim import make_optimizer

LR = 1e-3
B, N_MELS, T = 8, 32, 24
CFG = dict(model_type="cnn_rnn_large", n_mels=N_MELS, hidden_size=16, num_layers=2,
           dropout=0.0, compute_dtype="float32", lstm_backend="scan")


def _batches():
    rng = np.random.default_rng(0)
    out = {}
    # rank 1's rows of "u" hold far fewer valid frames than rank 0's
    for key, lengths in (("a", [T] * B), ("u", [T, T, T - 2, T, 6, 3, 12, 1])):
        out[f"{key}_mel"] = (rng.standard_normal((B, 1, N_MELS, T)) * 10).astype(np.float32)
        out[f"{key}_roll"] = (rng.random((B, 88, T)) > 0.9).astype(np.float32)
        out[f"{key}_lengths"] = np.array(lengths, np.int32)
    # rank 1's two rows are padding: zeros of length 0
    mel = (rng.standard_normal((4, 1, N_MELS, T)) * 10).astype(np.float32)
    roll = (rng.random((4, 88, T)) > 0.9).astype(np.float32)
    mel[2:], roll[2:] = 0.0, 0.0
    out.update(eval_mel=mel, eval_roll=roll, eval_lengths=np.array([T, 17, 0, 0], np.int32))
    return out


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _port_sd(state):
    return state_dict_from_jax(_host({"params": state["params"],
                                      "batch_stats": state["batch_stats"]}), ModelConfig(**CFG))


def _jbatch(data, key):
    return tuple(data[f"{key}_{f}"] for f in ("mel", "roll", "lengths"))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """JAX's state and steps, dropout the identity, and the ranks' runs."""
    mp = pytest.MonkeyPatch()
    mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    mp.setattr(CNNRNNLarge, "CHANNEL_DROPOUT", (0.0, 0.0, 0.0))
    work = tmp_path_factory.mktemp("dp")
    jm = JModel(JModelConfig(**CFG))
    tx = j_make_optimizer(JTrainConfig(learning_rate=LR))
    state0 = init_train_state(jm, tx, jax.random.key(0), jm.example_input(batch=1, t=T))
    torch.save(_port_sd(state0), work / "weights.pth")
    data = _batches()
    np.savez(work / "batches.npz", **data)
    runs = [dict(name="dp_a", partitioning="dp", steps=1, batch="a"),
            dict(name="nosync_a", partitioning="dp", steps=1, batch="a", sync_bn=False),
            dict(name="dp_u", partitioning="dp", steps=1, batch="u"),
            dict(name="plain_u", partitioning="dp", steps=1, batch="u", plain_average=True)]
    (work / "spec.json").write_text(json.dumps(dict(model=CFG, lr=LR, runs=runs, eval=True,
                                                    nan=["dp"])))
    _, outs = spawn("steps", work)

    mesh = j_make_mesh(2)
    step = jit_data_parallel(make_train_step(jm, tx), mesh, donate_state=False)
    ref = {}
    for key in ("a", "u"):
        batch = tuple(j_shard_batch(a, mesh) for a in _jbatch(data, key))
        s1, m1 = step(j_replicate(state0, mesh), batch, jax.random.key(1))
        ref[key] = (_port_sd(s1), {k: float(v) for k, v in m1.items()})
    yield dict(work=work, jm=jm, state0=state0, data=data, ref=ref, mesh=mesh,
               outs=outs)
    mp.undo()


def _out(setup, name):
    return torch.load(setup["work"] / f"out_{name}.pt", weights_only=False)


def _rel(a, b):
    return abs(a - b) / abs(b)


def test_world2_dp_step_matches_jax_data_parallel(setup):
    out = _out(setup, "dp_a")
    sd_ref, m_ref = setup["ref"]["a"]
    (m,) = out["metrics"]
    assert m["skipped"] == 0.0 and out["step"] == 1
    assert _rel(m["loss"], m_ref["loss"]) <= 1e-5
    assert _rel(m["grad_norm"], m_ref["grad_norm"]) <= 1e-4
    assert_close_state(out["model"], sd_ref, LR)


def test_world2_dp_step_matches_one_process_step(setup):
    pm = TranscriptionModel(ModelConfig(**CFG))
    pm.model.load_state_dict(torch.load(setup["work"] / "weights.pth"), strict=True)
    st = TrainState(pm, make_optimizer(pm.parameters(), TrainConfig(learning_rate=LR)))
    m = train_step(st, tuple(torch.from_numpy(a) for a in _jbatch(setup["data"], "a")), 1,
                   max_grad_norm=1.0)
    out = _out(setup, "dp_a")
    assert _rel(out["metrics"][0]["loss"], m["loss"]) <= 1e-5
    assert_close_state(out["model"], pm.model.state_dict(), LR)


def _stats_err(got, ref):
    return max(float((got[k] - ref[k]).abs().max()) / float(ref[k].abs().max())
               for k in ref if "running" in k)


def test_sync_bn_is_needed(setup):
    """Without sync-BN each rank's running statistics follow its own rows:
    they fail the bound that the synced ones hold."""
    sd_ref, _ = setup["ref"]["a"]
    assert _stats_err(_out(setup, "dp_a")["model"], sd_ref) <= 1e-5
    assert _stats_err(_out(setup, "nosync_a")["model"], sd_ref) > 1e-5


def test_frame_weighting_is_needed(setup):
    """Rank 1's rows of batch "u" hold 22 valid frames to rank 0's 94: the
    frame-weighted step matches JAX's global masked loss, a plain average
    of the ranks' losses does not."""
    sd_ref, m_ref = setup["ref"]["u"]
    out = _out(setup, "dp_u")
    assert _rel(out["metrics"][0]["loss"], m_ref["loss"]) <= 1e-5
    assert_close_state(out["model"], sd_ref, LR)
    plain = _out(setup, "plain_u")
    assert _rel(plain["metrics"][0]["loss"], m_ref["loss"]) > 1e-5


def test_eval_step_with_an_all_padding_shard_matches_jax(setup):
    jm, state0, mesh = setup["jm"], setup["state0"], setup["mesh"]
    batch = _jbatch(setup["data"], "eval")
    sharded = tuple(j_shard_batch(a, mesh) for a in batch)
    ref = float(make_eval_step_shardmap(jm, mesh)(j_replicate(state0, mesh), sharded))
    ref_global = float(jax.jit(make_eval_step(jm))(state0, tuple(jnp.asarray(a) for a in batch)))
    got = [float(next(ln for ln in out.splitlines() if ln.startswith("EVAL_LOSS="))
                 .split("=")[1]) for out in setup["outs"]]
    assert got[0] == got[1]
    assert _rel(got[0], ref) <= 1e-5 and _rel(got[0], ref_global) <= 1e-5


def test_nan_guard_at_world_2_skips_on_every_rank(setup):
    """A NaN in rank 1's rows: every rank skips, and the parameters, the
    BatchNorm statistics and the Adam state stay as they were."""
    for out in setup["outs"]:
        line = next(ln for ln in out.splitlines() if ln.startswith("NAN_STEP_dp="))
        m = json.loads(line.split("=", 1)[1])
        assert m["skipped"] == 1.0 and not np.isfinite(m["loss"]) and m["step"] == 2
        assert m["kept"] and m["kept_adam"]
