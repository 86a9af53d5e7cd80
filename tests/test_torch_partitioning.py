"""PyTorch port: ZeRO-1 and FSDP at world 2 (two gloo ranks on the CPU,
``tests/_torch_dist_worker.py``), the counterparts of
tests/test_partitioning.py's ZeRO-1 and FSDP cases, their sharded bytes and
their NaN guard, and checkpoints that cross world sizes.

Numerics: the JAX tests' model (cnn_rnn, n_mels 16, hidden 8, 1 layer, here
fp32), weights and optimizer (``optax.sgd(0.1, momentum=0.9)``, torch's SGD
with momentum 0.9 on the port's side, no clip), 3 steps on one global batch
of 8, against the port's ``dp`` and JAX's ``jit_partitioned`` on a
2-device mesh, with JAX's bounds: the loss within 1e-5, parameters within
3e-4 (the BatchNorm running statistics within 1e-5 of their largest).
Checkpoints use the training optimizer, Adam at lr 1e-3, and the bounds of
tests/test_torch_train_step.py after a step.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_dist_worker import assert_close_state, spawn
from music_transcription_tpu.config import ModelConfig as JModelConfig
from music_transcription_tpu.models.transcription import TranscriptionModel as JModel
from music_transcription_tpu.parallel.mesh import make_mesh as j_make_mesh
from music_transcription_tpu.parallel.mesh import shard_batch as j_shard_batch
from music_transcription_tpu.parallel.partitioning import (
    jit_partitioned,
    shard_state,
    state_shardings,
)
from music_transcription_tpu.parallel.train_step import init_train_state, make_train_step
from music_transcription_tpu_torch import checkpoints as ckpt_lib
from music_transcription_tpu_torch.config import ModelConfig, TrainConfig
from music_transcription_tpu_torch.models.transcription import TranscriptionModel
from music_transcription_tpu_torch.parallel.train_step import TrainState, train_step
from music_transcription_tpu_torch.train.optim import make_optimizer

SGD_LR, ADAM_LR = 0.1, 1e-3
B, N_MELS, T = 8, 16, 12
CFG = dict(model_type="cnn_rnn", n_mels=N_MELS, hidden_size=8, num_layers=1, dropout=0.0,
           compute_dtype="float32")
MIN_LEAF = 512  # as tests/test_partitioning.py: the small leaves shard too
HOW = ("zero1", "fsdp")


def _port_sd(state):
    host = jax.tree.map(np.asarray, {"params": state["params"],
                                     "batch_stats": state["batch_stats"]})
    return ckpt_lib.state_dict_from_jax(host, ModelConfig(**CFG))


def _one_device(work):
    pm = TranscriptionModel(ModelConfig(**CFG))
    pm.model.load_state_dict(torch.load(work / "weights.pth"), strict=True)
    return TrainState(pm, make_optimizer(pm.parameters(), TrainConfig(learning_rate=ADAM_LR)))


def _torch_batch(data):
    return tuple(torch.from_numpy(data[f"a_{f}"]) for f in ("mel", "roll", "lengths"))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    work = tmp_path_factory.mktemp("partitioning")
    jm = JModel(JModelConfig(**CFG))
    tx = optax.sgd(SGD_LR, momentum=0.9)
    state0 = init_train_state(jm, tx, jax.random.key(0), jm.example_input(batch=1, t=T))
    torch.save(_port_sd(state0), work / "weights.pth")
    rng = np.random.default_rng(0)
    data = {"a_mel": rng.standard_normal((B, 1, N_MELS, T)).astype(np.float32),
            "a_roll": (rng.random((B, 88, T)) > 0.9).astype(np.float32),
            "a_lengths": np.full((B,), T, np.int32)}
    np.savez(work / "batches.npz", **data)

    # a one-device checkpoint after one Adam step, to resume at world 2
    one = _one_device(work)
    train_step(one, _torch_batch(data), 1, max_grad_norm=1.0)
    ckpt_lib.save_training_checkpoint(work / "one.pt", one.model.model.state_dict(),
                                      one.optimizer.state_dict(), one.step, 1, {})

    runs = [dict(name=f"{how}_sgd", partitioning=how, steps=3, batch="a", sgd=SGD_LR)
            for how in ("dp",) + HOW]
    runs += [dict(name=f"{how}_adam", partitioning=how, steps=2, batch="a",
                  save=str(work / f"{how}_adam.pt")) for how in ("dp",) + HOW]
    runs += [dict(name=f"{how}_resume", partitioning=how, steps=1, batch="a",
                  resume=str(work / "one.pt")) for how in HOW]
    (work / "spec.json").write_text(json.dumps(dict(model=CFG, lr=ADAM_LR, runs=runs,
                                                    nan=list(HOW))))
    _, outs = spawn("steps", work)

    mesh = j_make_mesh(2)
    batch = tuple(j_shard_batch(a, mesh) for a in (data["a_mel"], data["a_roll"],
                                                      data["a_lengths"]))
    ref = {}
    for how in HOW:
        shardings = state_shardings(state0, mesh, shard_params=how == "fsdp",
                                    min_leaf_size=MIN_LEAF)
        step = jit_partitioned(make_train_step(jm, tx), mesh, shardings)
        st, losses = shard_state(jax.tree.map(jnp.copy, state0), shardings), []
        for _ in range(3):
            st, m = step(st, batch, jax.random.key(2))
            losses.append(float(m["loss"]))
        ref[how] = (_port_sd(st), losses)
    return dict(work=work, data=data, ref=ref, outs=outs)


def _out(setup, name):
    return torch.load(setup["work"] / f"out_{name}.pt", weights_only=False)


def _assert_matches(got: dict, want: dict, atol: float = 3e-4):
    assert set(got) == set(want)
    for key, ref in want.items():
        diff = float((got[key].float() - ref.float()).abs().max())
        tol = 1e-5 * float(ref.abs().max()) if "running" in key else atol
        assert diff <= tol, (key, diff, tol)


@pytest.mark.parametrize("how", HOW)
def test_sharded_steps_match_dp_and_jax(setup, how):
    out, dp = _out(setup, f"{how}_sgd"), _out(setup, "dp_sgd")
    want_sd, want_losses = setup["ref"][how]
    losses = [m["loss"] for m in out["metrics"]]
    assert not any(m["skipped"] for m in out["metrics"]) and out["step"] == 3
    assert max(abs(a - b) for a, b in zip(losses, [m["loss"] for m in dp["metrics"]])) < 1e-5
    assert max(abs(a - b) for a, b in zip(losses, want_losses)) < 1e-5
    _assert_matches(out["model"], dp["model"])
    _assert_matches(out["model"], want_sd)


def test_sharded_bytes_fall_by_the_world_size(setup):
    """Each rank holds about half of the Adam state under ZeRO-1 (whole
    parameters' moments, balanced by size), and half of the parameters and
    the state under FSDP (every parameter's first axis split)."""
    (dp, _), zero1, fsdp = (_out(setup, f"{h}_adam")["bytes"] for h in ("dp",) + HOW)
    assert _out(setup, "dp_adam")["bytes"][1] == dp
    for sizes, sections in ((zero1, ("opt_state",)), (fsdp, ("params", "opt_state"))):
        for key in sections:
            share = [r[key] / dp[key] for r in sizes]
            assert all(0.35 <= s <= 0.65 for s in share), (key, share)
            assert abs(sum(share) - 1.0) < 0.02, (key, share)
    assert all(r["params"] == dp["params"] for r in zero1)  # ZeRO-1 keeps them whole


@pytest.mark.parametrize("how", HOW)
def test_nan_guard_skips_and_keeps_the_shards(setup, how):
    for out in setup["outs"]:
        line = next(ln for ln in out.splitlines() if ln.startswith(f"NAN_STEP_{how}="))
        m = json.loads(line.split("=", 1)[1])
        assert m["skipped"] == 1.0 and m["step"] == 2 and m["kept"] and m["kept_adam"]


@pytest.mark.parametrize("how", HOW)
def test_sharded_checkpoint_resumes_on_one_device(setup, how):
    """world 2 -> 1: the checkpoint is plain Adam's, loads strictly into a
    one-device state, and holds the moments that ``dp`` holds."""
    st = _one_device(setup["work"])
    step = ckpt_lib.load_training_checkpoint(setup["work"] / f"{how}_adam.pt", st.model.model,
                                             st.optimizer)
    assert step == 2
    out = _out(setup, f"{how}_adam")
    for k, v in st.model.model.state_dict().items():
        assert torch.equal(v, out["model"][k]), k
    dp = _out(setup, "dp_adam")["optimizer"]["state"]
    params = list(st.model.parameters())
    assert len(st.optimizer.state) == len(params) == len(dp)
    for i, p in enumerate(params):
        for k in ("exp_avg", "exp_avg_sq"):
            have, want = st.optimizer.state[p][k], dp[i][k]
            assert float((have - want).abs().max()) <= 1e-5 * float(want.abs().max()), (i, k)
        assert float(st.optimizer.state[p]["step"]) == 2.0


@pytest.mark.parametrize("how", HOW)
def test_one_device_checkpoint_resumes_at_world_2(setup, how):
    """world 1 -> 2: the shards hold the checkpoint's Adam state exactly
    (gathered back, it is the file's), and the next step matches the
    one-device continuation."""
    out = _out(setup, f"{how}_resume")
    saved = torch.load(setup["work"] / "one.pt", weights_only=False)["optimizer_state"]
    assert out["resumed_optimizer"]["param_groups"] == saved["param_groups"]
    for i, s in saved["state"].items():
        for k, v in s.items():
            assert torch.equal(out["resumed_optimizer"]["state"][i][k], v), (i, k)
    one = _one_device(setup["work"])
    one.step = ckpt_lib.load_training_checkpoint(setup["work"] / "one.pt", one.model.model,
                                                 one.optimizer)
    m = train_step(one, _torch_batch(setup["data"]), 1, max_grad_norm=1.0)
    assert out["step"] == one.step == 2
    assert abs(out["metrics"][0]["loss"] - m["loss"]) <= 1e-5 * abs(m["loss"])
    assert_close_state(out["model"], one.model.model.state_dict(), ADAM_LR)
