"""PyTorch port: tensor-parallel placement and the 2-D ``(data, model)``
mesh, the counterparts of tests/test_partitioning.py's 2-D and tp cases:
ZeRO-1, FSDP and TP on a (2, 2) mesh of 4 gloo ranks on the CPU and TP at
world 2 (``tests/_torch_dist_worker.py``), against the port's ``dp`` and
JAX's ``jit_partitioned`` on the same mesh; each parameter's shard dim
against JAX's ``state_shardings(strategy="tp")``; the global gradient norm
under HSDP; sharded bytes; checkpoints that cross between a (2, 2) mesh and
one device; and the training CLI at 2 ranks with ``--partitioning tp``.

Numerics as in tests/test_torch_partitioning.py: the JAX tests' model
(cnn_rnn, n_mels 16, hidden 8, 1 layer, here fp32), weights and optimizer
(``optax.sgd(0.1, momentum=0.9)``, torch's SGD with momentum 0.9, no clip),
3 steps on one global batch of 8, with JAX's bounds: the loss within 1e-5,
parameters within 3e-4, the BatchNorm running statistics within 1e-5 of
their largest. Checkpoints use Adam at lr 1e-3 and the bounds of
tests/test_torch_train_step.py after a step.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_dist_worker import assert_close_state, spawn
from music_transcription_tpu.config import ModelConfig as JModelConfig
from music_transcription_tpu.config import TrainConfig as JTrainConfig
from music_transcription_tpu.data.cache import HybridMaestroDataset as JDataset
from music_transcription_tpu.data.pipeline import Loader as JLoader
from music_transcription_tpu.models.transcription import TranscriptionModel as JModel
from music_transcription_tpu.parallel.distributed import ProcessShard as JProcessShard
from music_transcription_tpu.parallel.mesh import make_mesh as j_make_mesh
from music_transcription_tpu.parallel.mesh import shard_batch as j_shard_batch
from music_transcription_tpu.parallel.partitioning import (
    jit_partitioned,
    make_mesh_2d,
    shard_state,
    state_shardings,
)
from music_transcription_tpu.parallel.train_step import init_train_state, make_train_step
from music_transcription_tpu.train.optim import make_optimizer as j_make_optimizer
from music_transcription_tpu_torch import checkpoints as ckpt_lib
from music_transcription_tpu_torch.checkpoints import jax_axes
from music_transcription_tpu_torch.config import AudioConfig, ModelConfig, TrainConfig
from music_transcription_tpu_torch.config import config_to_dict
from music_transcription_tpu_torch.data import cache as C
from music_transcription_tpu_torch.models.transcription import TranscriptionModel
from music_transcription_tpu_torch.parallel.partitioning import tp_axis, tp_shard_dims
from music_transcription_tpu_torch.parallel.train_step import TrainState, train_step
from music_transcription_tpu_torch.train.optim import make_optimizer

SGD_LR, ADAM_LR = 0.1, 1e-3
B, N_MELS, T = 8, 16, 12
CFG = dict(model_type="cnn_rnn", n_mels=N_MELS, hidden_size=8, num_layers=1, dropout=0.0,
           compute_dtype="float32")
MIN_LEAF = 512  # as tests/test_partitioning.py
HOW = ("zero1", "fsdp", "tp")


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


def _jax_steps(jm, tx, state0, mesh, batch, how):
    shardings = state_shardings(state0, mesh, shard_params=how != "zero1",
                                min_leaf_size=MIN_LEAF,
                                strategy="tp" if how == "tp" else "fsdp")
    step = jit_partitioned(make_train_step(jm, tx), mesh, shardings)
    st, losses = shard_state(jax.tree.map(jnp.copy, state0), shardings), []
    for _ in range(3):
        st, m = step(st, tuple(j_shard_batch(a, mesh) for a in batch), jax.random.key(2))
        losses.append(float(m["loss"]))
    return _port_sd(st), losses


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    work = tmp_path_factory.mktemp("tp")
    jm = JModel(JModelConfig(**CFG))
    tx = optax.sgd(SGD_LR, momentum=0.9)
    state0 = init_train_state(jm, tx, jax.random.key(0), jm.example_input(batch=1, t=T))
    torch.save(_port_sd(state0), work / "weights.pth")
    rng = np.random.default_rng(0)
    data = {"a_mel": rng.standard_normal((B, 1, N_MELS, T)).astype(np.float32),
            "a_roll": (rng.random((B, 88, T)) > 0.9).astype(np.float32),
            "a_lengths": np.full((B,), T, np.int32)}
    np.savez(work / "batches.npz", **data)

    # a one-device checkpoint after one Adam step, to resume at (2, 2)
    one = _one_device(work)
    train_step(one, _torch_batch(data), 1, max_grad_norm=1.0)
    ckpt_lib.save_training_checkpoint(work / "one.pt", one.model.model.state_dict(),
                                      one.optimizer.state_dict(), one.step, 1, {})

    # 4 ranks: dp on the 1-D mesh, each placement on the (2, 2) mesh
    runs = [dict(name="dp_sgd", partitioning="dp", steps=3, batch="a", sgd=SGD_LR)]
    runs += [dict(name=f"{how}_2d_sgd", partitioning=how, mesh=[2, 2], steps=3, batch="a",
                  sgd=SGD_LR) for how in HOW]
    runs += [dict(name=f"{how}_2d_adam", partitioning=how, mesh=[2, 2], steps=1, batch="a",
                  save=str(work / f"{how}_2d_adam.pt")) for how in HOW]
    runs += [dict(name=f"{how}_2d_resume", partitioning=how, mesh=[2, 2], steps=1, batch="a",
                  resume=str(work / "one.pt")) for how in HOW]
    (work / "spec.json").write_text(json.dumps(dict(model=CFG, lr=ADAM_LR, runs=runs)))
    spawn("steps", work, world=4)
    # 2 ranks: tp on the 1-D mesh against dp, and its NaN guard
    work2 = work / "world2"
    work2.mkdir()
    for name in ("weights.pth", "batches.npz"):
        (work2 / name).write_bytes((work / name).read_bytes())
    runs = [dict(name=f"{how}_sgd", partitioning=how, steps=3, batch="a", sgd=SGD_LR)
            for how in ("dp", "tp")]
    (work2 / "spec.json").write_text(json.dumps(dict(model=CFG, lr=ADAM_LR, runs=runs,
                                                     nan=["tp"])))
    _, outs2 = spawn("steps", work2, world=2)

    batch = (data["a_mel"], data["a_roll"], data["a_lengths"])
    ref = {f"{how}_2d": _jax_steps(jm, tx, state0, make_mesh_2d(2, 2), batch, how)
           for how in HOW}
    ref["tp"] = _jax_steps(jm, tx, state0, j_make_mesh(2), batch, "tp")
    return dict(work=work, work2=work2, data=data, ref=ref, outs2=outs2, state0=state0)


def _out(work, name):
    return torch.load(work / f"out_{name}.pt", weights_only=False)


def _assert_matches(got: dict, want: dict, atol: float = 3e-4):
    assert set(got) == set(want)
    for key, ref in want.items():
        diff = float((got[key].float() - ref.float()).abs().max())
        tol = 1e-5 * float(ref.abs().max()) if "running" in key else atol
        assert diff <= tol, (key, diff, tol)


@pytest.mark.parametrize("name", ["zero1_2d", "fsdp_2d", "tp_2d", "tp"])
def test_placements_match_dp_and_jax(setup, name):
    work = setup["work2"] if name == "tp" else setup["work"]
    out, dp = _out(work, f"{name}_sgd"), _out(work, "dp_sgd")
    want_sd, want_losses = setup["ref"][name]
    losses = [m["loss"] for m in out["metrics"]]
    assert not any(m["skipped"] for m in out["metrics"]) and out["step"] == 3
    assert max(abs(a - b) for a, b in zip(losses, [m["loss"] for m in dp["metrics"]])) < 1e-5
    assert max(abs(a - b) for a, b in zip(losses, want_losses)) < 1e-5
    _assert_matches(out["model"], dp["model"])
    _assert_matches(out["model"], want_sd)


def _jax_dims(state0, mesh):
    """JAX's tp spec of each parameter as the torch parameter's shard dim
    (None: replicated), by the port's names: each leaf filled with its
    spec's sharded axis goes through state_dict_from_jax, whose layouts
    jax_axes reads back."""
    shardings = state_shardings(state0, mesh, shard_params=True, min_leaf_size=MIN_LEAF,
                                strategy="tp")
    axis = jax.tree.map(lambda s: next((i for i, a in enumerate(s.spec) if a), -1),
                        shardings["params"])
    filled = jax.tree.map(lambda x, a: np.full(np.shape(x), a, np.float32),
                          state0["params"], axis)
    spec_sd = ckpt_lib.state_dict_from_jax({"params": filled}, ModelConfig(**CFG))
    module = TranscriptionModel(ModelConfig(**CFG)).model
    owners = dict(module.named_modules())
    dims = {}
    for name, p in module.named_parameters():
        a = int(spec_sd[name].reshape(-1)[0])
        dims[name] = None if a < 0 else jax_axes(owners[name.rpartition(".")[0]], p)[a]
    return dims


@pytest.mark.parametrize("mesh_shape", [(2,), (2, 2)])
def test_tp_shard_dims_are_jax_tp_specs_in_torch_layout(setup, mesh_shape):
    """Each parameter JAX shards (at or above its 512-element floor) shards
    on the dim that holds JAX's axis; the port's rule is JAX's own, applied
    to every leaf; and the ranks' parameters lie on those dims."""
    mesh = j_make_mesh(2) if len(mesh_shape) == 1 else make_mesh_2d(*mesh_shape)
    want = _jax_dims(setup["state0"], mesh)
    module = TranscriptionModel(ModelConfig(**CFG)).model
    got = tp_shard_dims(module, 2)
    sizes = {n: p.numel() for n, p in module.named_parameters()}
    assert set(got) == set(want)
    checked = 0
    for name, dim in want.items():
        if sizes[name] >= MIN_LEAF:
            assert got[name] == (0 if dim is None else dim), (name, got[name], dim)
            checked += dim is not None
    assert checked >= 4  # the conv, LSTM and dense kernels
    work = setup["work2"] if len(mesh_shape) == 1 else setup["work"]
    name = "tp_sgd" if len(mesh_shape) == 1 else "tp_2d_sgd"
    assert _out(work, name)["shard_dims"] == got


def test_tp_axis_is_jax_leaf_spec_tp():
    from music_transcription_tpu.parallel.partitioning import _leaf_spec_tp

    for shape in [(3, 3, 1, 32), (4096, 33), (7, 3, 128, 256), (5,), (3, 3), (88, 6), (6, 88, 3)]:
        for n in (2, 3, 4):
            spec = _leaf_spec_tp(shape, n, "model", 0)
            want = next((i for i, a in enumerate(spec) if a is not None), None)
            assert tp_axis(shape, n) == want, (shape, n)


@pytest.mark.parametrize("how", HOW)
def test_global_gradient_norm_under_the_2d_mesh(setup, how):
    """The norm the guard and the clip see is the global gradient's: model
    shards summed once, the replicated data axis not counted twice."""
    one = _one_device(setup["work"])
    m = train_step(one, _torch_batch(setup["data"]), 1, max_grad_norm=1.0)
    got = _out(setup["work"], f"{how}_2d_adam")["metrics"][0]["grad_norm"]
    assert abs(got - m["grad_norm"]) <= 1e-6 * m["grad_norm"], (got, m["grad_norm"])


def test_sharded_bytes_fall_by_the_model_axis(setup):
    """On the (2, 2) mesh each rank holds about half (n_model = 2, not the
    world of 4) of what dp holds: the moments under ZeRO-1, the parameters
    and moments under FSDP and TP."""
    dp = _out(setup["work"], "dp_sgd")["bytes"][0]
    for how, sections in (("zero1", ("opt_state",)), ("fsdp", ("params", "opt_state")),
                          ("tp", ("params", "opt_state"))):
        sizes = _out(setup["work"], f"{how}_2d_sgd")["bytes"]
        for key in sections:
            share = [r[key] / dp[key] for r in sizes]
            assert all(0.35 <= s <= 0.65 for s in share), (how, key, share)
            # model peers split the state; the two data rows hold the same
            assert abs(share[0] + share[1] - 1.0) < 0.02 and share[:2] == share[2:], share


@pytest.mark.parametrize("how", HOW)
def test_2d_checkpoint_resumes_on_one_device(setup, how):
    """(2, 2) -> 1 after one Adam step: the checkpoint is plain Adam's,
    loads strictly into a one-device state, holds what the ranks gathered,
    and the state and moments of the same step taken on one device."""
    st = _one_device(setup["work"])
    step = ckpt_lib.load_training_checkpoint(setup["work"] / f"{how}_2d_adam.pt",
                                             st.model.model, st.optimizer)
    assert step == 1
    out = _out(setup["work"], f"{how}_2d_adam")
    for k, v in st.model.model.state_dict().items():
        assert torch.equal(v, out["model"][k]), k
    params = list(st.model.parameters())
    assert len(st.optimizer.state) == len(params)
    ref = _one_device(setup["work"])
    train_step(ref, _torch_batch(setup["data"]), 1, max_grad_norm=1.0)
    assert_close_state(out["model"], ref.model.model.state_dict(), ADAM_LR)
    for k in ("exp_avg", "exp_avg_sq"):
        # within 1e-5 of the tensor's largest moment, and 1e-6 of the model's
        # (a BatchNorm-fed bias's gradient is 0 up to rounding: its moments too)
        wants = [ref.optimizer.state[q][k] for q in ref.model.parameters()]
        floor = 1e-6 * max(float(w.abs().max()) for w in wants)
        for i, (p, want) in enumerate(zip(params, wants)):
            diff = float((st.optimizer.state[p][k] - want).abs().max())
            assert diff <= 1e-5 * float(want.abs().max()) + floor, (i, k, diff)


@pytest.mark.parametrize("how", HOW)
def test_one_device_checkpoint_resumes_on_the_2d_mesh(setup, how):
    """1 -> (2, 2): the shards hold the checkpoint's Adam state exactly
    (gathered back, it is the file's), and the next step matches the
    one-device continuation."""
    out = _out(setup["work"], f"{how}_2d_resume")
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


def test_tp_nan_guard_skips_and_keeps_the_shards(setup):
    for out in setup["outs2"]:
        line = next(ln for ln in out.splitlines() if ln.startswith("NAN_STEP_tp="))
        m = json.loads(line.split("=", 1)[1])
        assert m["skipped"] == 1.0 and m["step"] == 2 and m["kept"] and m["kept_adam"]


# the training CLI at 2 ranks with --partitioning tp

CLI_MELS, CHUNK, LR, GLOBAL_BATCH = 16, 1.0, 1e-3, 4


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    work = tmp_path_factory.mktemp("tp_cli")
    cache = work / "cache"
    acfg = AudioConfig(n_mels=CLI_MELS, chunk_length=CHUNK)
    t = acfg.mel_frames_per_chunk
    rng = np.random.default_rng(0)
    for split, n in (("train", 8), ("validation", 4)):
        for i in range(n):
            n_frames = t - 3 * (i % 3)
            C.save_chunk(cache / split, i, {
                "mel": (rng.standard_normal((CLI_MELS, n_frames)) * 10 - 40).astype(np.float32),
                "roll": (rng.random((88, n_frames)) > 0.9).astype(np.uint8)})
        C.save_metadata(cache, split, {"num_chunks": n, "chunk_length": CHUNK, "overlap": 0.0,
                                       "n_mels": CLI_MELS, "sr": acfg.sample_rate,
                                       "hop_length": acfg.hop_length})
    jm = JModel(JModelConfig(**CFG))
    tx = j_make_optimizer(JTrainConfig(learning_rate=LR, batch_size=GLOBAL_BATCH))
    state = init_train_state(jm, tx, jax.random.key(0), jm.example_input(batch=1, t=t))
    weights = work / "weights.pth"
    torch.save(_port_sd(state), weights)
    ckpt_lib.write_sidecar(weights, {"model": CFG, "audio": config_to_dict(acfg), "step": 0})
    for rank, run in ((0, work / "run"), (1, work / "run_rank1")):
        argv = ["--cache_dir", str(cache), "--root_dir", str(work / "no_raw"),
                "--model_type", "cnn_rnn", "--n_mels", str(CLI_MELS), "--hidden_size", "8",
                "--num_layers", "1", "--dropout", "0", "--compute_dtype", "float32",
                "--chunk_length", str(CHUNK), "--batch_size", str(GLOBAL_BATCH),
                "--lr", str(LR), "--num_workers", "0", "-d", "cpu", "--save_every", "1",
                "--run_dir", str(run), "--epochs", "2", "--resume", str(weights),
                "--partitioning", "tp"]
        (work / f"argv_{rank}.json").write_text(json.dumps({"argv": argv}))
    _, outs = spawn("cli", work)

    step = jax.jit(make_train_step(jm, tx))
    data = JDataset(str(cache), str(cache), "train", chunk_length=CHUNK, verbose=False)
    loaders = [JLoader(JProcessShard(data, p, 2), GLOBAL_BATCH // 2, shuffle=True, seed=0,
                       num_workers=0, drop_last=True, pad_to=t) for p in range(2)]
    ref = []
    for _ in range(2):
        for parts in zip(*loaders):
            batch = tuple(np.concatenate(cols) for cols in zip(*parts))
            state, m = step(state, batch, jax.random.key(1))
            ref.append(float(m["loss"]))
    return dict(work=work, outs=outs, ref=ref)


def test_two_rank_tp_cli_matches_jax_single_process(cli_run):
    per_rank = []
    for out in cli_run["outs"]:
        line = next(ln for ln in out.splitlines() if ln.startswith("LOSSES="))
        per_rank.append([float(v) for v in line.removeprefix("LOSSES=").split(",") if v])
    assert per_rank[0] == per_rank[1] and len(per_rank[0]) == 4
    np.testing.assert_allclose(per_rank[0], cli_run["ref"], atol=5e-5)
    assert "mesh {'data': 2} (tp, gloo)" in cli_run["outs"][0]
    work = cli_run["work"]
    assert not (work / "run_rank1").exists()
    final = torch.load(work / "run" / "checkpoints" / "model_final.pt", weights_only=False)
    assert final["step"] == 4
    plain = TranscriptionModel(ModelConfig(**CFG))
    plain.model.load_state_dict(final["model_state"], strict=True)  # gathered whole
    assert os.path.exists(work / "run" / "checkpoints" / "model_best.pth")
