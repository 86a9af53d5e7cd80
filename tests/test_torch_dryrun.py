"""PyTorch port: ``python -m music_transcription_tpu_torch.parallel.dryrun``,
the counterpart of ``__graft_entry__.dryrun_multichip``: at world 4 (gloo
ranks on the CPU) it exits 0 and prints every path's loss; from JAX's
weights (through ``state_dict_from_jax``) its ``dp`` step gives the loss
and parameters of JAX's ``jit_data_parallel`` step within JAX's gates (2e-4
and 3e-4, channel dropout off in both packages); and its check refuses a
perturbed parameter or loss."""

import re
import subprocess
import sys

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

from music_transcription_tpu.config import ModelConfig as JModelConfig
from music_transcription_tpu.config import TrainConfig as JTrainConfig
from music_transcription_tpu.models.transcription import TranscriptionModel as JModel
from music_transcription_tpu.parallel.mesh import make_mesh, replicate, shard_batch
from music_transcription_tpu.parallel.train_step import (
    init_train_state,
    jit_data_parallel,
    make_train_step,
)
from music_transcription_tpu.train.optim import make_optimizer
from music_transcription_tpu_torch.checkpoints import state_dict_from_jax
from music_transcription_tpu_torch.parallel import dryrun

WORLD = 4
PATHS = ("one", "dp", "zero1", "fsdp", "tp", "zero1_2d", "fsdp_2d", "tp_2d")


def _port_sd(state, cfg):
    host = jax.tree.map(np.asarray, {"params": state["params"],
                                     "batch_stats": state["batch_stats"]})
    return state_dict_from_jax(host, cfg)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """JAX's gate's model, weights and dp step (dropout the identity), and
    the port's dryrun at world 4 from those weights."""
    work = tmp_path_factory.mktemp("dryrun")
    mp = pytest.MonkeyPatch()
    mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    try:
        jcfg = JModelConfig(model_type="cnn_rnn_large", n_mels=32, hidden_size=16,
                            num_layers=2, dropout=0.0)
        jm = JModel(jcfg)
        tx = make_optimizer(JTrainConfig(batch_size=WORLD))
        state0 = init_train_state(jm, tx, jax.random.key(0),
                                  jm.example_input(batch=1, t=dryrun.T))
        cfg = dryrun.model_config()
        torch.save(_port_sd(state0, cfg), work / "weights.pth")
        mesh = make_mesh(WORLD)
        batch = tuple(shard_batch(t.numpy(), mesh) for t in dryrun.global_batch(WORLD))
        st, m = jit_data_parallel(make_train_step(jm, tx), mesh)(replicate(state0, mesh), batch,
                                                                 jax.random.key(1))
        ref = (float(m["loss"]), _port_sd(st, cfg))
    finally:
        mp.undo()
    proc = subprocess.run([sys.executable, "-m", "music_transcription_tpu_torch.parallel.dryrun",
                           str(WORLD), "--weights", str(work / "weights.pth"),
                           "--out", str(work)], capture_output=True, text=True, timeout=300)
    return dict(proc=proc, ref=ref, report=torch.load(work / "dryrun.pt", weights_only=False)
                if proc.returncode == 0 else None)


def test_dryrun_at_world_4_exits_0_and_prints_every_path(run):
    proc = run["proc"]
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    line = proc.stdout.strip().splitlines()[-1]
    assert line.startswith(f"dryrun({WORLD}): ok")
    losses = dict(re.findall(r"(\w+)=([0-9.]+)", line))
    for name in PATHS:
        assert abs(float(losses[name]) - float(losses["one"])) < dryrun.LOSS_ATOL, (name, line)
    assert set(run["report"]) == set(PATHS)


def test_dryrun_dp_step_matches_jax_jit_data_parallel(run):
    ref_loss, ref_sd = run["ref"]
    dp = run["report"]["dp"]
    dryrun.check_path("dp vs JAX", dp["loss"], dp["params"], ref_loss,
                      {k: v for k, v in ref_sd.items() if k in dp["params"]})


@pytest.mark.parametrize("what", ["parameter", "loss"])
def test_dryrun_check_refuses_a_perturbed_path(run, what):
    one, dp = run["report"]["one"], run["report"]["dp"]
    dryrun.check_path("dp", dp["loss"], dp["params"], one["loss"], one["params"])
    params, loss = {k: v.clone() for k, v in dp["params"].items()}, dp["loss"]
    if what == "parameter":
        params["rnn_main.weight_hh_l0"][3, 5] += 1e-3
    else:
        loss += 5e-4
    with pytest.raises(AssertionError, match="rnn_main.weight_hh_l0|loss"):
        dryrun.check_path("dp", loss, params, one["loss"], one["params"])
