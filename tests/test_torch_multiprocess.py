"""PyTorch port: the training CLI at world 2, two gloo ranks on the CPU
(``tests/_torch_dist_worker.py`` runs ``main`` in each, as torchrun would),
the counterpart of tests/test_multihost.py's two-process training.

The JAX multihost test's model (cnn_rnn, n_mels 16, hidden 8, 1 layer; here
fp32) from JAX's weights (a ``.pth`` + ``.json`` that ``--resume`` reads), a
seeded cache of 8 train chunks of uneven length (2 steps of 4 an epoch,
each rank loading 2 rows of its round-robin ``ProcessShard``) and 4
validation chunks. Both ranks must see the same per-step losses, equal to
the JAX package's single-process steps on the same global batches (each
rank's Loader over JAX's own ``ProcessShard``, their rows together) within
the JAX test's 5e-5: dropout is 0, so the loss does not depend on the order
of the rows. Rank 0 alone writes the run directory; ``--resume auto`` at
world 2 continues from the newest epoch. The RSS recycle (exit 67) is one
decision of all ranks; a rank whose step hangs exits 66 from its stall
watchdog, and the other rank does not wait on it forever.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from _torch_dist_worker import spawn
from music_transcription_tpu.config import ModelConfig as JModelConfig
from music_transcription_tpu.config import TrainConfig as JTrainConfig
from music_transcription_tpu.data.cache import HybridMaestroDataset as JDataset
from music_transcription_tpu.data.pipeline import Loader as JLoader
from music_transcription_tpu.models.transcription import TranscriptionModel as JModel
from music_transcription_tpu.parallel.distributed import ProcessShard as JProcessShard
from music_transcription_tpu.parallel.train_step import init_train_state, make_train_step
from music_transcription_tpu.train.optim import make_optimizer as j_make_optimizer
from music_transcription_tpu_torch.checkpoints import state_dict_from_jax, write_sidecar
from music_transcription_tpu_torch.config import AudioConfig, ModelConfig, config_to_dict
from music_transcription_tpu_torch.data import cache as C

N_MELS, CHUNK, LR, GLOBAL_BATCH = 16, 1.0, 1e-3, 4
CFG = dict(model_type="cnn_rnn", n_mels=N_MELS, hidden_size=8, num_layers=1, dropout=0.0,
           compute_dtype="float32")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    work = tmp_path_factory.mktemp("multiprocess")
    cache = work / "cache"
    acfg = AudioConfig(n_mels=N_MELS, chunk_length=CHUNK)
    t = acfg.mel_frames_per_chunk
    rng = np.random.default_rng(0)
    for split, n in (("train", 8), ("validation", 4)):
        for i in range(n):
            n_frames = t - 3 * (i % 3)
            C.save_chunk(cache / split, i, {
                "mel": (rng.standard_normal((N_MELS, n_frames)) * 10 - 40).astype(np.float32),
                "roll": (rng.random((88, n_frames)) > 0.9).astype(np.uint8)})
        C.save_metadata(cache, split, {"num_chunks": n, "chunk_length": CHUNK, "overlap": 0.0,
                                       "n_mels": N_MELS, "sr": acfg.sample_rate,
                                       "hop_length": acfg.hop_length})
    jm = JModel(JModelConfig(**CFG))
    tx = j_make_optimizer(JTrainConfig(learning_rate=LR, batch_size=GLOBAL_BATCH))
    state = init_train_state(jm, tx, jax.random.key(0), jm.example_input(batch=1, t=t))
    host = jax.tree.map(np.asarray, {"params": state["params"],
                                     "batch_stats": state["batch_stats"]})
    weights = work / "weights.pth"
    torch.save(state_dict_from_jax(host, ModelConfig(**CFG)), weights)
    write_sidecar(weights, {"model": CFG, "audio": config_to_dict(acfg), "step": 0})

    def argv(run_dir, *extra):
        return ["--cache_dir", str(cache), "--root_dir", str(work / "no_raw"),
                "--model_type", "cnn_rnn", "--n_mels", str(N_MELS), "--hidden_size", "8",
                "--num_layers", "1", "--dropout", "0", "--compute_dtype", "float32",
                "--chunk_length", str(CHUNK), "--batch_size", str(GLOBAL_BATCH),
                "--lr", str(LR), "--num_workers", "0", "-d", "cpu", "--save_every", "1",
                "--run_dir", str(run_dir), *extra]

    # rank 1 is given a run directory of its own: it must write nothing there
    for rank, run in ((0, work / "run"), (1, work / "run_rank1")):
        (work / f"argv_{rank}.json").write_text(json.dumps(
            {"argv": argv(run, "--epochs", "2", "--resume", str(weights))}))
    _, first = spawn("cli", work)
    for rank in (0, 1):
        (work / f"argv_{rank}.json").write_text(json.dumps(
            {"argv": argv(work / "run", "--epochs", "3", "--resume", "auto")}))
    _, resumed = spawn("cli", work)

    # JAX, one process: each step's global batch is the ranks' rows together;
    # a resumed process starts its loaders again (epoch 3 draws epoch 1's
    # order, in both packages)
    step = jax.jit(make_train_step(jm, tx))

    def shards():
        data = JDataset(str(cache), str(cache), "train", chunk_length=CHUNK, verbose=False)
        return [JLoader(JProcessShard(data, p, 2), GLOBAL_BATCH // 2, shuffle=True, seed=0,
                        num_workers=0, drop_last=True, pad_to=t) for p in range(2)]

    ref, loaders = [], shards()
    for epoch in range(3):
        if epoch == 2:
            loaders = shards()
        for parts in zip(*loaders):
            batch = tuple(np.concatenate(cols) for cols in zip(*parts))
            state, m = step(state, batch, jax.random.key(1))
            ref.append(float(m["loss"]))
    return dict(work=work, first=first, resumed=resumed, ref=ref)


def _losses(out):
    line = next(ln for ln in out.splitlines() if ln.startswith("LOSSES="))
    return [float(v) for v in line.removeprefix("LOSSES=").split(",") if v]


def test_two_rank_cli_matches_jax_single_process(setup):
    per_rank = [_losses(out) for out in setup["first"]]
    assert per_rank[0] == per_rank[1]  # both ranks see the global loss
    assert len(per_rank[0]) == 4  # 2 epochs of 2 steps
    np.testing.assert_allclose(per_rank[0], setup["ref"][:4], atol=5e-5)


def test_rank_0_alone_writes_the_run(setup):
    work = setup["work"]
    assert not (work / "run_rank1").exists()
    ckpts = set(os.listdir(work / "run" / "checkpoints"))
    assert {"model_epoch_1.pt", "model_epoch_2.pt", "model_final.pt", "model_best.pth"} <= ckpts
    manifest = json.loads((work / "run" / "parameters.json").read_text())
    assert manifest["devices"] == ["cpu", "cpu"]  # every rank's device
    assert manifest["train"]["batch_size"] == GLOBAL_BATCH


def test_resume_auto_at_world_2_continues_from_the_newest_epoch(setup):
    for out in setup["resumed"]:
        assert "model_epoch_2.pt" in out and "Resuming from epoch 2; starting at 3" in out
    losses = [_losses(out) for out in setup["resumed"]]
    assert losses[0] == losses[1] and len(losses[0]) == 2
    np.testing.assert_allclose(losses[0], setup["ref"][4:], atol=5e-5)
    run = setup["work"] / "run"
    epochs = [int(line.split()[1]) for line in (run / "training_log.txt").read_text().splitlines()]
    assert epochs == [1, 2, 3]
    assert torch.load(run / "checkpoints" / "model_final.pt")["step"] == 6


def _rank_argv(setup, run_dir, *extra):
    argv = json.loads((setup["work"] / "argv_0.json").read_text())["argv"]
    return argv[:argv.index("--run_dir")] + ["--run_dir", str(run_dir), *extra]


def test_the_rss_recycle_is_taken_by_every_rank_together(setup, tmp_path):
    """Past the watermark (the largest rank's RSS) every rank checkpoints
    (a gather) and exits 67 after epoch 1; the rerun finishes."""
    for rank in (0, 1):
        (tmp_path / f"argv_{rank}.json").write_text(json.dumps({"argv": _rank_argv(
            setup, tmp_path / "run", "--epochs", "2", "--save_every", "0", "--resume", "auto",
            "--rss_watermark_gb", "0.001")}))
    codes, outs = spawn("cli", tmp_path, check=False)
    assert codes == [67, 67], [o[-2000:] for o in outs]
    assert set(os.listdir(tmp_path / "run" / "checkpoints")) >= {"model_epoch_1.pt"}
    assert "model_final.pt" not in os.listdir(tmp_path / "run" / "checkpoints")


def test_a_stalled_rank_exits_66_and_the_other_does_not_hang(setup, tmp_path):
    """Rank 1's first step hangs: its watchdog ends it with 66; rank 0, in a
    collective with it, fails or stalls out too, well inside the limit."""
    for rank in (0, 1):
        argv = _rank_argv(setup, tmp_path / "run", "--epochs", "1", "--stall_timeout", "1")
        (tmp_path / f"argv_{rank}.json").write_text(json.dumps({"argv": argv,
                                                                "stall": rank == 1}))
    codes, outs = spawn("cli", tmp_path, timeout=120, check=False)
    assert codes[1] == 66, outs[1][-3000:]
    assert codes[0] != 0, outs[0][-3000:]
