"""One rank of a data-parallel run of the PyTorch port on the CPU, for the
tests (not collected: no ``test_`` prefix).

    python tests/_torch_dist_worker.py <mode> <rank> <world> <work_dir>

The ranks meet through a ``file://`` store in ``work_dir`` (no port, so
parallel test workers never collide) over gloo, one thread each, and import
nothing of JAX. Modes:

  * ``steps``: the runs of ``work_dir/spec.json`` (model config, learning
    rate, and per run its partitioning, step count, global batch from
    ``batches.npz``, and switches that break it on purpose: sync-BN off, a
    plain average of the ranks' losses in place of the frame-weighted one;
    a checkpoint to resume from, one to write), each from the weights in
    ``weights.pth``; rank 0 writes ``out_<name>.pt`` (metrics, the model's
    whole state, sharded bytes of every rank). Then, as the spec asks,
    the eval step on the ``eval`` batch (prints ``EVAL_LOSS=``) and the NaN
    guard under each of ``spec["nan"]``'s partitionings: a good step, then
    one with a NaN in rank 1's rows (prints ``NAN_STEP_<partitioning>=``);
  * ``cli``: the training CLI's ``main`` with the arguments in
    ``work_dir/argv_<rank>.json``, its train steps recorded; prints
    ``LOSSES=`` and exits with ``main``'s code (the group it joined is
    torn down by ``main``).

Also imported by the tests for ``assert_close_state``.
"""

import copy
import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def assert_close_state(got: dict, ref: dict, lr: float, stats_rtol: float = 1e-5,
                       loose_share: float = 5e-3):
    """The bounds of tests/test_torch_train_step.py: BatchNorm running
    statistics within ``stats_rtol`` of each tensor's largest magnitude;
    parameters within 2 lr absolute (a gradient that is zero up to rounding
    may take the other sign under Adam), and all but ``loose_share`` of the
    elements within 1e-2 lr."""
    loose = total = 0
    for key, want in ref.items():
        have = got[key]
        if "running" in key:
            tol = stats_rtol * float(want.abs().max())
        elif key.endswith("num_batches_tracked") or "bias_hh" in key:
            continue
        else:
            tol = 2 * lr
        diff = (have.float() - want.float()).abs()
        assert float(diff.max()) <= tol, (key, float(diff.max()), tol)
        if "running" not in key:
            loose += int((diff > 1e-2 * lr).sum())
            total += diff.numel()
    assert loose <= loose_share * total, (loose, total)


def _setup(rank: int, world: int, work: str):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world))
    torch.set_num_threads(1)
    sys.path.insert(0, REPO)
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{os.path.join(work, 'store')}",
                            rank=rank, world_size=world)


def _no_channel_dropout():
    """The large model's fixed Dropout2d rates to 0, as the parity tests set
    them (the two packages draw their masks from different generators)."""
    from music_transcription_tpu_torch.models.cnn_rnn import CNNRNNLarge

    CNNRNNLarge.CHANNEL_DROPOUT = (0.0, 0.0, 0.0)


def _state(spec, work, run):
    """A one-process TrainState from ``weights.pth`` (or ``run["resume"]``'s
    checkpoint), with Adam at ``spec["lr"]``, or with ``run["sgd"]`` optax's
    ``sgd(lr, momentum=0.9)`` as torch's SGD."""
    from music_transcription_tpu_torch import checkpoints as ckpt_lib
    from music_transcription_tpu_torch.config import ModelConfig, TrainConfig
    from music_transcription_tpu_torch.models.transcription import TranscriptionModel
    from music_transcription_tpu_torch.parallel.train_step import TrainState
    from music_transcription_tpu_torch.train.optim import make_optimizer

    model = TranscriptionModel(ModelConfig(**spec["model"]))
    model.model.load_state_dict(torch.load(os.path.join(work, "weights.pth")), strict=True)
    if run.get("sgd"):
        optimizer = torch.optim.SGD(model.parameters(), lr=run["sgd"], momentum=0.9)
    else:
        optimizer = make_optimizer(model.parameters(), TrainConfig(learning_rate=spec["lr"]))
    state = TrainState(model, optimizer)
    if run.get("resume"):
        state.step = ckpt_lib.load_training_checkpoint(run["resume"], model.model, optimizer)
    return state


def _batch(work, key):
    data = np.load(os.path.join(work, "batches.npz"))
    return tuple(torch.from_numpy(data[f"{key}_{f}"]) for f in ("mel", "roll", "lengths"))


def _placed(state, mesh, run):
    """``state`` data-parallel over ``mesh``, then sharded as ``run`` says."""
    from music_transcription_tpu_torch.parallel import partitioning as part
    from music_transcription_tpu_torch.parallel.train_step import data_parallel

    state = data_parallel(state, mesh)
    if run["partitioning"] != "dp":
        state = part.shard_state(state, mesh, shard_params=run["partitioning"] == "fsdp")
    return state


def run_steps(rank: int, world: int, work: str, spec: dict, mesh) -> None:
    from music_transcription_tpu_torch import checkpoints as ckpt_lib
    from music_transcription_tpu_torch.models.cnn_rnn import set_sync_batch_norm
    from music_transcription_tpu_torch.parallel import partitioning as part
    from music_transcription_tpu_torch.parallel import train_step as ts
    from music_transcription_tpu_torch.parallel.mesh import shard_batch

    real_frames = ts.valid_frames
    for run in spec["runs"]:
        state = _placed(_state(spec, work, run), mesh, run)
        if not run.get("sync_bn", True):
            set_sync_batch_norm(state.model, None)
        # a plain average: every rank's loss weighs the same
        ts.valid_frames = ((lambda roll, lengths: torch.ones(()))
                           if run.get("plain_average") else real_frames)
        # a copy: a state_dict holds the optimizer's own tensors, which steps update
        resumed = (copy.deepcopy(part.full_optimizer_state_dict(state)) if run.get("resume")
                   else None)
        batch = shard_batch(_batch(work, run["batch"]), mesh)
        clip = 0.0 if run.get("sgd") else 1.0  # optax.sgd has no clip
        metrics = [ts.train_step(state, batch, 1, max_grad_norm=clip)
                   for _ in range(run["steps"])]
        ts.valid_frames = real_frames
        sizes = [None] * world
        torch.distributed.all_gather_object(sizes, part.sharded_param_bytes(state))
        model_sd = part.full_model_state_dict(state)
        optim_sd = part.full_optimizer_state_dict(state)
        if run.get("save") and rank == 0:
            ckpt_lib.save_training_checkpoint(run["save"], model_sd, optim_sd, state.step, 1, {})
        if rank == 0:
            torch.save({"metrics": metrics, "model": model_sd, "optimizer": optim_sd,
                        "bytes": sizes, "resumed_optimizer": resumed, "step": state.step},
                       os.path.join(work, f"out_{run['name']}.pt"))
        other = [None] * world
        torch.distributed.all_gather_object(other, metrics)
        assert all(m == metrics for m in other), other  # every rank saw the same


def run_eval(rank: int, world: int, work: str, spec: dict, mesh) -> None:
    from music_transcription_tpu_torch.parallel import train_step as ts
    from music_transcription_tpu_torch.parallel.mesh import shard_batch

    state = _placed(_state(spec, work, {}), mesh, {"partitioning": "dp"})
    loss = float(ts.eval_step(state.model, shard_batch(_batch(work, "eval"), mesh), state.group))
    print(f"EVAL_LOSS={loss!r}", flush=True)


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def run_nan(rank: int, world: int, work: str, spec: dict, mesh) -> None:
    """Per partitioning of ``spec["nan"]``: a good step, then one with a NaN
    in rank 1's rows; what this rank holds must not change."""
    from music_transcription_tpu_torch.parallel import train_step as ts
    from music_transcription_tpu_torch.parallel.mesh import shard_batch

    for how in spec["nan"]:
        state = _placed(_state(spec, work, {}), mesh, {"partitioning": how})
        good = shard_batch(_batch(work, "a"), mesh)
        assert ts.train_step(state, good, 1, max_grad_norm=1.0)["skipped"] == 0.0
        adam_state = getattr(state.optimizer, "optim", state.optimizer).state  # ZeRO's local Adam
        before = {k: _local(v).clone() for k, v in state.model.state_dict().items()}
        adam = [{k: _local(v).clone() for k, v in s.items()} for s in adam_state.values()]
        bad = (good[0].clone(), good[1], good[2])
        if rank == 1:
            bad[0][0, 0, 3, 5] = float("nan")
        m = ts.train_step(state, bad, 1, max_grad_norm=1.0)
        kept = all(torch.equal(_local(v), before[k]) for k, v in state.model.state_dict().items())
        kept_adam = all(torch.equal(_local(v), old[k])
                        for s, old in zip(adam_state.values(), adam) for k, v in s.items())
        print(f"NAN_STEP_{how}=" + json.dumps(dict(m, kept=kept, kept_adam=kept_adam,
                                                   step=state.step)), flush=True)


def run_cli(rank: int, world: int, work: str) -> int:
    """The training CLI's ``main`` with ``argv_<rank>.json``'s "argv"; with
    its "stall", this rank's train steps hang (the stall watchdog's case)."""
    import time

    from music_transcription_tpu_torch.train import __main__ as cli
    from music_transcription_tpu_torch.train import loop

    with open(os.path.join(work, f"argv_{rank}.json")) as f:
        cfg = json.load(f)
    losses, real_step = [], loop.train_step

    def recorded(*args, **kwargs):
        if cfg.get("stall"):
            time.sleep(600)
        metrics = real_step(*args, **kwargs)
        losses.append(metrics["loss"])
        return metrics

    loop.train_step = recorded
    rc = cli.main(cfg["argv"])
    print("LOSSES=" + ",".join(repr(v) for v in losses), flush=True)
    return rc


def main() -> int:
    mode, rank, world, work = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    _setup(rank, world, work)
    _no_channel_dropout()
    if mode == "cli":
        return run_cli(rank, world, work)
    from music_transcription_tpu_torch.parallel.mesh import make_mesh

    with open(os.path.join(work, "spec.json")) as f:
        spec = json.load(f)
    mesh = make_mesh(world, "cpu")
    run_steps(rank, world, work, spec, mesh)
    if spec.get("eval"):
        run_eval(rank, world, work, spec, mesh)
    if spec.get("nan"):
        run_nan(rank, world, work, spec, mesh)
    torch.distributed.destroy_process_group()
    return 0


def spawn(mode: str, work, world: int = 2, timeout: float = 240, check: bool = True):
    """Run ``world`` ranks of ``mode`` on ``work``: (exit codes, outputs).
    With ``check`` a rank that exits non-zero fails the caller; one that
    outlives ``timeout`` always does, and every rank is killed on the way
    out."""
    import subprocess

    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), mode, str(r),
                               str(world), str(work)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env, cwd=REPO)
             for r in range(world)]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    codes = [p.returncode for p in procs]
    for r, (code, out) in enumerate(zip(codes, outs)):
        assert code == 0 or not check, f"rank {r} exited {code}:\n{out[-4000:]}"
    return codes, outs


if __name__ == "__main__":
    sys.exit(main())
