"""The multi-rank gate: one train step through every partitioning, from the
same state on the same batch, held against the step in one process; a port
of the JAX package's ``dryrun_multichip`` (``__graft_entry__.py``).

    python -m music_transcription_tpu_torch.parallel.dryrun N

starts N gloo ranks on the CPU (processes of this module, meeting through a
``file://`` store in a temporary directory: no port), and exits 0 when every
path agrees. The model is JAX's tiny flagship (``cnn_rnn_large``, n_mels
32, hidden 16, 2 layers, dropout 0) with the training optimizer
(``TrainConfig`` with batch N: Adam, clip 1.0), seeded weights, and a global
batch of N rows of T = 32 frames drawn as JAX's gate draws it. The paths:
one process (the reference), ``dp`` at world N, ``zero1``, ``fsdp`` and
``tp`` on the 1-D mesh, and, when N >= 4 is even, ``zero1``, ``fsdp`` and
``tp`` on an (N/2, 2) ``(data, model)`` mesh. Each must give the
reference's loss within 2e-4 and its parameters after the step within 3e-4
(JAX's gates), and each sharded path must hold less than the whole state on
a rank. The flagship's fixed channel-dropout rates are set to 0 in the
ranks: the ranks draw their masks by data index, one process over the whole
batch, so their masks differ (JAX's gate compares the paths whose masks do
not). Prints every path's loss on one line.

``--weights PATH`` starts from a state_dict in place of the seeded weights,
and ``--out DIR`` writes each path's loss and state there (``dryrun.pt``).
The compute dtype is the model's default, bfloat16, as in JAX's gate.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

LOSS_ATOL, PARAM_ATOL = 2e-4, 3e-4
T = 32
TIMEOUT_S = 600


def model_config():
    from music_transcription_tpu_torch.config import ModelConfig

    return ModelConfig(model_type="cnn_rnn_large", n_mels=32, hidden_size=16, num_layers=2,
                       dropout=0.0)


def global_batch(n: int):
    """JAX's gate's batch: (mel, roll, lengths) of n rows, seeded 0."""
    rng = np.random.default_rng(0)
    mel = rng.standard_normal((n, 1, 32, T)).astype(np.float32)
    roll = (rng.random((n, 88, T)) > 0.9).astype(np.float32)
    return torch.from_numpy(mel), torch.from_numpy(roll), torch.full((n,), T, dtype=torch.int32)


def check_path(name: str, loss: float, params: dict, ref_loss: float, ref_params: dict) -> None:
    """JAX's gate: a finite loss within LOSS_ATOL of the reference's, every
    parameter after the step within PARAM_ATOL of the reference's (a wrong
    gradient collective can leave the loss, taken before the update, alone)."""
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite {name} loss: {loss}")
    if abs(loss - ref_loss) >= LOSS_ATOL:
        raise AssertionError(f"{name} loss {loss:.6f} != one-process loss {ref_loss:.6f} "
                             f"(same initial state and batch; a cross-path numerics regression)")
    if set(params) != set(ref_params):
        raise AssertionError(f"{name} holds other parameters than one process")
    for key, want in ref_params.items():
        diff = float((params[key].float() - want.float()).abs().max())
        if not diff <= PARAM_ATOL:
            raise AssertionError(f"{name} post-step parameter {key} is {diff:.3e} from one "
                                 f"process's (atol {PARAM_ATOL:g})")


def _paths(world: int) -> list[tuple[str, str, tuple | None]]:
    """(name, partitioning, 2-D mesh shape or None) of every sharded path."""
    paths = [("dp", "dp", None), ("zero1", "zero1", None), ("fsdp", "fsdp", None),
             ("tp", "tp", None)]
    if world >= 4 and world % 2 == 0:
        paths += [(f"{how}_2d", how, (world // 2, 2)) for how in ("zero1", "fsdp", "tp")]
    return paths


def _local_bytes(state) -> int:
    """What this rank holds of the parameters and the optimizer state."""
    from music_transcription_tpu_torch.parallel.partitioning import sharded_param_bytes

    return sum(sharded_param_bytes(state).values())


def run_rank(rank: int, world: int, work: str, weights: str | None) -> dict | None:
    """One rank: every path's step; rank 0 checks them and returns the
    report (None on the others)."""
    import torch.distributed as dist

    from music_transcription_tpu_torch.config import TrainConfig
    from music_transcription_tpu_torch.models.cnn_rnn import CNNRNNLarge
    from music_transcription_tpu_torch.models.transcription import TranscriptionModel
    from music_transcription_tpu_torch.parallel import partitioning as part
    from music_transcription_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from music_transcription_tpu_torch.parallel.train_step import (
        TrainState,
        data_parallel,
        train_step,
    )
    from music_transcription_tpu_torch.train.optim import make_optimizer

    torch.set_num_threads(1)
    CNNRNNLarge.CHANNEL_DROPOUT = (0.0, 0.0, 0.0)
    cfg, train_cfg = model_config(), TrainConfig(batch_size=world)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        sd = TranscriptionModel(cfg).model.state_dict()
    if weights:
        sd = torch.load(weights, map_location="cpu")

    def fresh() -> TrainState:
        model = TranscriptionModel(cfg)
        model.model.load_state_dict(sd, strict=True)
        return TrainState(model, make_optimizer(model.parameters(), train_cfg))

    def params(state, full) -> dict:
        names = {n for n, _ in state.model.model.named_parameters()}
        return {k: v.detach().clone() for k, v in full.items() if k in names}

    batch = global_batch(world)
    step_kw = dict(dropout_seed=1, max_grad_norm=train_cfg.max_grad_norm)
    one = fresh()
    ref = train_step(one, batch, **step_kw)
    ref_params = params(one, one.model.model.state_dict())
    whole = _local_bytes(one)

    dist.init_process_group("gloo", init_method=f"file://{os.path.join(work, 'store')}",
                            rank=rank, world_size=world)
    results = {}
    try:
        mesh_1d = make_mesh(world, "cpu")
        for name, how, shape in _paths(world):
            mesh = mesh_1d if shape is None else part.make_mesh_2d(*shape, "cpu")
            state = data_parallel(fresh(), mesh)
            if how != "dp":
                state = part.shard_state(state, mesh, strategy=how)
            m = train_step(state, shard_batch(batch, mesh), **step_kw)
            full = part.full_model_state_dict(state)
            results[name] = dict(loss=m["loss"], grad_norm=m["grad_norm"],
                                 sharded=_local_bytes(state) < whole,
                                 params=None if full is None else params(state, full))
        # every rank reports whether it held a shard of each path
        held = [None] * world
        dist.all_gather_object(held, {n: r["sharded"] for n, r in results.items()})
    finally:
        dist.destroy_process_group()
    if rank != 0:
        return None
    for name, how, _ in _paths(world):
        check_path(name, results[name]["loss"], results[name]["params"], ref["loss"],
                   ref_params)
        if how != "dp" and not all(h[name] for h in held):
            raise AssertionError(f"{name}: a rank holds the whole state (nothing sharded)")
    return dict(one=dict(loss=ref["loss"], grad_norm=ref["grad_norm"], params=ref_params),
                **results)


def summary(world: int, report: dict) -> str:
    losses = ", ".join(f"{name}={report[name]['loss']:.6f}" for name in report)
    return (f"dryrun({world}): ok, losses agree across paths (atol {LOSS_ATOL:g}, parameters "
            f"{PARAM_ATOL:g}): {losses}, grad_norm={report['one']['grad_norm']:.4f}")


def _rank_main(args) -> int:
    report = run_rank(args.rank, args.world, args.work, args.weights)
    if report is not None:
        torch.save(report, os.path.join(args.work, "dryrun.pt"))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="one train step through every partitioning, "
                                            "held against one process")
    p.add_argument("world", type=int, nargs="?", default=8, help="ranks (gloo, on the CPU)")
    p.add_argument("--weights", type=str, default=None, help="a state_dict to start from")
    p.add_argument("--out", type=str, default=None, help="write dryrun.pt here")
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--work", type=str, default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.rank is not None:
        return _rank_main(args)
    if args.world < 2:
        print("dryrun: needs at least 2 ranks", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory(prefix="dryrun_") as work:
        report, failure = _spawn(args, work)
        if failure:
            print(f"dryrun({args.world}): FAILED, {failure}")
            return 1
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            torch.save(report, os.path.join(args.out, "dryrun.pt"))
    print(summary(args.world, report))
    return 0


def _spawn(args, work: str):
    """Run the ranks, rank 0 writing its report to ``work``: (the report,
    None) when all exit 0, else (None, what failed). A rank that fails ends
    the others; every rank is killed on the way out."""
    from music_transcription_tpu_torch.parallel.distributed import spawn_ranks

    cmd = [sys.executable, "-m", "music_transcription_tpu_torch.parallel.dryrun",
           str(args.world), "--work", work]
    if args.weights:
        cmd += ["--weights", os.path.abspath(args.weights)]
    try:
        codes, outs = spawn_ranks(lambda r: cmd + ["--rank", str(r)], args.world,
                                  timeout=TIMEOUT_S, env=dict(os.environ, OMP_NUM_THREADS="1"),
                                  stop_on_failure=True)
    except TimeoutError as e:
        return None, str(e)
    bad = [r for r, code in enumerate(codes) if code]
    if bad:
        # the rank that failed first exited with a code of its own; the rest were killed
        r = next((r for r in bad if codes[r] > 0), bad[0])
        return None, f"rank {r} exited {codes[r]}:\n{outs[r][-4000:]}"
    return torch.load(os.path.join(work, "dryrun.pt"), weights_only=False), None


if __name__ == "__main__":
    sys.exit(main())
