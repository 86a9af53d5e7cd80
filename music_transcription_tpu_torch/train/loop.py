"""Training loop: epochs, validation, checkpoints, run artifacts. A port of
the JAX package's ``train/loop.py``, on one device or data-parallel over
the ranks of a ``torchrun`` launch (``partitioning`` "dp", "zero1", "fsdp"
or "tp" on a 1-D mesh, or "zero1", "fsdp" or "tp" on a 2-D ``(data,
model)`` mesh with ``model_parallel`` > 1; ``parallel/``). Every rank runs
every step and every validation batch; rank 0 alone prints and writes the
run's files.

  * NaN-skip accounting on the host: the step's guard skips a bad update;
    more than ``max_nan_batches`` skipped batches abort the run
  * checkpoints (``checkpoints.py``): ``model_epoch_N.pt`` every
    ``save_every`` epochs, ``model_best.pth`` on validation improvement,
    ``model_final.pt`` at the end. The best state is kept exactly (a copy on
    the device) and written at most every ``save_best_every`` epochs and once
    when the loop exits, on a clean end or an abort (NaN abort, Ctrl-C,
    SIGTERM)
  * run artifacts: ``parameters.json`` / ``parameters.txt``,
    ``training_log.txt`` (one line per epoch), ``loss_curve.png`` and
    ``loss_per_step.png`` when matplotlib imports
  * early stop, the stall watchdog (exit 66) and the RSS recycle (exit 67)
  * ``profile_steps``: the first N train steps under ``torch.profiler``; the
    Chrome trace carries the step's and the model's spans (``tracing.py``:
    ``train.*``, ``model.*``) on the clock of the device's kernels
  * batches reach the device through ``data/pipeline.device_prefetch``
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from music_transcription_tpu_torch import checkpoints as ckpt_lib
from music_transcription_tpu_torch.config import (
    AudioConfig,
    ModelConfig,
    TrainConfig,
    config_to_dict,
)
from music_transcription_tpu_torch.data.pipeline import device_prefetch
from music_transcription_tpu_torch.parallel import partitioning as part
from music_transcription_tpu_torch.parallel.distributed import local_world_size, rank_and_world
from music_transcription_tpu_torch.parallel.mesh import data_size, make_mesh
from music_transcription_tpu_torch.parallel.train_step import (
    data_parallel,
    eval_step,
    init_train_state,
    train_step,
)
from music_transcription_tpu_torch.train.watchdog import StallWatchdog, host_rss_gb

class TrainingUnstableError(RuntimeError):
    pass


class HostMemoryRecycle(RuntimeError):
    """Raised at an epoch boundary when host RSS crossed the watermark
    (TrainConfig.rss_watermark_gb), after a full-resume checkpoint was
    written; the CLI turns it into exit code 67."""

    def __init__(self, epoch: int, rss_gb: float, checkpoint: str):
        super().__init__(f"host RSS {rss_gb:.1f} GB crossed the watermark after epoch {epoch}; "
                         f"checkpoint at {checkpoint}")
        self.epoch = epoch
        self.rss_gb = rss_gb
        self.checkpoint = checkpoint


def install_graceful_sigterm() -> None:
    """Route SIGTERM through KeyboardInterrupt, so ``kill <pid>`` on a
    background run takes the abort path that flushes the best state."""
    import signal

    def _raise(signum, frame):
        raise KeyboardInterrupt(f"signal {signum}")

    try:
        signal.signal(signal.SIGTERM, _raise)
    except ValueError:  # not the main thread; leave the default disposition
        pass


def to_device(batch, device) -> tuple:
    """A loader's batch (numpy or tensors) as tensors on ``device``."""
    return tuple(torch.as_tensor(a).to(device, non_blocking=True) for a in batch)


def train_one_epoch(state, loader, *, dropout_seed: int, max_grad_norm: float,
                    max_nan: int = 10, nan_count_start: int = 0, log_every: int = 50,
                    verbose: bool = True, heartbeat=None):
    """Run one epoch; returns (avg_loss, step_losses, nan_count)."""
    device = next(state.model.parameters()).device
    total, step_losses = 0.0, []
    nan_count = nan_count_start
    t_start = time.perf_counter()
    for i, batch in enumerate(device_prefetch(iter(loader), device)):
        metrics = train_step(state, batch, dropout_seed, max_grad_norm=max_grad_norm)
        if heartbeat is not None:
            heartbeat()
        if metrics["skipped"] > 0:
            nan_count += 1
            if verbose:
                print(f"\nWarning: NaN/Inf loss detected (count: {nan_count}), update skipped")
            if nan_count > max_nan:
                raise TrainingUnstableError("Too many NaN losses - training unstable!")
            continue
        total += metrics["loss"]
        step_losses.append(metrics["loss"])
        if verbose and (i + 1) % log_every == 0:
            rate = (i + 1) / (time.perf_counter() - t_start)
            print(f"  step {i + 1}/{len(loader)} loss={metrics['loss']:.4f} "
                  f"grad_norm={metrics['grad_norm']:.2f} ({rate:.2f} it/s)")
    return total / max(1, len(step_losses)), step_losses, nan_count


def evaluate(model, loader, *, group=None, heartbeat=None) -> float:
    """Mean validation loss over the loader's batches (padded rows of
    length 0 are neutral under the masked loss; with a data-parallel
    ``group`` each batch's loss is the global batch's)."""
    device = next(model.parameters()).device
    total, n = 0.0, 0
    world = 1 if group is None else group.size()
    for batch in device_prefetch(iter(loader), device, pad_to_mesh=True, world=world):
        total += float(eval_step(model, batch, group))
        n += 1
        if heartbeat is not None:
            heartbeat()
    return total / max(1, n)


def _plot_curves(run_dir, train_losses, val_losses, all_step_losses):
    """loss_curve.png + loss_per_step.png, when matplotlib is installed."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    epochs = np.arange(1, len(train_losses) + 1)
    fig, ax = plt.subplots(figsize=(8, 5))
    ax.plot(epochs, train_losses, label="train")
    if val_losses:
        ax.plot(epochs, val_losses, label="val")
    ax.set_xlabel("epoch")
    ax.set_ylabel("loss")
    ax.legend()
    ax.grid(alpha=0.3)
    fig.savefig(os.path.join(run_dir, "loss_curve.png"), dpi=100, bbox_inches="tight")
    plt.close(fig)
    flat = [v for ep in all_step_losses for v in ep]
    if flat:
        fig, ax = plt.subplots(figsize=(10, 4))
        ax.plot(flat, lw=0.6)
        pos = 0
        for ep in all_step_losses[:-1]:
            pos += len(ep)
            ax.axvline(pos, color="gray", ls="--", lw=0.5)
        ax.set_xlabel("step")
        ax.set_ylabel("loss")
        ax.grid(alpha=0.3)
        fig.savefig(os.path.join(run_dir, "loss_per_step.png"), dpi=100, bbox_inches="tight")
        plt.close(fig)


def _profile(state, loader, steps: int, trace_dir: str, *, dropout_seed: int,
             max_grad_norm: float, verbose: bool) -> None:
    """The first ``steps`` train steps under torch.profiler (they update the
    state as any step does); a Chrome trace goes into ``trace_dir``, with
    the spans of ``tracing.py`` that the steps and the model open. The
    loader's ``data.gather`` runs on ``device_prefetch``'s thread, which the
    profiler does not record."""
    from torch.profiler import ProfilerActivity, profile

    device = next(state.model.parameters()).device
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=activities) as prof:
        for i, batch in enumerate(device_prefetch(iter(loader), device)):
            train_step(state, batch, dropout_seed, max_grad_norm=max_grad_norm)
            if i + 1 >= steps:
                break
    if rank_and_world()[0] == 0:  # every rank profiles its steps; rank 0 writes
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    if verbose:
        print(f"Wrote profiler trace ({steps} steps) to {trace_dir}")


def _max_over_ranks(value: float, device, group) -> float:
    t = torch.tensor([value], dtype=torch.float64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return float(t)


def resolve_mesh(train_cfg: TrainConfig, device):
    """The mesh of a run, after the JAX package's rules (``train/loop.py``):
    None on one process; a 1-D ``data`` mesh over the ranks; with
    ``model_parallel`` > 1 a 2-D ``(data, model)`` mesh of
    ``data_parallel`` (default world // model_parallel) rows. The mesh
    covers every rank the run launched (torchrun's ``--nproc_per_node``)."""
    partitioning = train_cfg.partitioning
    if partitioning not in ("dp",) + part.STRATEGIES:
        raise ValueError(f"unknown partitioning {partitioning!r} (dp | zero1 | fsdp | tp)")
    world = rank_and_world()[1]
    device_type = torch.device(device).type
    mp = train_cfg.model_parallel or 1
    if mp > 1:
        if partitioning == "dp":
            raise ValueError("model_parallel > 1 with partitioning='dp' would replicate all "
                             "work across the model axis; use partitioning='zero1'/'fsdp'/'tp'")
        n = train_cfg.data_parallel or world // mp
        part.check_mesh_2d(n, mp)
    else:
        n = train_cfg.data_parallel or world
        if n != world:
            raise ValueError(f"data_parallel={n} differs from the {world} rank(s) of this run: "
                             f"launch {n} ranks with torchrun --nproc_per_node {n}")
    if partitioning != "dp":
        if world == 1:
            raise ValueError("partitioning='zero1'/'fsdp'/'tp' shards state over a mesh; this "
                             "run resolved to a single device (nothing to shard over)")
        if local_world_size() != world:
            raise ValueError("partitioning='zero1'/'fsdp'/'tp' is single-node for now: its "
                             "checkpoints gather the shards through one node's ranks (use "
                             "partitioning='dp' across nodes)")
    if world == 1:
        return None
    if train_cfg.batch_size % n:
        raise ValueError(f"batch_size={train_cfg.batch_size} must divide the data axis "
                         f"({n} shards)")
    return part.make_mesh_2d(n, mp, device_type) if mp > 1 else make_mesh(world, device_type)


def train_model(*, model_cfg: ModelConfig, train_cfg: TrainConfig, audio_cfg: AudioConfig,
                train_loader, val_loader=None, run_dir: str = "outputs/run",
                resume_from: str | None = None, start_epoch: int = 1, device="cuda",
                verbose: bool = True, profile_steps: int = 0):
    """The training loop, on one device or, in each rank of a ``torchrun``
    launch, on the rank's ``device`` with the rank's loaders (each yields
    the rank's rows: ``batch_size`` / world of them). Returns (state,
    history)."""
    device = torch.device(device)
    mesh = resolve_mesh(train_cfg, device)
    rank, world = rank_and_world()
    is_main = rank == 0
    verbose = verbose and is_main
    ckpt_dir = os.path.join(run_dir, "checkpoints")
    if is_main:
        os.makedirs(ckpt_dir, exist_ok=True)
    dropout_seed = train_cfg.seed + 1
    state = init_train_state(model_cfg, train_cfg, device)
    if resume_from:
        # loaded before the state is sharded: every rank reads the same file
        state.step = ckpt_lib.load_training_checkpoint(resume_from, state.model.model,
                                                       state.optimizer)
        if verbose:
            kind = "" if resume_from.endswith(".pt") else " (weights only; fresh optimizer)"
            print(f"Resumed from {resume_from} at step {state.step}{kind}")
    if mesh is not None:
        state = data_parallel(state, mesh)
        if train_cfg.partitioning != "dp":
            state = part.shard_state(state, mesh, strategy=train_cfg.partitioning)
        if verbose:
            shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
            print(f"Data-parallel over {world} ranks, mesh {shape} ({train_cfg.partitioning}, "
                  f"{dist.get_backend()}): {train_cfg.batch_size // data_size(mesh)} rows a "
                  f"rank")

    name = torch.cuda.get_device_name(device) + f" ({device})" if device.type == "cuda" else "cpu"
    devices = [name]
    if mesh is not None:
        devices = [None] * world
        dist.all_gather_object(devices, name, group=state.group)
    manifest = {
        "model": config_to_dict(model_cfg),
        "train": config_to_dict(train_cfg),
        "audio": config_to_dict(audio_cfg),
        "devices": devices,
        "start_epoch": start_epoch,
    }
    if is_main:
        with open(os.path.join(run_dir, "parameters.json"), "w") as f:
            json.dump(manifest, f, indent=2)
        with open(os.path.join(run_dir, "parameters.txt"), "w") as f:
            for section, values in manifest.items():
                if isinstance(values, dict):
                    for k, v in sorted(values.items()):
                        f.write(f"{section}.{k} = {v}\n")
                else:
                    f.write(f"{section} = {values}\n")
    sidecar = {"model": config_to_dict(model_cfg), "audio": config_to_dict(audio_cfg)}

    def save(name: str) -> str:
        # every rank gathers (ZeRO-1 and FSDP hold shards); rank 0 writes
        path = os.path.join(ckpt_dir, f"{name}.pt")
        model_sd = part.full_model_state_dict(state)
        optim_sd = part.full_optimizer_state_dict(state)
        if is_main:
            ckpt_lib.save_training_checkpoint(path, model_sd, optim_sd, state.step,
                                              dropout_seed, sidecar)
        return path

    log_path = os.path.join(run_dir, "training_log.txt")
    best_val, best_epoch = float("inf"), start_epoch - 1
    pending_best, pending_best_val, pending_step = None, float("inf"), 0
    flushed_best_val = float("inf")
    last_best_flush_epoch = -(10**9)

    def flush_best():
        # no collective: the best state was gathered when it was kept
        nonlocal pending_best, flushed_best_val
        if is_main and pending_best is not None and pending_best_val < flushed_best_val:
            path = os.path.join(ckpt_dir, "model_best.pth")
            torch.save(pending_best, path)
            ckpt_lib.write_sidecar(path, {**sidecar, "step": pending_step})
            flushed_best_val = pending_best_val
            if verbose:
                print(f"Saved new best model (val_loss={pending_best_val:.6f})")
        pending_best = None

    watchdog = StallWatchdog(train_cfg.stall_timeout_s) if train_cfg.stall_timeout_s else None
    beat = watchdog.beat if watchdog is not None else None
    history = {"train_loss": [], "val_loss": [], "step_losses": []}
    nan_count = 0
    step_kw = dict(dropout_seed=dropout_seed, max_grad_norm=train_cfg.max_grad_norm)
    if profile_steps > 0:
        _profile(state, train_loader, profile_steps, os.path.join(run_dir, "profile"),
                 verbose=verbose, **step_kw)
    try:
        for epoch in range(start_epoch, train_cfg.epochs + 1):
            if verbose:
                print(f"\nEpoch {epoch}/{train_cfg.epochs}")
            t0 = time.perf_counter()
            train_loss, step_losses, nan_count = train_one_epoch(
                state, train_loader, max_nan=train_cfg.max_nan_batches,
                nan_count_start=nan_count, verbose=verbose, heartbeat=beat, **step_kw)
            epoch_time = time.perf_counter() - t0
            val_loss = (evaluate(state.model, val_loader, group=state.group, heartbeat=beat)
                        if val_loader is not None else None)
            history["train_loss"].append(train_loss)
            history["step_losses"].append(step_losses)
            if val_loss is not None:
                history["val_loss"].append(val_loss)
            line = (f"epoch {epoch} train_loss={train_loss:.6f} "
                    f"val_loss={'-' if val_loss is None else f'{val_loss:.6f}'} "
                    f"time={epoch_time:.1f}s")
            if verbose:
                print(line)
            if is_main:
                with open(log_path, "a") as f:
                    f.write(line + "\n")

            # the validation loss is the same on every rank, and so is this
            if val_loss is not None and val_loss < best_val:
                best_val, best_epoch = val_loss, epoch
                # an exact copy of the inference state (on the device unless
                # FSDP gathered it to the host), on rank 0
                full = part.full_model_state_dict(state)
                pending_best = None if full is None else {k: v.detach().clone()
                                                          for k, v in full.items()}
                pending_best_val, pending_step = val_loss, state.step
                if epoch - last_best_flush_epoch >= train_cfg.save_best_every:
                    flush_best()
                    last_best_flush_epoch = epoch
            saved = None
            if train_cfg.save_every and epoch % train_cfg.save_every == 0:
                saved = save(f"model_epoch_{epoch}")
            if is_main:
                _plot_curves(run_dir, history["train_loss"], history["val_loss"],
                             history["step_losses"])
            if train_cfg.rss_watermark_gb:
                rss = host_rss_gb()
                if mesh is not None:  # the largest rank's: every rank recycles together
                    rss = float(_max_over_ranks(rss, device, state.group))
                if rss > train_cfg.rss_watermark_gb:
                    path = saved or save(f"model_epoch_{epoch}")
                    if verbose:
                        print(f"Host RSS {rss:.1f} GB > watermark {train_cfg.rss_watermark_gb:.1f}"
                              f" GB: checkpointed epoch {epoch}, requesting recycle (exit 67)")
                    raise HostMemoryRecycle(epoch, rss, path)
            if (train_cfg.early_stop_patience and val_loader is not None
                    and epoch - best_epoch >= train_cfg.early_stop_patience):
                if verbose:
                    print(f"Early stop: no val improvement since epoch {best_epoch} "
                          f"(patience {train_cfg.early_stop_patience})")
                break
    finally:
        # disarm before the flush, which must not trip a stall exit
        if watchdog is not None:
            watchdog.stop()
        flush_best()
    save("model_final")
    return state, history
