"""Train and eval steps, a port of the JAX package's
``parallel/train_step.py`` (``make_train_step``, ``make_eval_step``, and
the data-parallel ``make_train_step_shardmap`` / ``make_eval_step_shardmap``).

A train step: the training forward (bf16 convolutions and dense layers, fp32
recurrence, as ``compute_dtype`` says; no autocast; fp32 without TF32), the
loss, the backward (also without TF32), the global-norm clip, and the Adam
update, behind the JAX package's NaN/Inf
guard (``_guarded_update``): when the loss or the gradient norm is not
finite, the parameters, the Adam state and the BatchNorm running statistics
stay as they were, ``skipped`` is 1, and the step count still advances.
torch updates the running statistics during the forward, so the step keeps
a copy of them (a few KB) and puts it back on a skip. Deciding the guard
reads two scalars back to the host once per step.

Dropout masks come from a ``torch.Generator`` seeded from
(dropout_seed, step), the counterpart of ``jax.random.fold_in(rng, step)``:
the same run draws the same masks, and a resumed run continues the stream.

Data parallel (``TrainState.group`` set by ``data_parallel``: one process a
rank, each with its rows of the global batch): BatchNorm takes its batch
statistics over the ranks (sync-BN), each rank's dropout generator is
seeded from (dropout_seed, step, data index), the counterpart of folding in
``axis_index`` (on a 1-D mesh the data index is the rank; on a 2-D
``(data, model)`` mesh model peers hold the same rows and draw the same
masks), and the loss and gradients are frame-weighted: with a rank's
masked loss L_r over its d_r = sum(clip(lengths, 0, T)) valid frames, the
global loss and gradient are sum_r d_r (.)_r / sum_r d_r, the masked loss of
the global batch. A plain average (DDP's) would weight a shard of short
tail chunks as much as a full one. Each rank backpropagates
(d_r / sum_r d_r) L_r, the denominator from an all-reduce of the d_r; the
gradients are then summed over the ranks (one all-reduce of a flat buffer;
under FSDP2, ``fsdp`` and ``tp``, its reduce-scatter and on a 2-D mesh the
all-reduce over ``data``, which average over the whole world, so those
ranks scale by the world size first), and the weighted losses in one more.
The sums and sync-BN run over all ranks on a 2-D mesh too: model peers
count their rows n_model times in both sum_r d_r (.)_r and sum_r d_r, and
in the mean of the ranks' E[x], which cancels. The guard, the
clip and the Adam update act on the reduced gradient, which is the same on
every rank, so every rank takes the same decision.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from music_transcription_tpu_torch.config import ModelConfig, TrainConfig
from music_transcription_tpu_torch.models.cnn_rnn import set_sync_batch_norm
from music_transcription_tpu_torch.models.transcription import TranscriptionModel
from music_transcription_tpu_torch.ops.precision import full_fp32
from music_transcription_tpu_torch.parallel.mesh import data_index, mesh_group, replicate
from music_transcription_tpu_torch.train.optim import clip_gradients, make_optimizer

# the partitionings whose state FSDP2 holds: parameters, gradients and
# moments sharded, gradients averaged (not summed) over the ranks
FSDP2 = ("fsdp", "tp")


@dataclass
class TrainState:
    """What a train step changes: the model (parameters and BatchNorm
    running statistics), the optimizer and the step count. ``group`` is the
    process group of the mesh's ranks (None: one process), ``data_index``
    this rank's row of the batch; ``partitioning`` says how the state lies
    over the mesh ("dp" replicated, "zero1" the Adam moments sharded,
    "fsdp" and "tp" parameters, gradients and moments sharded)."""

    model: TranscriptionModel
    optimizer: torch.optim.Optimizer
    step: int = 0
    group: object = None
    partitioning: str = "dp"
    data_index: int | None = None


def init_train_state(model_cfg: ModelConfig, train_cfg: TrainConfig, device) -> TrainState:
    """A fresh model, its weights drawn from ``train_cfg.seed`` (the global
    RNG is left as it was), and its Adam optimizer, on ``device``."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(train_cfg.seed)
        model = TranscriptionModel(model_cfg)
    model.to(device)
    return TrainState(model, make_optimizer(model.parameters(), train_cfg))


def data_parallel(state: TrainState, mesh) -> TrainState:
    """``state`` replicated over ``mesh`` (1-D ``data``, or 2-D ``(data,
    model)``): rank 0's parameters and buffers broadcast to every rank,
    BatchNorm synced over all the ranks, the rank's data index kept."""
    replicate(state.model, mesh)
    state.group = mesh_group(mesh)
    state.data_index = data_index(mesh)
    set_sync_batch_norm(state.model, state.group)
    return state


def dropout_generator(dropout_seed: int, step: int, device, index: int | None = None
                      ) -> torch.Generator:
    """The generator of step ``step``'s dropout masks (of the rows at data
    index ``index`` under data parallelism)."""
    entropy = [dropout_seed, step] if index is None else [dropout_seed, step, index]
    seed = int(np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(seed & (2**63 - 1))


def _running_stats(model: torch.nn.Module) -> list[torch.Tensor]:
    return [b for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)
            for b in (m.running_mean, m.running_var)]


def valid_frames(roll: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """d = sum(clip(lengths, 0, T)), a rank's share of the masked loss's
    denominator (fp32, on the batch's device)."""
    return lengths.clamp(0, roll.shape[-1]).sum().float()


@torch.no_grad()
def _sum_gradients(params, group) -> None:
    """Every gradient summed over the ranks, through one all-reduce of a
    flat buffer. A parameter without a gradient counts as a zero one, so
    that every rank reduces the same buffer."""
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    flat = _flatten_dense_tensors(grads)
    dist.all_reduce(flat, group=group)
    for g, reduced in zip(grads, _unflatten_dense_tensors(flat, grads)):
        g.copy_(reduced)


def train_step(state: TrainState, batch, dropout_seed: int, *, max_grad_norm: float) -> dict:
    """One guarded update. ``batch`` = (mel (B, 1, M, T), roll (B, 88, T),
    lengths (B,)) on the model's device: under data parallelism this rank's
    rows. Returns {"loss", "grad_norm", "skipped"} as floats, the global
    ones, the same on every rank."""
    model, optimizer, group = state.model, state.optimizer, state.group
    mel, roll, lengths = batch
    model.train()
    stats = _running_stats(model)
    saved = [s.clone() for s in stats]
    optimizer.zero_grad(set_to_none=True)
    index = None if group is None else state.data_index
    out = model(mel, return_all_heads=model.multi_head,
                generator=dropout_generator(dropout_seed, state.step, mel.device, index))
    loss = model.loss(out, roll, lengths)
    if group is None:
        with full_fp32():  # fp32 gradients in fp32, not TF32, as the forward
            loss.backward()
    else:
        frames = valid_frames(roll, lengths)
        total = frames.clone()
        dist.all_reduce(total, group=group)
        weight = frames / total.clamp(min=1.0)
        # FSDP2's reductions average over the ranks; the others sum
        fsdp2 = state.partitioning in FSDP2
        scale = group.size() if fsdp2 else 1
        with full_fp32():
            (loss * (weight * scale)).backward()
        if not fsdp2:
            _sum_gradients(model.parameters(), group)
        loss = loss.detach().float() * weight
        dist.all_reduce(loss, group=group)
    grad_norm = clip_gradients(model.parameters(), max_grad_norm)
    loss_v, norm_v = (float(x) for x in torch.stack([loss.detach().float(), grad_norm.float()]).cpu())
    finite = bool(np.isfinite(loss_v) and np.isfinite(norm_v))
    if finite:
        optimizer.step()
    else:
        with torch.no_grad():
            for s, old in zip(stats, saved):
                s.copy_(old)
    state.step += 1
    return {"loss": loss_v, "grad_norm": norm_v, "skipped": 0.0 if finite else 1.0}


@torch.no_grad()
def eval_step(model: TranscriptionModel, batch, group=None) -> torch.Tensor:
    """The validation loss of one batch: the inference forward (running
    statistics, no dropout) and the same loss as training. With a ``group``
    it is the frame-weighted loss of the global batch: a rank whose rows
    are all padding (lengths 0) weighs nothing."""
    mel, roll, lengths = batch
    model.eval()
    loss = model.loss(model(mel, return_all_heads=model.multi_head), roll, lengths)
    if group is None:
        return loss
    frames = valid_frames(roll, lengths)
    sums = torch.stack([loss.float() * frames, frames])
    dist.all_reduce(sums, group=group)
    return sums[0] / sums[1].clamp(min=1e-9)
