"""Train and eval steps on one device, a port of the JAX package's
``parallel/train_step.py`` (``make_train_step``, ``make_eval_step``).

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
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from music_transcription_tpu_torch.config import ModelConfig, TrainConfig
from music_transcription_tpu_torch.models.transcription import TranscriptionModel
from music_transcription_tpu_torch.ops.precision import full_fp32
from music_transcription_tpu_torch.train.optim import clip_gradients, make_optimizer


@dataclass
class TrainState:
    """What a train step changes: the model (parameters and BatchNorm
    running statistics), the optimizer and the step count."""

    model: TranscriptionModel
    optimizer: torch.optim.Optimizer
    step: int = 0


def init_train_state(model_cfg: ModelConfig, train_cfg: TrainConfig, device) -> TrainState:
    """A fresh model, its weights drawn from ``train_cfg.seed`` (the global
    RNG is left as it was), and its Adam optimizer, on ``device``."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(train_cfg.seed)
        model = TranscriptionModel(model_cfg)
    model.to(device)
    return TrainState(model, make_optimizer(model.parameters(), train_cfg))


def dropout_generator(dropout_seed: int, step: int, device) -> torch.Generator:
    """The generator of step ``step``'s dropout masks."""
    seed = int(np.random.SeedSequence([dropout_seed, step]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(seed & (2**63 - 1))


def _running_stats(model: torch.nn.Module) -> list[torch.Tensor]:
    return [b for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)
            for b in (m.running_mean, m.running_var)]


def train_step(state: TrainState, batch, dropout_seed: int, *, max_grad_norm: float) -> dict:
    """One guarded update. ``batch`` = (mel (B, 1, M, T), roll (B, 88, T),
    lengths (B,)) on the model's device. Returns {"loss", "grad_norm",
    "skipped"} as floats."""
    model, optimizer = state.model, state.optimizer
    mel, roll, lengths = batch
    model.train()
    stats = _running_stats(model)
    saved = [s.clone() for s in stats]
    optimizer.zero_grad(set_to_none=True)
    out = model(mel, return_all_heads=model.multi_head,
                generator=dropout_generator(dropout_seed, state.step, mel.device))
    loss = model.loss(out, roll, lengths)
    with full_fp32():  # fp32 gradients in fp32, not TF32, as the forward
        loss.backward()
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
def eval_step(model: TranscriptionModel, batch) -> torch.Tensor:
    """The validation loss of one batch: the inference forward (running
    statistics, no dropout) and the same loss as training."""
    mel, roll, lengths = batch
    model.eval()
    return model.loss(model(mel, return_all_heads=model.multi_head), roll, lengths)
