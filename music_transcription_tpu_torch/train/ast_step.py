"""Train and eval steps of the AST tier on one device: the step functions
of the JAX package's ``scripts/train_ast.py``, where they are closures
inside ``main`` (token model, ``:735-779``) and ``pretrain_main`` (encoder
pretraining, ``:273-313``).

  * ``token_step``: one Adam update of the token model. The decoder reads
    ``tokens[:, :-1]`` and is scored against ``tokens[:, 1:]``; with
    ``class_weights`` the cross-entropy weights each position by its
    target's weight and divides by their sum. With ``ss_p`` (scheduled
    sampling) a first teacher-forced pass, dropout off and no gradient,
    gives the model's argmax; each input position but column 0 is replaced
    by the argmax before it with probability ``ss_p``, then the second pass
    trains. ``freeze_encoder`` stops the gradient at the encoder's output
    (``ASTTranscriber.memory``), so the encoder's ``.grad`` stays None and
    Adam leaves it as it is, as optax's zero update does.
  * ``token_eval_loss``: the validation cross-entropy, unweighted.
  * ``pretrain_step`` / ``pretrain_eval``: ``ASTEncoderPretrainer`` under
    the length-masked BCE; the evaluation adds framewise tp / fp / fn at
    logit > 0 after resampling the logits to the roll's frames.
  * ``make_adam``: ``optax.adam(lr)``, i.e. betas 0.9 / 0.999, eps 1e-8, no
    weight decay and no clipping (not the CNN trainer's ``make_optimizer``,
    which adds ``TrainConfig.weight_decay``).
  * ``step_generators``: a step's dropout generator, seeded from
    (dropout_seed, step) as the CNN trainer's, and the scheduled-sampling
    mask's own generator.

A step reads nothing back to the host: it returns the loss as a device
tensor, which the caller reads once.
"""

from __future__ import annotations

import numpy as np
import torch

from music_transcription_tpu_torch.ops import losses
from music_transcription_tpu_torch.ops.precision import full_fp32
from music_transcription_tpu_torch.parallel.train_step import dropout_generator


def make_adam(params, lr: float) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)


def step_generators(dropout_seed: int, step: int, device) -> tuple[torch.Generator,
                                                                   torch.Generator]:
    """(dropout masks, scheduled-sampling mask) generators of step ``step``."""
    seed = int(np.random.SeedSequence([dropout_seed, step, 1]).generate_state(1, np.uint64)[0])
    ss = torch.Generator(device=device).manual_seed(seed & (2**63 - 1))
    return dropout_generator(dropout_seed, step, device), ss


def pitch_class_weights(tokenizer, vocab_size: int, weight: float) -> np.ndarray | None:
    """(V,) cross-entropy weights: 1, and ``weight`` on the tokenizer's
    NOTE_ON / NOTE_OFF ids; None for a weight of 1 (the plain loss)."""
    if weight == 1.0:
        return None
    w = np.ones(vocab_size, np.float32)
    w[tokenizer.note_token_mask()] = weight
    return w


@torch.no_grad()
def scheduled_sampling_inputs(model, wave: torch.Tensor, inp: torch.Tensor, p: float,
                              generator: torch.Generator | None) -> torch.Tensor:
    """``inp`` with each position but column 0 replaced, with probability
    ``p``, by the teacher-forced argmax of the position before it (the
    inference forward: no dropout, no gradient)."""
    model.eval()
    tf_logits = model(wave, targets=inp)
    # logits[:, t] predict tokens[:, t + 1] == inp[:, t + 1]
    pred_in = torch.cat([inp[:, :1], tf_logits[:, :-1].argmax(-1).to(inp.dtype)], 1)
    mask = torch.rand(inp.shape, generator=generator, device=inp.device) < p
    mask[:, 0].fill_(False)  # <sos> stays
    return torch.where(mask, pred_in, inp)


def token_step(model, optimizer: torch.optim.Optimizer, wave: torch.Tensor,
               tokens: torch.Tensor, *, generator: torch.Generator | None = None,
               ss_p: float | None = None, ss_generator: torch.Generator | None = None,
               class_weights: torch.Tensor | None = None) -> torch.Tensor:
    """One update of the AST ``TranscriptionModel`` on (wave (B, L), tokens
    (B, T)); ``ss_p`` None runs no scheduled sampling. Returns the loss."""
    inp = tokens[:, :-1]
    if ss_p is not None:
        inp = scheduled_sampling_inputs(model, wave, inp, ss_p, ss_generator)
    model.train()
    optimizer.zero_grad(set_to_none=True)
    logits = model(wave, targets=inp, generator=generator)
    loss = losses.token_cross_entropy(logits, tokens[:, 1:], class_weights=class_weights)
    with full_fp32():  # fp32 gradients in fp32, not TF32, as the forward
        loss.backward()
    optimizer.step()
    return loss.detach()


@torch.no_grad()
def token_eval_loss(model, wave: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The unweighted validation cross-entropy of one batch."""
    model.eval()
    return losses.token_cross_entropy(model(wave, targets=tokens[:, :-1]), tokens[:, 1:])


def pretrain_step(model, optimizer: torch.optim.Optimizer, wave: torch.Tensor,
                  roll: torch.Tensor, lengths: torch.Tensor, *,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """One update of an ``ASTEncoderPretrainer`` on (wave (B, L), roll (B,
    88, T), lengths (B,)). Returns the loss."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    with full_fp32():
        loss = losses.masked_bce_loss(model(wave, generator), roll, lengths)
        loss.backward()
    optimizer.step()
    return loss.detach()


@torch.no_grad()
def pretrain_eval(model, wave: torch.Tensor, roll: torch.Tensor,
                  lengths: torch.Tensor) -> torch.Tensor:
    """(loss, tp, fp, fn) of one validation batch as one float64 vector:
    framewise counts at logit > 0 over the valid frames."""
    model.eval()
    with full_fp32():
        logits = model(wave)
    loss = losses.masked_bce_loss(logits, roll, lengths)
    t = roll.shape[-1]
    pred = losses.interpolate_time_linear(logits, t) > 0.0
    mask = (torch.arange(t, device=roll.device)[None, :] < lengths[:, None])[:, None, :]
    pos = (roll > 0.5) & mask
    counts = [(pred & pos).sum(), (pred & ~pos & mask).sum(), (~pred & pos).sum()]
    return torch.stack([loss.double()] + [c.double() for c in counts])
