"""Optimizer matching the reference recipe and the JAX package's optax chain.

The JAX package's chain is clip_by_global_norm(max_grad_norm) ->
add_decayed_weights(weight_decay) -> scale_by_adam(0.9, 0.999, eps) ->
scale(-lr): the clip acts on the raw gradients, then L2 weight decay is
added to the gradient (not AdamW), then Adam. ``torch.optim.Adam`` with
``weight_decay`` adds ``weight_decay * param`` to the gradient inside
``step()``, so ``clip_gradients`` before ``step()`` gives the same order.

One difference: torch's clip multiplies by ``max_norm / (norm + 1e-6)``
where optax multiplies by ``max_norm / norm``, a relative difference of
1e-6 / norm on clipped steps, inside the parity tests' tolerances.
"""

from __future__ import annotations

import torch

from music_transcription_tpu_torch.config import TrainConfig


def make_optimizer(params, cfg: TrainConfig) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=cfg.learning_rate, betas=(0.9, 0.999),
                            eps=cfg.adam_eps, weight_decay=cfg.weight_decay)


def clip_gradients(params, max_grad_norm: float) -> torch.Tensor:
    """Clip to the global norm ``max_grad_norm`` (no clip when it is 0) and
    return the global norm before clipping, as a device tensor. Under FSDP
    the gradients are sharded DTensors and torch's norm is a DTensor too:
    the value returned is the full norm, the same on every rank."""
    limit = max_grad_norm if max_grad_norm and max_grad_norm > 0 else float("inf")
    norm = torch.nn.utils.clip_grad_norm_(params, limit)
    return norm.full_tensor() if hasattr(norm, "full_tensor") else norm
