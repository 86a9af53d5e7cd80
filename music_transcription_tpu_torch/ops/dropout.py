"""Dropout with flax's ``nn.Dropout`` semantics, drawn from an explicit
``torch.Generator``.

``keep = 1 - rate``; a Bernoulli(keep) mask; kept values divided by
``keep`` in the input's dtype, dropped ones zero. ``channel_dropout`` draws
one mask per (batch, channel) of an NCHW tensor: flax's
``broadcast_dims=(1, 2)`` on NHWC, torch's Dropout2d. The masks are not
JAX's bits (the two generators differ), only their distribution.
"""

from __future__ import annotations

import torch


def _masked(x: torch.Tensor, rate: float, generator: torch.Generator | None, shape) -> torch.Tensor:
    if rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs an explicit torch.Generator "
                         "(pass generator= to the training forward)")
    keep = 1.0 - rate
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None) -> torch.Tensor:
    """Element-wise dropout."""
    return _masked(x, rate, generator, x.shape)


def channel_dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None) -> torch.Tensor:
    """Dropout2d on (B, C, H, W): whole channels of a sample."""
    return _masked(x, rate, generator, x.shape[:2] + (1, 1))
