"""Unified model wrapper: config -> module, forward, loss, thresholded
predict.

Port of the JAX package's ``models/transcription.py`` for the two CNN-RNN
types. The wrapped module sits under the attribute ``model``, so this
wrapper's state_dict keys carry the reference's ``model.`` prefix. The
forward follows the module's mode: ``.train()`` gives the training forward
(batch-statistics BatchNorm, dropout masks from ``generator``), ``.eval()``
the inference one.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from music_transcription_tpu_torch.config import ModelConfig
from music_transcription_tpu_torch.models.cnn_rnn import CNNRNN, CNNRNNLarge
from music_transcription_tpu_torch.ops import losses
from music_transcription_tpu_torch.ops.precision import full_fp32

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_module(cfg: ModelConfig) -> nn.Module:
    """ModelConfig -> torch module."""
    dtype = _DTYPES[cfg.compute_dtype]
    if cfg.model_type == "cnn_rnn":
        return CNNRNN(n_mels=cfg.n_mels, hidden_size=cfg.hidden_size,
                      num_layers=cfg.num_layers, dropout=cfg.dropout, compute_dtype=dtype)
    if cfg.model_type == "cnn_rnn_large":
        return CNNRNNLarge(
            n_mels=cfg.n_mels, hidden_size=cfg.hidden_size, num_layers=cfg.num_layers,
            dropout=cfg.dropout, use_attention=cfg.use_attention,
            use_onset_offset_heads=cfg.use_onset_offset_heads,
            num_attention_heads=cfg.num_attention_heads, compute_dtype=dtype,
            attention_backend=cfg.attention_backend,
        )
    if cfg.model_type == "ast":
        raise NotImplementedError("AST tier not yet ported; see ROADMAP.md")
    raise ValueError(f"Unknown model type: {cfg.model_type}")


class TranscriptionModel(nn.Module):
    def __init__(self, config: ModelConfig):
        super().__init__()
        self.config = config
        self.model = build_module(config)

    def set_attention_backend(self, backend: str) -> None:
        """Switch the large model's attention route ("xla" | "pallas" | "auto")."""
        self.config = dataclasses.replace(self.config, attention_backend=backend)
        if self.config.is_large and self.config.use_attention:
            self.model.attention.backend = backend

    @property
    def multi_head(self) -> bool:
        """Whether training reads all three heads (the large model's default)."""
        return self.config.is_large and self.config.use_onset_offset_heads

    def forward(self, x: torch.Tensor, return_all_heads: bool = False,
                generator: torch.Generator | None = None):
        """(B, 1, n_mels, T) or (B, n_mels, T) mel -> logits (B, 88, T), or a
        dict of heads for the large model with ``return_all_heads``.
        ``generator`` draws the dropout masks of the training forward."""
        with full_fp32():
            if self.config.is_large:
                return self.model(x, return_all_heads=return_all_heads, generator=generator)
            return self.model(x, generator=generator)

    def loss(self, logits, targets: torch.Tensor, lengths: torch.Tensor | None = None):
        """Masked BCE, or the 0.5/0.25/0.25 multi-head loss for a dict."""
        return losses.transcription_loss(logits, targets, lengths)

    def predict(self, x: torch.Tensor, threshold: float = 0.5) -> torch.Tensor:
        """Binary (B, 88, T) piano roll: sigmoid(frame logits) > threshold."""
        return (torch.sigmoid(self(x)) > threshold).float()
