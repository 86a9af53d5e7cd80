"""Unified model wrapper: config -> module, forward, loss, predict.

Port of the JAX package's ``models/transcription.py``: the two CNN-RNN
types (frame logits, thresholded rolls) and the AST tier (token logits with
``targets``, generated ids without; ``predict`` decodes the ids to rolls
through the checkpoint's tokenizer); and the port's own hFT-Transformer
(``models/hft.py``: eight logits a segment, trained by
``losses.hft_loss``). The wrapped module sits under the attribute
``model``, so this wrapper's state_dict keys carry the
reference's ``model.`` prefix. The forward follows the module's mode:
``.train()`` gives the training forward (batch-statistics BatchNorm, dropout
masks from ``generator``), ``.eval()`` the inference one.
"""

from __future__ import annotations

import dataclasses

import numpy as np
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
        from music_transcription_tpu_torch.models.transformer import ASTTranscriber

        return ASTTranscriber(
            remi_vocab_size=cfg.remi_vocab_size, decoder_layers=cfg.decoder_layers,
            decoder_dim=cfg.decoder_dim, decoder_heads=cfg.decoder_heads, dropout=cfg.dropout,
            max_output_len=cfg.max_output_len, encoder_layers=cfg.encoder_layers,
            encoder_dim=cfg.encoder_dim, encoder_heads=cfg.encoder_heads,
            patch_frames=cfg.patch_frames, n_mels=cfg.encoder_n_mels,
            use_mock_encoder=cfg.use_mock_encoder, freeze_encoder=cfg.freeze_encoder,
            compute_dtype=dtype,
        )
    if cfg.is_hft:
        from music_transcription_tpu_torch.models.hft import HFTTranscriber

        return HFTTranscriber(
            n_mels=cfg.n_mels, hidden_size=cfg.hidden_size, num_layers=cfg.num_layers,
            num_heads=cfg.num_attention_heads, ffn_dim=cfg.ffn_dim, dropout=cfg.dropout,
            conv_channels=cfg.conv_channels, conv_kernel=cfg.conv_kernel,
            segment_frames=cfg.segment_frames, margin_frames=cfg.margin_frames,
            velocity_classes=cfg.velocity_classes, compute_dtype=dtype)
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
                generator: torch.Generator | None = None, **kwargs):
        """(B, 1, n_mels, T) or (B, n_mels, T) mel -> logits (B, 88, T), or a
        dict of heads for the large model with ``return_all_heads``.
        ``generator`` draws the dropout masks of the training forward.

        AST: (B, L) audio -> (B, T, V) logits with ``targets=``, else
        generated ids; ``kwargs`` go to ``ASTTranscriber.forward``
        (``generate_max_len``, ``beam_size``, ``allowed_next``, ...).

        hFT: (B, [1,] n_mels, F + 2 * margin) segments -> the dict of its
        eight logits, in training and inference alike."""
        with full_fp32():
            if self.config.is_hft:
                return self.model(x, generator=generator)
            if self.config.is_ast:
                return self.model(x, generator=generator, **kwargs)
            if self.config.is_large:
                return self.model(x, return_all_heads=return_all_heads, generator=generator)
            return self.model(x, generator=generator)

    def loss(self, logits, targets: torch.Tensor, lengths: torch.Tensor | None = None):
        """Masked BCE, or the 0.5/0.25/0.25 multi-head loss for a dict; token
        cross-entropy (ignoring <pad>) for the AST; for hFT the sum over both
        stages of the BCEs and the velocity cross-entropy on the segments'
        trained frames (``targets`` a velocity roll; ``lengths`` unused)."""
        if self.config.is_hft:
            return losses.hft_loss(logits, targets, self.config.margin_frames)
        if self.config.is_ast:
            return losses.token_cross_entropy(logits, targets)
        return losses.transcription_loss(logits, targets, lengths)

    def tokenizer(self):
        """The AST checkpoint's vocabulary (``cfg.tokenizer``: event and REMI
        ids overlap but mean different things)."""
        if self.config.tokenizer == "event":
            from music_transcription_tpu_torch.models.event_tokenizer import EventMIDITokenizer

            return EventMIDITokenizer(vocab_size=self.config.remi_vocab_size)
        from music_transcription_tpu_torch.models.remi_tokenizer import REMITokenizer

        return REMITokenizer(vocab_size=self.config.remi_vocab_size)

    def predict(self, x: torch.Tensor, threshold: float = 0.5, constrained: bool = False,
                max_T: int = 1024, **kwargs) -> torch.Tensor:
        """Binary (B, 88, T) piano roll: sigmoid(frame logits) > threshold.

        AST: tokens generated from (B, L) audio (``kwargs`` as ``forward``'s),
        each row decoded to a roll of at most ``max_T`` frames by the
        tokenizer, padded to the longest (a CPU tensor); ``constrained``
        masks generation with the tokenizer's ``transition_mask()``."""
        if self.config.is_hft:  # the second stage's frame activity, trained frames
            return (torch.sigmoid(self(x)["mpe_time"]) > threshold).float()
        if not self.config.is_ast:
            return (torch.sigmoid(self(x)) > threshold).float()
        tok = self.tokenizer()
        if constrained:
            kwargs["allowed_next"] = torch.from_numpy(tok.transition_mask()).to(x.device)
        token_ids = self(x, **kwargs).cpu().numpy()  # (B, L)
        rolls = [tok.decode_to_pianoroll(list(row), max_t=max_T) for row in token_ids]
        out = np.zeros((len(rolls), 88, max((r.shape[1] for r in rolls), default=0)), np.float32)
        for i, r in enumerate(rolls):
            out[i, :, : r.shape[1]] = r
        return torch.from_numpy(out)
