"""Typed configuration for the PyTorch port.

The port's own copy of the dataclasses in ``music_transcription_tpu.config``.
Field names and defaults are identical, so a sidecar ``config.json`` written
by either package loads in both.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Mapping

# The piano-roll layout shared by every layer: 88 keys, MIDI notes 21..108.
NUM_KEYS = 88
MIN_MIDI = 21


@dataclass(frozen=True)
class AudioConfig:
    """Audio frontend configuration: sr=16000, hop=512, n_mels=320, 30 s
    chunks. ``frame_rate`` is the piano-roll frame rate, 31.25 fps."""

    sample_rate: int = 16000
    hop_length: int = 512
    n_fft: int = 2048
    win_length: int | None = None  # defaults to n_fft (librosa semantics)
    n_mels: int = 320
    fmin: float = 0.0
    fmax: float | None = None  # defaults to sample_rate / 2
    chunk_length: float = 30.0
    power: float = 2.0
    top_db: float = 80.0
    amin: float = 1e-10

    @property
    def frame_rate(self) -> float:
        return self.sample_rate / self.hop_length

    @property
    def chunk_samples(self) -> int:
        return int(self.chunk_length * self.sample_rate)

    @property
    def mel_frames_per_chunk(self) -> int:
        # center=True STFT: 1 + n_samples // hop (938 for the default config)
        return 1 + self.chunk_samples // self.hop_length

    @property
    def roll_frames_per_chunk(self) -> int:
        return int(self.chunk_length * self.frame_rate)

    @property
    def effective_fmax(self) -> float:
        return self.sample_rate / 2.0 if self.fmax is None else self.fmax

    @property
    def effective_win_length(self) -> int:
        return self.n_fft if self.win_length is None else self.win_length


@dataclass(frozen=True)
class ModelConfig:
    """Model architecture configuration (the JAX package's field set)."""

    model_type: str = "cnn_rnn_large"  # cnn_rnn | cnn_rnn_large | ast
    n_mels: int = 320
    hidden_size: int = 512
    num_layers: int = 3
    dropout: float = 0.2
    use_attention: bool = True
    use_onset_offset_heads: bool = True
    num_attention_heads: int = 8
    # AST tier fields: kept so sidecars round-trip; the tier is not ported.
    remi_vocab_size: int = 512
    tokenizer: str = "remi"
    decoder_layers: int = 4
    decoder_dim: int = 384
    decoder_heads: int = 6
    max_output_len: int = 1024
    encoder_layers: int = 4
    encoder_dim: int = 384
    encoder_heads: int = 6
    patch_frames: int = 4
    encoder_n_mels: int = 128
    use_mock_encoder: bool = False
    freeze_encoder: bool = False
    # bf16 conv/dense compute, fp32 parameters, fp32 recurrence and softmax.
    compute_dtype: str = "bfloat16"
    # "scan" | "pallas". In the port both run the K1 wrapper
    # (ops/lstm_kernel.py): the hand-written kernel on a CUDA tensor, its
    # plain version on a CPU tensor. The name is kept for sidecar parity.
    lstm_backend: str = "scan"
    # "xla" (scores materialized, plain tensor code), "pallas" (the
    # hand-written clamped flash kernel, ops/attention_kernel.py) or "auto"
    # (flash once the fp32 score tensor passes 1.5e9 bytes).
    attention_backend: str = "xla"

    def __post_init__(self):
        object.__setattr__(self, "model_type", canonical_model_type(self.model_type))

    @property
    def is_ast(self) -> bool:
        return self.model_type == "ast"

    @property
    def is_large(self) -> bool:
        return self.model_type == "cnn_rnn_large"


def canonical_model_type(model_type: str) -> str:
    """Normalize model-type aliases."""
    mt = model_type.lower()
    if mt in ("cnn_rnn", "cnn+rnn"):
        return "cnn_rnn"
    if mt in ("cnn_rnn_large", "large"):
        return "cnn_rnn_large"
    if mt in ("ast", "transformer", "audio_transformer"):
        return "ast"
    raise ValueError(f"Unknown model type: {model_type}")


def config_to_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)


def config_from_dict(cls, d: Mapping[str, Any]):
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in d.items() if k in names})
