"""Typed configuration for the PyTorch port.

The port's own copy of the dataclasses in ``music_transcription_tpu.config``
(``AudioConfig``, ``ModelConfig``, ``TrainConfig``) and of its cache check.
Field names and defaults are identical, but for the fields of the port's own
model, the hFT-Transformer (``model_type="hft"``), which follow the JAX
package's in ``ModelConfig`` and which ``config_to_dict`` writes for that
model alone: a sidecar ``config.json`` of any other model holds the JAX
package's keys, and loads in both packages.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Mapping

# The piano-roll layout shared by every layer: 88 keys, MIDI notes 21..108.
NUM_KEYS = 88
MIN_MIDI = 21
# the hFT-Transformer's front end: hop 256 (62.5 frames a second)
HFT_HOP_LENGTH = 256


@dataclass(frozen=True)
class AudioConfig:
    """Audio frontend configuration: sr=16000, hop=512, n_mels=320, 30 s
    chunks. ``frame_rate`` is the piano-roll frame rate, 31.25 fps (62.5 at
    the hFT-Transformer's hop of 256, ``HFT_HOP_LENGTH``)."""

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

    model_type: str = "cnn_rnn_large"  # cnn_rnn | cnn_rnn_large | ast | hft
    n_mels: int = 320
    hidden_size: int = 512
    num_layers: int = 3
    dropout: float = 0.2
    use_attention: bool = True
    use_onset_offset_heads: bool = True
    num_attention_heads: int = 8
    # AST tier fields (models/transformer.py): vocabulary, decoder, mel-patch encoder.
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
    # "scan" | "pallas". In the port both run the hand-written recurrence
    # (ops/lstm_kernel.py: K1, or K2a/K2b when a gradient is wanted) on a
    # CUDA tensor, its plain version on a CPU tensor. The name is kept for
    # sidecar parity.
    lstm_backend: str = "scan"
    # "xla" (scores materialized, plain tensor code), "pallas" (the
    # hand-written clamped flash kernel, ops/attention_kernel.py) or "auto"
    # (flash once the fp32 score tensor passes 1.5e9 bytes).
    attention_backend: str = "xla"
    # hFT-Transformer fields (models/hft.py), beside n_mels (bins),
    # hidden_size, num_layers (a stage), num_attention_heads and dropout:
    # the FFN width, the time conv's channels and kernel, and a segment's
    # trained frames with the margin frames on each side.
    ffn_dim: int = 512
    conv_channels: int = 4
    conv_kernel: int = 5
    segment_frames: int = 128
    margin_frames: int = 32
    velocity_classes: int = 128

    def __post_init__(self):
        object.__setattr__(self, "model_type", canonical_model_type(self.model_type))

    @property
    def is_ast(self) -> bool:
        return self.model_type == "ast"

    @property
    def is_large(self) -> bool:
        return self.model_type == "cnn_rnn_large"

    @property
    def is_hft(self) -> bool:
        return self.model_type == "hft"

    @property
    def input_frames(self) -> int:
        """hFT's frames a segment: the trained ones and both margins."""
        return self.segment_frames + 2 * self.margin_frames


def canonical_model_type(model_type: str) -> str:
    """Normalize model-type aliases."""
    mt = model_type.lower()
    if mt in ("cnn_rnn", "cnn+rnn"):
        return "cnn_rnn"
    if mt in ("cnn_rnn_large", "large"):
        return "cnn_rnn_large"
    if mt in ("ast", "transformer", "audio_transformer"):
        return "ast"
    if mt in ("hft", "hft_transformer"):
        return "hft"
    raise ValueError(f"Unknown model type: {model_type}")


@dataclass(frozen=True)
class TrainConfig:
    """Training configuration (the JAX package's field set, defaults and
    checks). Defaults follow the reference recipe: Adam(lr=1e-4, eps=1e-8,
    weight_decay=1e-5), global-norm clip 1.0, 100 epochs, batch 24."""

    epochs: int = 100
    batch_size: int = 24
    learning_rate: float = 1e-4
    adam_eps: float = 1e-8
    weight_decay: float = 1e-5
    max_grad_norm: float = 1.0
    chunk_length: float = 30.0
    chunk_overlap: float = 0.0
    save_every: int = 5
    # model_best is written at most every k epochs on improvement, and once
    # at loop exit; the loop keeps an exact copy of the best state meanwhile
    save_best_every: int = 1
    # stop when validation loss has not improved for this many epochs (0 = off)
    early_stop_patience: int = 0
    seed: int = 0
    max_nan_batches: int = 10  # abort after this many NaN/Inf losses
    # Parallelism and state partitioning (train/loop.resolve_mesh): on a 1-D
    # mesh data_parallel is the number of ranks torchrun launched (None: all
    # of them); model_parallel > 1 makes a 2-D (data, model) mesh of
    # data_parallel (None: world // model_parallel) rows. partitioning "dp",
    # "zero1", "fsdp" or "tp" ("dp" only on a 1-D mesh).
    data_parallel: int | None = None
    partitioning: str = "dp"
    model_parallel: int = 1
    # The JAX package's dropout PRNG choice; kept so sidecars round-trip. The
    # port draws its masks from a torch.Generator seeded per step.
    rng_impl: str = "auto"
    # Abort with exit 66 when no train/val step completes for this many
    # seconds (0 = off), so a supervisor can resume (train/watchdog.py).
    stall_timeout_s: float = 0.0
    # Planned process recycling (0 = off): past this host RSS in GB at an
    # epoch boundary, write a full-resume checkpoint and exit 67.
    rss_watermark_gb: float = 0.0
    # Host input pipeline
    num_workers: int = 8
    prefetch_batches: int = 2

    def __post_init__(self):
        if self.save_best_every < 1:
            raise ValueError(
                f"save_best_every must be >= 1, got {self.save_best_every}"
            )
        if self.save_every < 0:
            raise ValueError(f"save_every must be >= 0, got {self.save_every}")


class CompatibilityError(ValueError):
    """Raised when cache / model / request configurations disagree."""


def validate_compatibility(*, model_n_mels: int | None = None,
                           cache_meta: Mapping[str, Any] | None = None,
                           audio: AudioConfig | None = None) -> list[str]:
    """Cross-check n_mels / sr / hop / chunk between a cache and a request.
    Returns warnings; raises CompatibilityError on hard mismatches."""
    warnings: list[str] = []
    if cache_meta is None:
        return warnings
    cache_n_mels = cache_meta.get("n_mels")
    if (model_n_mels is not None and cache_n_mels is not None
            and not cache_meta.get("return_waveform", False) and cache_n_mels != model_n_mels):
        raise CompatibilityError(
            f"Cache n_mels={cache_n_mels} does not match model n_mels={model_n_mels}. "
            f"Re-run preprocessing with --n_mels {model_n_mels} or use a matching cache "
            f"directory.")
    if audio is not None:
        for key, want in (("sr", audio.sample_rate), ("hop_length", audio.hop_length)):
            have = cache_meta.get(key)
            if have is not None and have != want:
                raise CompatibilityError(
                    f"Cache {key}={have} does not match requested {key}={want}.")
        have_chunk = cache_meta.get("chunk_length")
        if have_chunk is not None and have_chunk != audio.chunk_length:
            warnings.append(
                f"Cache chunk_length={have_chunk}s differs from requested "
                f"{audio.chunk_length}s; the cache will be bypassed and chunks loaded "
                f"from raw audio (slow).")
    return warnings


# the fields of the port's own model alone, after the JAX package's
HFT_FIELDS = ("ffn_dim", "conv_channels", "conv_kernel", "segment_frames", "margin_frames",
              "velocity_classes")


def config_to_dict(cfg) -> dict:
    """A config's fields as a dict. A ``ModelConfig`` of any model but hFT
    leaves out hFT's fields, so that its sidecar holds the JAX package's keys
    alone, which that package's scripts read with ``ModelConfig(**...)``."""
    out = dataclasses.asdict(cfg)
    if isinstance(cfg, ModelConfig) and not cfg.is_hft:
        for k in HFT_FIELDS:
            del out[k]
    return out


def config_from_dict(cls, d: Mapping[str, Any]):
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in d.items() if k in names})
