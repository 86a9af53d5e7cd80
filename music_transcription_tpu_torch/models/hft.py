"""hFT-Transformer, the hierarchical frequency-time Transformer for piano
transcription (Toyama et al., ISMIR 2023, arXiv:2307.04305; the published
code's ``model/model_spec2midi.py``), trained through the port's step.

A segment is ``segment_frames`` (F = 128) trained frames of a log-mel with
``margin_frames`` (32) on each side, (B, M, F + 64) with M = ``n_mels``
(256) bins at hop 256. With d = ``hidden_size``:

  1. conv block over time: every trained frame t sees the frames t - 32 ..
     t + 32 of every bin; a Conv2d(1 -> C, kernel (1, K)) over that window
     gives C x (65 - K + 1) = 244 features a bin (index c * 61 + j), then
     Linear(244 -> d) x sqrt(d) plus a learned embedding of the bin, then
     dropout: (B * F, M, d). The conv runs once over the whole segment and
     its output is unfolded into the windows, which gives each window's
     conv exactly;
  2. frequency encoder: ``num_layers`` self-attention blocks over the M bins
     of each frame;
  3. frequency decoder: 88 learned pitch embeddings are the queries of each
     frame; block zero is cross-attention to the bins and the FFN, the
     ``num_layers - 1`` others self-attention over the pitches,
     cross-attention to the bins and the FFN. First-stage heads:
     Linear(d -> 1) for onset, offset and frame activity (mpe), and
     Linear(d -> ``velocity_classes``) for velocity;
  4. time encoder: the pitch tokens turned to (B * 88, F, d), x sqrt(d) plus
     a learned embedding of the frame, dropout, ``num_layers``
     self-attention blocks over the frames of each pitch, and the same four
     heads again.

Every block is post-LN with one LayerNorm (eps 1e-5) after each of its
sublayers, as the published modules have it: x = LN(x + drop(sublayer(x))).
Its FFN is Linear(d -> ``ffn_dim``), ReLU, dropout, Linear(``ffn_dim`` ->
d); its attention drops the softmax's weights.

Precision, as the rest of the port rounds: the conv and every dense layer
in ``compute_dtype`` (``_dense``: input and weight cast, the product
rounded, the bias added in it); the embeddings, LayerNorm (statistics
E[x^2] - E[x]^2) and the residual stream in fp32; attention logits fp32
through ``matmul_f32``, fp32 softmax and dropout, the weights cast to the
compute dtype before P.V (``transformer._attention``); the heads in fp32.
Dropout masks come from the ``generator`` of the training forward, in the
order the forward reaches them.

Output: a dict of eight logits, ``{onset, offset, mpe}_{freq, time}`` of
(B, 88, F) and ``velocity_{freq, time}`` of (B, 88, F, velocity_classes).
Under a profiler the forward opens three spans (``tracing.py``):
``model.freq_encoder`` (the conv block and the frequency encoder),
``model.freq_decoder`` (the decoder and the first-stage heads) and
``model.time_encoder`` (the turn to time, the time encoder and the
second-stage heads).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from music_transcription_tpu_torch.config import NUM_KEYS
from music_transcription_tpu_torch.models.cnn_rnn import _conv, _dense, _layer_norm
from music_transcription_tpu_torch.models.transformer import Dense, MultiHeadProj
from music_transcription_tpu_torch.ops.dropout import dropout
from music_transcription_tpu_torch.tracing import span

LN_EPS = 1e-5  # torch's nn.LayerNorm default, the published modules'


class Block(nn.Module):
    """Post-LN block: self-attention (``self_attn``), cross-attention to a
    memory (``cross_attn``), then the FFN, one LayerNorm after each."""

    def __init__(self, dim: int, heads: int, ffn_dim: int, dropout_rate: float,
                 dt: torch.dtype, self_attn: bool = True, cross_attn: bool = False):
        super().__init__()
        self.dropout = dropout_rate
        if self_attn:
            self.self_attn = MultiHeadProj(dim, heads, dt)
        if cross_attn:
            self.cross_attn = MultiHeadProj(dim, heads, dt)
        self.fc1 = Dense(dim, ffn_dim, dt)
        self.fc2 = Dense(ffn_dim, dim, dt)
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, x, memory=None, generator=None):
        rate = self.dropout if self.training else 0.0
        if hasattr(self, "self_attn"):
            a = self.self_attn(x, x, None, rate, generator)
            x = _layer_norm(x + dropout(a, rate, generator), self.norm)
        if hasattr(self, "cross_attn"):
            a = self.cross_attn(x, memory, None, rate, generator)
            x = _layer_norm(x + dropout(a, rate, generator), self.norm)
        h = self.fc2(dropout(F.relu(self.fc1(x)), rate, generator))
        return _layer_norm(x + dropout(h, rate, generator), self.norm)


class Heads(nn.Module):
    """Onset, offset and mpe logits (Linear(d -> 1) each) and velocity
    logits (Linear(d -> classes)), in fp32."""

    def __init__(self, dim: int, classes: int):
        super().__init__()
        self.onset = nn.Linear(dim, 1)
        self.offset = nn.Linear(dim, 1)
        self.mpe = nn.Linear(dim, 1)
        self.velocity = nn.Linear(dim, classes)

    def forward(self, x: torch.Tensor) -> dict:
        """(..., d) -> {onset, offset, mpe: (...), velocity: (..., classes)}."""
        out = {name: _dense(x, getattr(self, name), torch.float32).squeeze(-1)
               for name in ("onset", "offset", "mpe")}
        out["velocity"] = _dense(x, self.velocity, torch.float32)
        return out


class HFTTranscriber(nn.Module):
    """(B, n_mels, F + 2 * margin) log-mel -> the eight logits (module
    docstring)."""

    def __init__(self, n_mels: int = 256, hidden_size: int = 256, num_layers: int = 3,
                 num_heads: int = 4, ffn_dim: int = 512, dropout: float = 0.1,
                 conv_channels: int = 4, conv_kernel: int = 5, segment_frames: int = 128,
                 margin_frames: int = 32, velocity_classes: int = 128,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.dropout, self.dim = compute_dtype, dropout, hidden_size
        self.n_bins, self.frames, self.margin = n_mels, segment_frames, margin_frames
        self.conv_width = 2 * margin_frames + 1 - conv_kernel + 1  # each window's positions
        dt = compute_dtype
        block = dict(dim=hidden_size, heads=num_heads, ffn_dim=ffn_dim, dropout_rate=dropout,
                     dt=dt)
        self.conv = nn.Conv2d(1, conv_channels, (1, conv_kernel))
        self.freq_embed = Dense(conv_channels * self.conv_width, hidden_size, dt)
        self.freq_pos = nn.Embedding(n_mels, hidden_size)
        self.freq_encoder = nn.ModuleList(Block(**block) for _ in range(num_layers))
        self.pitch_pos = nn.Embedding(NUM_KEYS, hidden_size)
        self.freq_decoder = nn.ModuleList(
            [Block(**block, self_attn=False, cross_attn=True)]
            + [Block(**block, cross_attn=True) for _ in range(num_layers - 1)])
        self.freq_heads = Heads(hidden_size, velocity_classes)
        self.time_pos = nn.Embedding(segment_frames, hidden_size)
        self.time_encoder = nn.ModuleList(Block(**block) for _ in range(num_layers))
        self.time_heads = Heads(hidden_size, velocity_classes)

    def conv_tokens(self, x: torch.Tensor) -> torch.Tensor:
        """(B, M, F + 2 * margin) -> the conv block's features (B * F, M,
        C * (65 - K + 1)) in the compute dtype: the conv over the segment,
        unfolded into each trained frame's window."""
        b = x.shape[0]
        y = _conv(x[:, None], self.conv, self.dtype)  # (B, C, M, F + 2 * margin - K + 1)
        y = y.unfold(3, self.conv_width, 1)  # (B, C, M, F, 61)
        return y.permute(0, 3, 2, 1, 4).reshape(b * self.frames, self.n_bins, -1)

    def to_time(self, p: torch.Tensor, b: int) -> torch.Tensor:
        """The pitch tokens of each frame (B * F, 88, d) as the frames of
        each pitch (B * 88, F, d)."""
        return p.view(b, self.frames, NUM_KEYS, self.dim).transpose(1, 2).reshape(
            b * NUM_KEYS, self.frames, self.dim)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> dict:
        if x.dim() == 4:  # (B, 1, M, T), the port's batches
            x = x[:, 0]
        b, m, t = x.shape
        if m != self.n_bins or t != self.frames + 2 * self.margin:
            raise ValueError(f"hFT takes (B, {self.n_bins}, {self.frames + 2 * self.margin}) "
                             f"segments; got {tuple(x.shape)}")
        rate, scale = (self.dropout if self.training else 0.0), math.sqrt(self.dim)
        with span("model.freq_encoder"):
            h = _dense(self.conv_tokens(x), self.freq_embed, self.dtype)
            h = dropout(h.float() * scale + self.freq_pos.weight, rate, generator)
            for blk in self.freq_encoder:
                h = blk(h, generator=generator)  # (B * F, M, d)
        with span("model.freq_decoder"):
            p = self.pitch_pos.weight.expand(b * self.frames, -1, -1)
            for blk in self.freq_decoder:
                p = blk(p, h, generator)  # (B * F, 88, d)
            out = {f"{k}_freq": v.unflatten(0, (b, self.frames)).transpose(1, 2)
                   for k, v in self.freq_heads(p).items()}
        with span("model.time_encoder"):
            q = dropout(self.to_time(p, b) * scale + self.time_pos.weight, rate, generator)
            for blk in self.time_encoder:
                q = blk(q, generator=generator)  # (B * 88, F, d)
            out.update({f"{k}_time": v.unflatten(0, (b, NUM_KEYS))
                        for k, v in self.time_heads(q).items()})
        return out
