"""CNN-(Bi)LSTM transcription models as torch.nn.Modules, inference and
training forward.

Ports of ``CNNRNN`` and ``CNNRNNLarge`` in the JAX package's
``models/cnn_rnn.py``. Parameters are held by torch's own layer modules
under the reference state_dict names (``conv1.0``, ``res_block1.skip.1``,
``rnn_main.weight_ih_l0_reverse``, ``attention.qkv``, ``attention_norm``,
``shared_fc``, ``frame_head``, ...), so a reference ``.pth`` loads with
``load_state_dict``. The forward is written out so that it rounds where the
JAX model rounds:

  * convolutions and dense layers compute in ``compute_dtype`` (bf16 by
    default): inputs and weights cast, the product rounded, then the bias
    added in the same dtype;
  * BatchNorm (eps 1e-5) in fp32, ReLU, then a cast back to the compute
    dtype. In eval mode it uses the running statistics; in training the
    batch statistics over (B, F, T), flax's fast variance E[x^2] - E[x]^2
    clamped at 0, and updates the running statistics as
    0.9 * old + 0.1 * batch with the biased variance, as flax does (torch's
    BatchNorm2d would track the unbiased one);
  * the (2, 1) max-pool over frequency, floor semantics;
  * the (B, C, F, T) -> (B, T, C*F) flatten with index c*F + f;
  * the LSTM input projection in the compute dtype with fp32 accumulation,
    the recurrence in fp32 (ops/lstm.py);
  * attention: qkv in the compute dtype, fp32 scores clamped to +-10, fp32
    softmax, probabilities cast to the compute dtype before @ v;
  * LayerNorm with eps 1e-6 in fp32, statistics as E[x^2] - E[x]^2;
  * ``shared_fc`` in the compute dtype + ReLU; the heads in fp32.

Training adds the JAX model's dropouts, every mask drawn from the
``generator`` passed to ``forward``: Dropout2d (one mask per sample and
channel) at 0.1, 0.1 and 0.15 after ``res_block1``, ``res_block2`` and the
7x3 conv; attention dropout on the probabilities ("xla") or on the output
("pallas"); the BiLSTM's inter-layer dropout; ``shared_fc`` dropout at
1.5 x dropout, or on the no-heads path the ``fc`` output's.

The LSTM biases are one combined bias per layer and direction, as in the
JAX package: ``bias_ih_l*`` is that trainable bias (a fresh one is the sum
of two U(-k, k) draws, torch's b_ih + b_hh), ``bias_hh_l*`` a zero buffer
kept for the reference's state_dict names; a loaded ``bias_hh`` is folded
into ``bias_ih``.

Layout is the reference's NCHW, H = mel bins, W = frames.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from music_transcription_tpu_torch.config import NUM_KEYS
from music_transcription_tpu_torch.ops.attention_kernel import (
    attention_clamped_plain,
    flash_attention_clamped,
)
from music_transcription_tpu_torch.ops.dropout import channel_dropout, dropout
from music_transcription_tpu_torch.ops.lstm import bilstm_stack

# flax BatchNorm(momentum=0.9): running = 0.9 * running + (1 - 0.9) * batch
BN_MOMENTUM = 0.9


def _conv(x: torch.Tensor, conv: nn.Conv2d, dt: torch.dtype) -> torch.Tensor:
    y = F.conv2d(x.to(dt), conv.weight.to(dt), None, padding=conv.padding)
    return y + conv.bias.to(dt).view(1, -1, 1, 1)


def _bn(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """BatchNorm in fp32, in flax's order of operations: running statistics
    in eval mode; in training the batch statistics, with the running ones
    updated in place."""
    x = x.float()
    if bn.training:
        mean = x.mean(dim=(0, 2, 3))
        var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
        with torch.no_grad():
            bn.running_mean.mul_(BN_MOMENTUM).add_(mean, alpha=1.0 - BN_MOMENTUM)
            bn.running_var.mul_(BN_MOMENTUM).add_(var, alpha=1.0 - BN_MOMENTUM)
    else:
        mean, var = bn.running_mean, bn.running_var
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    return (x - mean.view(1, -1, 1, 1)) * mul.view(1, -1, 1, 1) + bn.bias.view(1, -1, 1, 1)


def _dense(x: torch.Tensor, lin: nn.Linear, dt: torch.dtype) -> torch.Tensor:
    return F.linear(x.to(dt), lin.weight.to(dt)) + lin.bias.to(dt)


def _layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """fp32 LayerNorm with flax's fast variance E[x^2] - E[x]^2."""
    mean = x.mean(-1, keepdim=True)
    var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean, min=0.0)
    return (x - mean) * (torch.rsqrt(var + ln.eps) * ln.weight) + ln.bias


def _conv_bn_relu(x, conv, bn, dt):
    return F.relu(_bn(_conv(x, conv, dt), bn)).to(dt)


def _maxpool_freq(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, kernel_size=(2, 1))


def _to_nchw(x: torch.Tensor) -> torch.Tensor:
    """Accept (B, 1, n_mels, T) or (B, n_mels, T)."""
    return x[:, None] if x.dim() == 3 else x


def _flatten_ct(feat: torch.Tensor) -> torch.Tensor:
    """(B, C, F, T) -> (B, T, C*F) with the c*F + f ordering."""
    b, c, f, t = feat.shape
    return feat.permute(0, 3, 1, 2).reshape(b, t, c * f)


class ResidualBlock(nn.Module):
    """conv1+bn1+relu, conv2+bn2, 1x1 skip conv+bn, add, relu."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.bn1 = nn.BatchNorm2d(out_channels)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.bn2 = nn.BatchNorm2d(out_channels)
        self.skip = nn.Sequential(nn.Conv2d(in_channels, out_channels, 1),
                                  nn.BatchNorm2d(out_channels))

    def forward(self, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        identity = _bn(_conv(x, self.skip[0], dt), self.skip[1])
        out = F.relu(_bn(_conv(x, self.conv1, dt), self.bn1))
        out = _bn(_conv(out.to(dt), self.conv2, dt), self.bn2)
        return F.relu(out + identity).to(dt)


class MultiHeadSelfAttention(nn.Module):
    """Self-attention with the ±10 logit clamp.

    ``backend``: "xla" materializes the (B, heads, T, T) scores in plain
    tensor code; "pallas" runs the clamped flash kernel (K3; in training K3
    with lse forward and K4a/K4b backward); "auto" picks
    the kernel once the fp32 score tensor 4*B*heads*T^2 bytes passes
    ``AUTO_SCORE_BYTES``. The rule and its threshold are the JAX package's,
    kept as behaviour so a request takes the same route in both packages.
    """

    CLIP = 10.0
    AUTO_SCORE_BYTES = 1.5e9

    def __init__(self, hidden_dim: int, num_heads: int = 8, backend: str = "xla",
                 dropout: float = 0.1):
        super().__init__()
        self.num_heads = num_heads
        self.backend = backend
        self.dropout = dropout
        self.qkv = nn.Linear(hidden_dim, 3 * hidden_dim)
        self.proj = nn.Linear(hidden_dim, hidden_dim)

    def route(self, b: int, t: int) -> str:
        if self.backend != "auto":
            return self.backend
        return "pallas" if 4.0 * b * self.num_heads * t * t > self.AUTO_SCORE_BYTES else "xla"

    def forward(self, x: torch.Tensor, dt: torch.dtype, generator=None) -> torch.Tensor:
        b, t, c = x.shape
        head_dim = c // self.num_heads
        qkv = _dense(x, self.qkv, dt).view(b, t, 3, self.num_heads, head_dim)
        q, k, v = qkv.unbind(2)  # (B, T, heads, D)
        rate = self.dropout if self.training else 0.0
        if self.route(b, t) == "pallas":
            # the kernel has no in-scores dropout: it moves to the output,
            # as in the JAX model
            out = dropout(flash_attention_clamped(q, k, v, head_dim**-0.5, self.CLIP),
                          rate, generator)
        else:
            out = attention_clamped_plain(
                q, k, v, head_dim**-0.5, self.CLIP,
                prob_dropout=(lambda p: dropout(p, rate, generator)) if rate else None)
        return _dense(out.reshape(b, t, c), self.proj, dt)


class BiLSTMStack(nn.Module):
    """Bidirectional LSTM parameters under nn.LSTM's names
    (``weight_ih_l{k}[_reverse]`` (4H, I), ``weight_hh_l{k}`` (4H, H),
    ``bias_ih_l{k}`` the combined bias, ``bias_hh_l{k}`` a zero buffer), run
    by ops/lstm.py."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int, dropout: float = 0.0):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.dropout = dropout
        k = 1.0 / math.sqrt(hidden_size)
        four_h = 4 * hidden_size
        for li in range(num_layers):
            in_size = input_size if li == 0 else 2 * hidden_size
            for sfx in ("", "_reverse"):
                for name, shape in ((f"weight_ih_l{li}", (four_h, in_size)),
                                    (f"weight_hh_l{li}", (four_h, hidden_size))):
                    self.register_parameter(name + sfx, nn.Parameter(torch.empty(shape).uniform_(-k, k)))
                bias = torch.empty(four_h).uniform_(-k, k) + torch.empty(four_h).uniform_(-k, k)
                self.register_parameter(f"bias_ih_l{li}{sfx}", nn.Parameter(bias))
                self.register_buffer(f"bias_hh_l{li}{sfx}", torch.zeros(four_h))
        self._register_load_state_dict_pre_hook(self._fold_bias_hh)

    def _fold_bias_hh(self, state_dict, prefix, *args):
        """A loaded ``bias_hh`` (a reference checkpoint's) joins ``bias_ih``."""
        for name, _ in self.named_buffers(recurse=False):
            hh, ih = prefix + name, prefix + name.replace("bias_hh", "bias_ih")
            if hh in state_dict and ih in state_dict:
                state_dict[ih] = state_dict[ih] + state_dict[hh]
                state_dict[hh] = torch.zeros_like(state_dict[hh])

    def layer_params(self, li: int) -> dict:
        """Layer ``li`` in ops/lstm.py's layout."""
        out = {}
        for d, sfx in (("fwd", ""), ("bwd", "_reverse")):
            out[f"wi_{d}"] = getattr(self, f"weight_ih_l{li}{sfx}").t()
            out[f"wh_{d}"] = getattr(self, f"weight_hh_l{li}{sfx}").t()
            out[f"b_{d}"] = getattr(self, f"bias_ih_l{li}{sfx}")
        return out

    def forward(self, x: torch.Tensor, proj_dtype: torch.dtype, generator=None) -> torch.Tensor:
        layers = [self.layer_params(li) for li in range(self.num_layers)]
        return bilstm_stack(x, layers, dropout_rate=self.dropout, training=self.training,
                            generator=generator, proj_dtype=proj_dtype)


class CNNRNN(nn.Module):
    """Base model: 2 conv blocks -> BiLSTM -> Linear(88).

    Input (B, 1, n_mels, T) or (B, n_mels, T); output logits (B, 88, T).
    """

    def __init__(self, n_mels: int = 229, hidden_size: int = 256, num_layers: int = 2,
                 dropout: float = 0.3, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = compute_dtype
        self.cnn = nn.Sequential(
            nn.Conv2d(1, 32, 3, padding=1), nn.BatchNorm2d(32), nn.ReLU(), nn.MaxPool2d((2, 1)),
            nn.Conv2d(32, 64, 3, padding=1), nn.BatchNorm2d(64), nn.ReLU(), nn.MaxPool2d((2, 1)),
        )
        self.rnn = BiLSTMStack(64 * (n_mels // 4), hidden_size, num_layers, dropout)
        self.fc = nn.Linear(2 * hidden_size, NUM_KEYS)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        dt = self.dtype
        if x.shape[-1] == 0:  # zero-length input
            return torch.zeros(x.shape[0], NUM_KEYS, 1, device=x.device)
        h = _to_nchw(x).to(dt)
        h = _maxpool_freq(_conv_bn_relu(h, self.cnn[0], self.cnn[1], dt))
        h = _maxpool_freq(_conv_bn_relu(h, self.cnn[4], self.cnn[5], dt))
        rnn_out = self.rnn(_flatten_ct(h), dt, generator)
        return _dense(rnn_out, self.fc, torch.float32).transpose(1, 2)


class CNNRNNLarge(nn.Module):
    """Large model: residual CNN + freq-aware conv + dual BiLSTM + clamped
    self-attention + frame/onset/offset heads.

    Output: frame logits (B, 88, T), or with ``return_all_heads`` a dict
    {frame, onset, offset} of (B, 88, T).
    """

    # Dropout2d rates after res_block1, res_block2 and the freq-aware conv
    CHANNEL_DROPOUT = (0.1, 0.1, 0.15)

    def __init__(self, n_mels: int = 229, hidden_size: int = 512, num_layers: int = 3,
                 dropout: float = 0.2, use_attention: bool = True,
                 use_onset_offset_heads: bool = True, num_attention_heads: int = 8,
                 compute_dtype: torch.dtype = torch.float32, attention_backend: str = "xla"):
        super().__init__()
        self.dtype = compute_dtype
        self.dropout = dropout
        self.use_attention = use_attention
        self.use_onset_offset_heads = use_onset_offset_heads
        self.conv1 = nn.Sequential(nn.Conv2d(1, 32, 3, padding=1), nn.BatchNorm2d(32))
        self.res_block1 = ResidualBlock(32, 64)
        self.res_block2 = ResidualBlock(64, 128)
        self.freq_aware_conv = nn.Sequential(nn.Conv2d(128, 256, (7, 3), padding=(3, 1)),
                                             nn.BatchNorm2d(256))
        lstm_input = 256 * (n_mels // 8)
        self.rnn_main = BiLSTMStack(lstm_input, hidden_size, num_layers,
                                    dropout if num_layers > 1 else 0.0)
        self.rnn_local = BiLSTMStack(lstm_input, hidden_size // 2, 1)
        combined = 2 * hidden_size + 2 * (hidden_size // 2)
        if use_attention:
            self.attention = MultiHeadSelfAttention(combined, num_attention_heads,
                                                    backend=attention_backend, dropout=dropout)
            self.attention_norm = nn.LayerNorm(combined, eps=1e-6)
        if use_onset_offset_heads:
            self.shared_fc = nn.Linear(combined, hidden_size)
            self.frame_head = nn.Linear(hidden_size, NUM_KEYS)
            self.onset_head = nn.Linear(hidden_size, NUM_KEYS)
            self.offset_head = nn.Linear(hidden_size, NUM_KEYS)
        else:
            self.fc = nn.Linear(combined, NUM_KEYS)

    def forward(self, x: torch.Tensor, return_all_heads: bool = False,
                generator: torch.Generator | None = None):
        dt = self.dtype
        train = self.training
        d1, d2, d3 = self.CHANNEL_DROPOUT if train else (0.0, 0.0, 0.0)
        if x.shape[-1] == 0:  # zero-length input
            zero = torch.zeros(x.shape[0], NUM_KEYS, 1, device=x.device)
            if self.use_onset_offset_heads and return_all_heads:
                return {"frame": zero, "onset": zero, "offset": zero}
            return zero
        h = _to_nchw(x).to(dt)
        h = _maxpool_freq(_conv_bn_relu(h, self.conv1[0], self.conv1[1], dt))
        h = channel_dropout(_maxpool_freq(self.res_block1(h, dt)), d1, generator)
        h = channel_dropout(self.res_block2(h, dt), d2, generator)
        h = _maxpool_freq(_conv_bn_relu(h, self.freq_aware_conv[0], self.freq_aware_conv[1], dt))
        feats = _flatten_ct(channel_dropout(h, d3, generator))  # (B, T, 256 * n_mels//8)
        rnn_out = torch.cat([self.rnn_main(feats, dt, generator),
                             self.rnn_local(feats, dt, generator)], dim=-1)
        if self.use_attention:
            attn_out = self.attention(rnn_out, dt, generator)
            rnn_out = _layer_norm(rnn_out + attn_out.float(), self.attention_norm)
        head_rate = 1.5 * self.dropout if train else 0.0
        if not self.use_onset_offset_heads:
            logits = dropout(_dense(rnn_out.to(dt), self.fc, torch.float32), head_rate, generator)
            return logits.transpose(1, 2)
        shared = dropout(F.relu(_dense(rnn_out, self.shared_fc, dt)), head_rate, generator)
        heads = ("frame", "onset", "offset") if return_all_heads else ("frame",)
        out = {name: _dense(shared, getattr(self, f"{name}_head"), torch.float32).transpose(1, 2)
               for name in heads}
        return out if return_all_heads else out["frame"]
