"""CNN-(Bi)LSTM transcription models as torch.nn.Modules, inference forward.

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
  * BatchNorm (running statistics, eps 1e-5) in fp32, ReLU, then a cast back
    to the compute dtype;
  * the (2, 1) max-pool over frequency, floor semantics;
  * the (B, C, F, T) -> (B, T, C*F) flatten with index c*F + f;
  * the LSTM input projection in the compute dtype with fp32 accumulation,
    the recurrence in fp32 (ops/lstm.py);
  * attention: qkv in the compute dtype, fp32 scores clamped to +-10, fp32
    softmax, probabilities cast to the compute dtype before @ v;
  * LayerNorm with eps 1e-6 in fp32, statistics as E[x^2] - E[x]^2;
  * ``shared_fc`` in the compute dtype + ReLU; the heads in fp32.

Layout is the reference's NCHW, H = mel bins, W = frames. Training
(dropout, batch-statistics BatchNorm) is not ported yet: the forward raises
in training mode.
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
from music_transcription_tpu_torch.ops.lstm import bilstm_stack


def _conv(x: torch.Tensor, conv: nn.Conv2d, dt: torch.dtype) -> torch.Tensor:
    y = F.conv2d(x.to(dt), conv.weight.to(dt), None, padding=conv.padding)
    return y + conv.bias.to(dt).view(1, -1, 1, 1)


def _bn(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """Eval-mode BatchNorm in fp32, in flax's order of operations."""
    mul = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
    return (x.float() - bn.running_mean.view(1, -1, 1, 1)) * mul.view(1, -1, 1, 1) + bn.bias.view(
        1, -1, 1, 1
    )


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


class _EvalOnly(nn.Module):
    def _check_eval(self):
        if self.training:
            raise NotImplementedError(
                "training forward (dropout, batch-statistics BatchNorm) is not "
                "ported yet; call .eval() for inference")


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
    tensor code; "pallas" runs the clamped flash kernel (K3); "auto" picks
    the kernel once the fp32 score tensor 4*B*heads*T^2 bytes passes
    ``AUTO_SCORE_BYTES``. The rule and its threshold are the JAX package's,
    kept as behaviour so a request takes the same route in both packages.
    """

    CLIP = 10.0
    AUTO_SCORE_BYTES = 1.5e9

    def __init__(self, hidden_dim: int, num_heads: int = 8, backend: str = "xla"):
        super().__init__()
        self.num_heads = num_heads
        self.backend = backend
        self.qkv = nn.Linear(hidden_dim, 3 * hidden_dim)
        self.proj = nn.Linear(hidden_dim, hidden_dim)

    def route(self, b: int, t: int) -> str:
        if self.backend != "auto":
            return self.backend
        return "pallas" if 4.0 * b * self.num_heads * t * t > self.AUTO_SCORE_BYTES else "xla"

    def forward(self, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        b, t, c = x.shape
        head_dim = c // self.num_heads
        qkv = _dense(x, self.qkv, dt).view(b, t, 3, self.num_heads, head_dim)
        q, k, v = qkv.unbind(2)  # (B, T, heads, D)
        attend = flash_attention_clamped if self.route(b, t) == "pallas" else attention_clamped_plain
        out = attend(q, k, v, head_dim**-0.5, self.CLIP)
        return _dense(out.reshape(b, t, c), self.proj, dt)


class BiLSTMStack(nn.Module):
    """Bidirectional LSTM parameters under nn.LSTM's names
    (``weight_ih_l{k}[_reverse]`` (4H, I), ``weight_hh_l{k}`` (4H, H),
    ``bias_ih_l{k}``, ``bias_hh_l{k}``), run by ops/lstm.py."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int, dropout: float = 0.0):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.dropout = dropout
        k = 1.0 / math.sqrt(hidden_size)
        for li in range(num_layers):
            in_size = input_size if li == 0 else 2 * hidden_size
            for sfx in ("", "_reverse"):
                for name, shape in ((f"weight_ih_l{li}", (4 * hidden_size, in_size)),
                                    (f"weight_hh_l{li}", (4 * hidden_size, hidden_size)),
                                    (f"bias_ih_l{li}", (4 * hidden_size,)),
                                    (f"bias_hh_l{li}", (4 * hidden_size,))):
                    self.register_parameter(name + sfx, nn.Parameter(torch.empty(shape).uniform_(-k, k)))

    def layer_params(self, li: int) -> dict:
        """Layer ``li`` in ops/lstm.py's layout (combined bias)."""
        out = {}
        for d, sfx in (("fwd", ""), ("bwd", "_reverse")):
            p = lambda name: getattr(self, f"{name}_l{li}{sfx}")  # noqa: E731
            out[f"wi_{d}"] = p("weight_ih").t()
            out[f"wh_{d}"] = p("weight_hh").t()
            out[f"b_{d}"] = p("bias_ih") + p("bias_hh")
        return out

    def forward(self, x: torch.Tensor, proj_dtype: torch.dtype) -> torch.Tensor:
        layers = [self.layer_params(li) for li in range(self.num_layers)]
        return bilstm_stack(x, layers, dropout_rate=self.dropout, training=self.training,
                            proj_dtype=proj_dtype)


class CNNRNN(_EvalOnly):
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._check_eval()
        dt = self.dtype
        if x.shape[-1] == 0:  # zero-length input
            return torch.zeros(x.shape[0], NUM_KEYS, 1, device=x.device)
        h = _to_nchw(x).to(dt)
        h = _maxpool_freq(_conv_bn_relu(h, self.cnn[0], self.cnn[1], dt))
        h = _maxpool_freq(_conv_bn_relu(h, self.cnn[4], self.cnn[5], dt))
        rnn_out = self.rnn(_flatten_ct(h), dt)
        return _dense(rnn_out, self.fc, torch.float32).transpose(1, 2)


class CNNRNNLarge(_EvalOnly):
    """Large model: residual CNN + freq-aware conv + dual BiLSTM + clamped
    self-attention + frame/onset/offset heads.

    Output: frame logits (B, 88, T), or with ``return_all_heads`` a dict
    {frame, onset, offset} of (B, 88, T).
    """

    def __init__(self, n_mels: int = 229, hidden_size: int = 512, num_layers: int = 3,
                 dropout: float = 0.2, use_attention: bool = True,
                 use_onset_offset_heads: bool = True, num_attention_heads: int = 8,
                 compute_dtype: torch.dtype = torch.float32, attention_backend: str = "xla"):
        super().__init__()
        self.dtype = compute_dtype
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
                                                    backend=attention_backend)
            self.attention_norm = nn.LayerNorm(combined, eps=1e-6)
        if use_onset_offset_heads:
            self.shared_fc = nn.Linear(combined, hidden_size)
            self.frame_head = nn.Linear(hidden_size, NUM_KEYS)
            self.onset_head = nn.Linear(hidden_size, NUM_KEYS)
            self.offset_head = nn.Linear(hidden_size, NUM_KEYS)
        else:
            self.fc = nn.Linear(combined, NUM_KEYS)

    def forward(self, x: torch.Tensor, return_all_heads: bool = False):
        self._check_eval()
        dt = self.dtype
        if x.shape[-1] == 0:  # zero-length input
            zero = torch.zeros(x.shape[0], NUM_KEYS, 1, device=x.device)
            if self.use_onset_offset_heads and return_all_heads:
                return {"frame": zero, "onset": zero, "offset": zero}
            return zero
        h = _to_nchw(x).to(dt)
        h = _maxpool_freq(_conv_bn_relu(h, self.conv1[0], self.conv1[1], dt))
        h = _maxpool_freq(self.res_block1(h, dt))
        h = self.res_block2(h, dt)
        h = _maxpool_freq(_conv_bn_relu(h, self.freq_aware_conv[0], self.freq_aware_conv[1], dt))
        feats = _flatten_ct(h)  # (B, T, 256 * n_mels//8)
        rnn_out = torch.cat([self.rnn_main(feats, dt), self.rnn_local(feats, dt)], dim=-1)
        if self.use_attention:
            attn_out = self.attention(rnn_out, dt)
            rnn_out = _layer_norm(rnn_out + attn_out.float(), self.attention_norm)
        if not self.use_onset_offset_heads:
            return _dense(rnn_out.to(dt), self.fc, torch.float32).transpose(1, 2)
        shared = F.relu(_dense(rnn_out, self.shared_fc, dt))
        heads = ("frame", "onset", "offset") if return_all_heads else ("frame",)
        out = {name: _dense(shared, getattr(self, f"{name}_head"), torch.float32).transpose(1, 2)
               for name in heads}
        return out if return_all_heads else out["frame"]
