"""Plain references of the two CNN-RNN transcription models, in float32.

Written from the models' equations (cs4247/music-transcription,
``models/cnn_rnn_model.py``: ``CNNRNNModel`` and ``CNNRNNModelLarge``) with
plain torch operations and no kernel of the program. The weights are the
ones the benchmark made, a dict keyed by the models' state-dict names
(``conv1.0.weight``, ``rnn_main.weight_ih_l0_reverse``, ...).

What the program states and this file follows:

  * BatchNorm with eps 1e-5: running statistics in eval mode, the batch's
    (biased variance) in training; LayerNorm with eps 1e-6;
  * the (2, 1) max-pool over frequency; the (B, C, F, T) -> (B, T, C*F)
    flatten;
  * each BiLSTM layer is torch's LSTM (gate order i, f, g, o) with one
    combined bias, ``bias_ih + bias_hh``; the recurrence runs through
    ``torch._VF.lstm``, the operation behind ``nn.LSTM``;
  * attention: 8 heads, scores scaled by D^-0.5 and clamped to +-10 before
    the softmax; the heads' outputs in float32;
  * training dropout: Dropout2d at 0.1, 0.1, 0.15 after ``res_block1``,
    ``res_block2`` and the 7x3 conv; the BiLSTM's dropout between layers;
    attention dropout on the probabilities; ``shared_fc``'s dropout at 1.5x.
    Every mask is drawn by ``MaskStream`` in the order the forward reaches
    it.

``precision`` is applied wherever the configuration holds a tensor in its
compute dtype: both operands of every convolution, dense layer, LSTM input
projection and attention product, and the outputs of the convolutions, the
dense layers, the BatchNorm-ReLU stages, the residual blocks and the
attention's weighted sum, as the program rounds them to bfloat16. ``float32``
leaves them as they are; ``float8`` rounds them to float8 e4m3 at a
per-tensor scale: the control, one precision below bfloat16.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

NUM_KEYS = 88
CLIP = 10.0


def float32(x: torch.Tensor) -> torch.Tensor:
    return x


def float8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with its largest magnitude at 448; the
    gradient passes straight through."""
    with torch.no_grad():
        scale = 448.0 / x.detach().abs().amax().float().clamp(min=1e-30)
        y = (x.detach().float() * scale).to(torch.float8_e4m3fn).float() / scale
    return x + (y - x).detach() if x.requires_grad else y


PRECISIONS = {"float32": float32, "float8": float8}


class MaskStream:
    """The dropout masks of one training step: ``keep(shape, rate)`` is
    ``rand(shape) < 1 - rate`` from one device generator, seeded from
    (dropout_seed, step) through numpy's ``SeedSequence``, which is how the
    program seeds a step's masks."""

    def __init__(self, dropout_seed: int, step: int, device):
        seed = int(np.random.SeedSequence([dropout_seed, step]).generate_state(1, np.uint64)[0])
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(seed & (2**63 - 1))

    def apply(self, x: torch.Tensor, rate: float, shape=None) -> torch.Tensor:
        keep = 1.0 - rate
        mask = torch.rand(tuple(shape or x.shape), generator=self.gen, device=self.device) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def _conv(x, w, name, q, padding):
    return q(F.conv2d(q(x), q(w[f"{name}.weight"]), w[f"{name}.bias"], padding=padding))


def _batch_norm(x, w, name, train: bool):
    if train:
        var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False, keepdim=True)
    else:
        mean = w[f"{name}.running_mean"].view(1, -1, 1, 1)
        var = w[f"{name}.running_var"].view(1, -1, 1, 1)
    scale = torch.rsqrt(var + 1e-5) * w[f"{name}.weight"].view(1, -1, 1, 1)
    return (x - mean) * scale + w[f"{name}.bias"].view(1, -1, 1, 1)


def _pool(x):
    return F.max_pool2d(x, kernel_size=(2, 1))


def _dense(x, w, name, q):
    return q(F.linear(q(x), q(w[f"{name}.weight"]), w[f"{name}.bias"]))


def _conv_bn_relu(x, w, conv, bn, q, train, padding=1):
    return q(F.relu(_batch_norm(_conv(x, w, conv, q, padding), w, bn, train)))


def _res_block(x, w, name, q, train):
    if f"{name}.skip.0.weight" in w:
        identity = _batch_norm(_conv(x, w, f"{name}.skip.0", q, 0), w, f"{name}.skip.1", train)
    else:
        identity = x
    out = F.relu(_batch_norm(_conv(x, w, f"{name}.conv1", q, 1), w, f"{name}.bn1", train))
    out = _batch_norm(_conv(out, w, f"{name}.conv2", q, 1), w, f"{name}.bn2", train)
    return q(F.relu(out + identity))


def _flatten(h):
    b, c, f, t = h.shape
    return h.permute(0, 3, 1, 2).reshape(b, t, c * f)


def _bilstm_layer(x, w, name, li, q):
    """One bidirectional LSTM layer, (B, T, I) -> (B, T, 2H)."""
    b = x.shape[0]
    hidden = w[f"{name}.weight_hh_l{li}"].shape[1]
    flat = []
    for sfx in ("", "_reverse"):
        flat += [q(w[f"{name}.weight_ih_l{li}{sfx}"]), w[f"{name}.weight_hh_l{li}{sfx}"],
                 w[f"{name}.bias_ih_l{li}{sfx}"] + w[f"{name}.bias_hh_l{li}{sfx}"],
                 torch.zeros_like(w[f"{name}.bias_hh_l{li}{sfx}"])]
    h0 = x.new_zeros(2, b, hidden)
    out, _, _ = torch._VF.lstm(q(x), (h0, h0), flat, True, 1, 0.0, torch.is_grad_enabled(),
                               True, True)
    return out


def _bilstm(x, w, name, layers, q, masks, rate):
    for li in range(layers):
        x = _bilstm_layer(x, w, name, li, q)
        if masks is not None and li < layers - 1 and rate > 0:
            x = masks.apply(x, rate)
    return x


def _attention(x, w, heads, q, masks, rate):
    b, t, c = x.shape
    d = c // heads
    qkv = _dense(x, w, "attention.qkv", q).view(b, t, 3, heads, d)
    qh, kh, vh = (a.permute(0, 2, 1, 3).reshape(b * heads, t, d) for a in qkv.unbind(2))
    s = torch.bmm(q(qh), q(kh).transpose(1, 2)) * d**-0.5
    p = torch.softmax(torch.clamp(s, -CLIP, CLIP), dim=-1)
    if masks is not None and rate > 0:
        p = masks.apply(p, rate)
    o = q(torch.bmm(q(p), q(vh))).view(b, heads, t, d).permute(0, 2, 1, 3).reshape(b, t, c)
    return _dense(o, w, "attention.proj", q)


def forward(w: dict, mel: torch.Tensor, cfg: dict, *, masks: MaskStream | None = None,
            precision: str = "float32"):
    """(B, 1, n_mels, T) float32 log-mel -> frame logits (B, 88, T), or for the
    large model with its three heads a dict {frame, onset, offset}. Training
    (batch statistics, dropout) when ``masks`` is given, inference otherwise."""
    q = PRECISIONS[precision]
    train = masks is not None
    dropout = float(cfg["dropout"])
    layers = int(cfg["num_layers"])
    if cfg["model_type"] == "cnn_rnn":
        h = _pool(_conv_bn_relu(mel, w, "cnn.0", "cnn.1", q, train))
        h = _pool(_conv_bn_relu(h, w, "cnn.4", "cnn.5", q, train))
        out = _bilstm(_flatten(h), w, "rnn", layers, q, masks, dropout)
        return F.linear(out, w["fc.weight"], w["fc.bias"]).transpose(1, 2)
    h = _pool(_conv_bn_relu(mel, w, "conv1.0", "conv1.1", q, train))
    h = _pool(_res_block(h, w, "res_block1", q, train))
    if train:
        h = masks.apply(h, 0.1, h.shape[:2] + (1, 1))
    h = _res_block(h, w, "res_block2", q, train)
    if train:
        h = masks.apply(h, 0.1, h.shape[:2] + (1, 1))
    h = _pool(_conv_bn_relu(h, w, "freq_aware_conv.0", "freq_aware_conv.1", q, train, (3, 1)))
    if train:
        h = masks.apply(h, 0.15, h.shape[:2] + (1, 1))
    feats = _flatten(h)
    out = torch.cat([_bilstm(feats, w, "rnn_main", layers, q, masks,
                             dropout if layers > 1 else 0.0),
                     _bilstm(feats, w, "rnn_local", 1, q, masks, 0.0)], dim=-1)
    if cfg["use_attention"]:
        att = _attention(out, w, int(cfg["num_attention_heads"]), q, masks, dropout)
        out = F.layer_norm(out + att, (out.shape[-1],), w["attention_norm.weight"],
                           w["attention_norm.bias"], eps=1e-6)
    if not cfg["use_onset_offset_heads"]:
        logits = F.linear(out, w["fc.weight"], w["fc.bias"])
        if train:
            logits = masks.apply(logits, 1.5 * dropout)
        return logits.transpose(1, 2)
    shared = F.relu(_dense(out, w, "shared_fc", q))
    if train:
        shared = masks.apply(shared, 1.5 * dropout)
    heads = {k: F.linear(shared, w[f"{k}_head.weight"], w[f"{k}_head.bias"]).transpose(1, 2)
             for k in ("frame", "onset", "offset")}
    return heads if train else heads["frame"]


def _masked_bce(logits, target, lengths):
    t = target.shape[-1]
    per = F.binary_cross_entropy_with_logits(logits, target, reduction="none")
    mask = (torch.arange(t, device=target.device)[None, :] < lengths[:, None]).float()
    return (per * mask[:, None, :]).sum() / torch.clamp(mask.sum() * target.shape[1], min=1.0)


def loss(out, roll: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """The masked binary cross-entropy of the frame logits; for three heads
    0.5 frame + 0.25 onset + 0.25 offset, the onset and offset targets the
    rises and falls of the frame targets."""
    if not isinstance(out, dict):
        return _masked_bce(out, roll, lengths)
    onset, offset = torch.zeros_like(roll), torch.zeros_like(roll)
    diff = roll[..., 1:] - roll[..., :-1]
    onset[..., 1:] = diff.clamp(min=0.0)
    offset[..., :-1] = (-diff).clamp(min=0.0)
    return (0.5 * _masked_bce(out["frame"], roll, lengths)
            + 0.25 * _masked_bce(out["onset"], onset, lengths)
            + 0.25 * _masked_bce(out["offset"], offset, lengths))


def is_trained(name: str) -> bool:
    """Whether a state-dict entry is a trained parameter: BatchNorm's running
    statistics and the LSTM's second bias, held at zero, are not."""
    return not any(s in name for s in ("running_mean", "running_var", "num_batches_tracked",
                                       "bias_hh_l"))


# the layers a forward reaches after every recurrence: their gradients do not
# pass back through a BiLSTM
PAST_RECURRENCE = ("attention", "attention_norm", "shared_fc", "frame_head", "onset_head",
                   "offset_head", "fc")


def layer(name: str) -> str:
    """The top-level layer of a state-dict entry."""
    return name.split(".", 1)[0]


# ---------------------------------------------------------------------------
# Work counts
# ---------------------------------------------------------------------------


def recurrences(cfg: dict) -> list[int]:
    """The hidden size of each BiLSTM layer a forward runs, in order."""
    hidden, layers = int(cfg["hidden_size"]), int(cfg["num_layers"])
    if cfg["model_type"] == "cnn_rnn":
        return [hidden] * layers
    return [hidden] * layers + [hidden // 2]


def forward_flops(cfg: dict, frames: int) -> float:
    """Floating-point operations (2 a multiply-accumulate) of one chunk's
    forward of ``frames`` frames: every convolution, product and recurrence;
    elementwise work, pools and norms are not counted."""
    mels, hidden, layers = int(cfg["n_mels"]), int(cfg["hidden_size"]), int(cfg["num_layers"])
    t = frames

    def conv(cout, f, k, cin):
        return cout * f * t * k * cin

    def bilstm(i, h):
        return 2 * t * (i * 4 * h + h * 4 * h)  # both directions: projection + recurrence

    if cfg["model_type"] == "cnn_rnn":
        macs = conv(32, mels, 9, 1) + conv(64, mels // 2, 9, 32)
        lstm_in = 64 * (mels // 4)
        macs += bilstm(lstm_in, hidden) + (layers - 1) * bilstm(2 * hidden, hidden)
        macs += t * 2 * hidden * NUM_KEYS
        return 2.0 * macs
    f1, f2 = mels // 2, mels // 4
    macs = conv(32, mels, 9, 1)
    macs += conv(64, f1, 9, 32) + conv(64, f1, 9, 64) + conv(64, f1, 1, 32)
    macs += conv(128, f2, 9, 64) + conv(128, f2, 9, 128) + conv(128, f2, 1, 64)
    macs += conv(256, f2, 21, 128)
    lstm_in = 256 * (mels // 8)
    macs += bilstm(lstm_in, hidden) + (layers - 1) * bilstm(2 * hidden, hidden)
    macs += bilstm(lstm_in, hidden // 2)
    width = 2 * hidden + 2 * (hidden // 2)
    if cfg["use_attention"]:
        heads = int(cfg["num_attention_heads"])
        macs += t * width * 3 * width + 2 * heads * t * t * (width // heads) + t * width * width
    if cfg["use_onset_offset_heads"]:
        macs += t * width * hidden + 3 * t * hidden * NUM_KEYS
    else:
        macs += t * width * NUM_KEYS
    return 2.0 * macs
