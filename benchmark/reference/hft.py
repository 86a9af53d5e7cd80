"""Plain reference of the hFT-Transformer in float32 torch: its forward, its
loss and their gradients, and the work counts and names the harness reads.

The one plain reference of the model: the harness's comparison and the
port's tests (``tests/test_torch_hft.py``, ``tests/test_torch_gpu.py``)
both hold the port to it. The harness's parts come after it:
``MaskStream`` (a training step's dropout masks, drawn as the program seeds
them), ``forward_flops``, ``is_trained``, ``layer`` and ``PAST_RECURRENCE``.

Written from the paper's equations and the published code's modules
(Toyama et al., "Automatic Piano Transcription with Hierarchical
Frequency-Time Transformer", ISMIR 2023, arXiv:2307.04305;
github.com/sony/hFT-Transformer ``model/model_spec2midi.py``) with plain
torch operations. It imports nothing of the port. The weights are a dict
keyed by the port's state-dict names (``conv.weight``,
``freq_encoder.0.self_attn.q.weight``, ``freq_decoder.0.cross_attn.k.bias``,
``time_heads.velocity.weight``, ...). Products run in float32 with TF32 off
(``gradients`` and ``no_tf32``).

The forward follows the published code step by step: the segment's frames
unfolded into windows of 2 * margin + 1, a Conv2d(1 -> C, (1, K)) over each
window, the features flattened as (channel, position), Linear(-> d) x
sqrt(d) plus the bin embedding, dropout; three post-LN self-attention blocks
over the bins; 88 pitch embeddings as queries, a cross-attention block and
then blocks of self-attention, cross-attention and FFN; the first-stage
heads; the pitch tokens turned to time, x sqrt(d) plus the frame embedding,
dropout, three self-attention blocks over the frames; the second-stage
heads. Each block has one LayerNorm, applied after every sublayer.

Departures from the published description, each also the port's:

  * BCE with logits on the onset, offset and mpe logits where the code takes
    a sigmoid and BCELoss: the same function, without the sigmoid's rounding;
    the eight outputs are logits;
  * the loss is the plain sum of the eight terms (weights 1), each a mean
    over every (pitch, frame) of the batch;
  * hard targets on the trained frames: mpe = roll > 0, onset and offset the
    rises and falls of mpe over the whole segment, the velocity class the
    roll's value at an onset frame and 0 elsewhere (the published labels may
    be soft);
  * outputs in the port's layout: (B, 88, F) and (B, 88, F, classes), where
    the code returns (B, F, 88) and (B, F, 88, classes);
  * no attention weights are returned.

``precision`` names a rounding applied wherever the port holds a tensor in
its compute dtype: the operands of the conv, of every dense layer but the
heads, and of both attention products, and the outputs of the conv and
those dense layers. ``float32`` leaves them; ``float8`` rounds them to float8
e4m3 at a per-tensor scale.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NUM_KEYS = 88
LN_EPS = 1e-5
HEADS = ("onset", "offset", "mpe", "velocity")


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


class Masks:
    """Dropout masks drawn from one ``torch.Generator`` in the order the
    forward reaches them: ``rand(x.shape) < 1 - rate``, kept values divided
    by 1 - rate."""

    def __init__(self, generator: torch.Generator):
        self.gen = generator

    def apply(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        keep = 1.0 - rate
        mask = torch.rand(tuple(x.shape), generator=self.gen, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def _dense(x, w, name, q):
    return q(F.linear(q(x), q(w[f"{name}.weight"]), w[f"{name}.bias"]))


def _drop(x, masks, rate):
    return x if masks is None or rate == 0 else masks.apply(x, rate)


def _attention(xq, xkv, w, name, heads, q, masks, rate):
    """Multi-head attention of ``xq`` (N, Lq, d) over ``xkv`` (N, Lk, d);
    the weights (N * heads, Lq, Lk) dropped after the softmax."""
    n, lq, d = xq.shape
    dh = d // heads

    def split(x, proj):
        return _dense(x, w, f"{name}.{proj}", q).view(n, -1, heads, dh).transpose(1, 2) \
            .reshape(n * heads, -1, dh)

    qh, kh, vh = split(xq, "q"), split(xkv, "k"), split(xkv, "v")
    p = torch.softmax(torch.bmm(q(qh), q(kh).transpose(1, 2)) / math.sqrt(dh), dim=-1)
    o = torch.bmm(q(_drop(p, masks, rate)), q(vh))  # (N * heads, Lq, dh)
    o = o.view(n, heads, lq, dh).transpose(1, 2).reshape(n, lq, d)
    return _dense(o, w, f"{name}.o", q)


def _block(x, w, name, cfg, q, masks, memory=None, self_attn=True):
    """One post-LN block: [self-attention], [cross-attention to ``memory``],
    the FFN; one LayerNorm after each."""
    heads, rate, d = int(cfg["num_attention_heads"]), float(cfg["dropout"]), x.shape[-1]

    def norm(y):
        return F.layer_norm(y, (d,), w[f"{name}.norm.weight"], w[f"{name}.norm.bias"], LN_EPS)

    if self_attn:
        x = norm(x + _drop(_attention(x, x, w, f"{name}.self_attn", heads, q, masks, rate),
                           masks, rate))
    if memory is not None:
        x = norm(x + _drop(_attention(x, memory, w, f"{name}.cross_attn", heads, q, masks,
                                      rate), masks, rate))
    h = _dense(_drop(F.relu(_dense(x, w, f"{name}.fc1", q)), masks, rate), w, f"{name}.fc2", q)
    return norm(x + _drop(h, masks, rate))


def _heads(x, w, name):
    return {k: F.linear(x, w[f"{name}.{k}.weight"], w[f"{name}.{k}.bias"]) for k in HEADS}


def forward(w: dict, mel: torch.Tensor, cfg: dict, *, masks=None,
            precision: str = "float32") -> dict:
    """(B, [1,] n_mels, F + 2 * margin) float32 log-mel -> the eight logits:
    ``{onset, offset, mpe}_{freq, time}`` (B, 88, F) and
    ``velocity_{freq, time}`` (B, 88, F, classes). Training (dropout) when
    ``masks`` is given, inference otherwise."""
    q = PRECISIONS[precision]
    spec = mel[:, 0] if mel.dim() == 4 else mel
    b, m, t = spec.shape
    margin, layers = int(cfg["margin_frames"]), int(cfg["num_layers"])
    rate = float(cfg["dropout"])
    window = 2 * margin + 1
    frames = t - 2 * margin
    d = w["freq_pos.weight"].shape[1]
    # the conv block: each trained frame's window of every bin
    win = spec.unfold(2, window, 1).permute(0, 2, 1, 3).reshape(b * frames, 1, m, window)
    c = q(F.conv2d(q(win), q(w["conv.weight"]), w["conv.bias"]))  # (B * F, C, M, 61)
    feats = c.permute(0, 2, 1, 3).reshape(b * frames, m, -1)
    h = _drop(_dense(feats, w, "freq_embed", q) * math.sqrt(d) + w["freq_pos.weight"], masks,
              rate)
    for i in range(layers):
        h = _block(h, w, f"freq_encoder.{i}", cfg, q, masks)
    p = w["pitch_pos.weight"].expand(b * frames, NUM_KEYS, d)
    for i in range(layers):
        p = _block(p, w, f"freq_decoder.{i}", cfg, q, masks, memory=h, self_attn=i > 0)
    out = {}
    for k, v in _heads(p, w, "freq_heads").items():  # (B * F, 88[, classes])
        v = v.reshape(b, frames, NUM_KEYS, -1).transpose(1, 2)
        out[f"{k}_freq"] = v if k == "velocity" else v[..., 0]
    s = p.reshape(b, frames, NUM_KEYS, d).permute(0, 2, 1, 3).reshape(b * NUM_KEYS, frames, d)
    s = _drop(s * math.sqrt(d) + w["time_pos.weight"], masks, rate)
    for i in range(layers):
        s = _block(s, w, f"time_encoder.{i}", cfg, q, masks)
    for k, v in _heads(s, w, "time_heads").items():  # (B * 88, F[, classes])
        v = v.reshape(b, NUM_KEYS, frames, -1)
        out[f"{k}_time"] = v if k == "velocity" else v[..., 0]
    return out


def targets(roll: torch.Tensor, frames: int):
    """A velocity roll (B, 88, T) -> (onset, offset, mpe, velocity class) of
    its ``frames`` trained frames, the centre of T."""
    mpe = (roll > 0).float()
    onset, offset = torch.zeros_like(mpe), torch.zeros_like(mpe)
    onset[..., 1:] = (mpe[..., 1:] - mpe[..., :-1]).clamp(min=0.0)
    offset[..., :-1] = (mpe[..., :-1] - mpe[..., 1:]).clamp(min=0.0)
    a = (roll.shape[-1] - frames) // 2
    kept = slice(a, a + frames)
    onset, offset, mpe = onset[..., kept], offset[..., kept], mpe[..., kept]
    velocity = torch.where(onset > 0, roll[..., kept], torch.zeros_like(onset)).long()
    return onset, offset, mpe, velocity


def loss(out: dict, roll: torch.Tensor, lengths=None) -> torch.Tensor:
    """The sum over both stages of the mean BCE with logits of onset, offset
    and mpe and the mean velocity cross-entropy (``lengths`` unused: a
    segment is whole)."""
    onset, offset, mpe, velocity = targets(roll, out["mpe_time"].shape[-1])
    total = 0.0
    for stage in ("freq", "time"):
        for k, target in (("onset", onset), ("offset", offset), ("mpe", mpe)):
            total = total + F.binary_cross_entropy_with_logits(out[f"{k}_{stage}"], target)
        v = out[f"velocity_{stage}"]
        total = total + F.cross_entropy(v.reshape(-1, v.shape[-1]), velocity.reshape(-1))
    return total


class no_tf32:
    """Context in which float32 products and convolutions are float32."""

    def __enter__(self):
        self.saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


def gradients(w: dict, mel: torch.Tensor, roll: torch.Tensor, cfg: dict, *, masks=None,
              precision: str = "float32"):
    """(loss, {name: gradient}) of every weight, by autograd through
    ``forward`` and ``loss``, with TF32 off."""
    leaves = {k: v.detach().float().clone().requires_grad_(True) for k, v in w.items()}
    with no_tf32():
        value = loss(forward(leaves, mel, cfg, masks=masks, precision=precision), roll)
        grads = torch.autograd.grad(value, list(leaves.values()))
    return value.detach(), dict(zip(leaves, grads))


# ---------------------------------------------------------------------------
# What the harness reads
# ---------------------------------------------------------------------------


class MaskStream(Masks):
    """The dropout masks of one training step, from one device generator
    seeded from (dropout_seed, step) through numpy's ``SeedSequence``, which
    is how the program seeds a step's masks."""

    def __init__(self, dropout_seed: int, step: int, device):
        import numpy as np

        seed = int(np.random.SeedSequence([dropout_seed, step]).generate_state(1, np.uint64)[0])
        device = torch.device(device)
        super().__init__(torch.Generator(device=device).manual_seed(seed & (2**63 - 1)))


def is_trained(name: str) -> bool:
    """Every entry of the state dict is a trained parameter."""
    return True


# hFT has no recurrence: the layers past the frequency tower, whose
# gradients do not pass back through the time encoder's input
PAST_RECURRENCE = ("time_pos", "time_encoder", "freq_heads", "time_heads")


def layer(name: str) -> str:
    """The top-level layer of a state-dict entry."""
    return name.split(".", 1)[0]


def forward_flops(cfg: dict, frames: int) -> float:
    """Floating-point operations (2 a multiply-accumulate) of one segment's
    forward of ``frames`` input frames (the trained ones and both margins):
    the conv over every trained frame's window, every dense layer and both
    products of every attention; elementwise work, softmax and norms are not
    counted."""
    d, ffn = int(cfg["hidden_size"]), int(cfg["ffn_dim"])
    layers, m = int(cfg["num_layers"]), int(cfg["n_mels"])
    margin, kernel, channels = (int(cfg["margin_frames"]), int(cfg["conv_kernel"]),
                                int(cfg["conv_channels"]))
    classes = int(cfg["velocity_classes"])
    f = frames - 2 * margin
    width = 2 * margin + 1 - kernel + 1

    def self_block(seqs, length):  # projections, QK^T and PV, FFN
        return seqs * (4 * length * d * d + 2 * length * length * d + 2 * length * d * ffn)

    def cross(seqs, lq, lk):  # q, o on the queries, k, v on the memory, both products
        return seqs * (2 * lq * d * d + 2 * lk * d * d + 2 * lq * lk * d)

    macs = f * m * channels * width * kernel + f * m * channels * width * d
    macs += layers * self_block(f, m)
    macs += cross(f, NUM_KEYS, m) + f * 2 * NUM_KEYS * d * ffn
    macs += (layers - 1) * (self_block(f, NUM_KEYS) + cross(f, NUM_KEYS, m))
    macs += layers * self_block(NUM_KEYS, f)
    macs += 2 * f * NUM_KEYS * d * (3 + classes)  # both stages' heads
    return 2.0 * macs
