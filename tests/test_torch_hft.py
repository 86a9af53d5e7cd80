"""The port's hFT-Transformer against its plain float32 reference
(``benchmark/reference/hft.py``) at a small size on
seeded weights: the eight training outputs, the loss and every leaf's
gradient in fp32 and bf16 compute, two train steps against the reference's
Adam steps, planted faults that the comparison must catch, the parameter
count at the published widths, and the AST tier's attention left as it
was."""

import math

import numpy as np
import pytest
import torch

from benchmark.reference import hft as ref
from music_transcription_tpu_torch.config import ModelConfig, TrainConfig
from music_transcription_tpu_torch.models import transformer
from music_transcription_tpu_torch.models.hft import HFTTranscriber
from music_transcription_tpu_torch.models.transcription import TranscriptionModel
from music_transcription_tpu_torch.parallel.train_step import (TrainState, dropout_generator,
                                                                train_step)
from music_transcription_tpu_torch.train.optim import make_optimizer

# every width cut, the structure kept: 3 layers a stage, 4 heads, a conv
# window of 2 x 4 + 1 frames, 10 velocity classes
SMALL = dict(model_type="hft", n_mels=12, hidden_size=16, num_layers=3, num_attention_heads=4,
             ffn_dim=24, dropout=0.1, conv_channels=2, conv_kernel=3, segment_frames=6,
             margin_frames=4, velocity_classes=10)
PUBLISHED = dict(model_type="hft", n_mels=256, hidden_size=256, num_layers=3,
                 num_attention_heads=4, ffn_dim=512, dropout=0.1)


def _inputs(cfg: ModelConfig, b=2, seed=0):
    """(mel (B, 1, M, T), velocity roll (B, 88, T)): notes of velocities 1 to
    classes - 1, some begun in the margin."""
    rng = np.random.default_rng(seed)
    t = cfg.input_frames
    mel = torch.from_numpy((rng.standard_normal((b, 1, cfg.n_mels, t)) * 5).astype(np.float32))
    roll = np.zeros((b, 88, t), np.float32)
    for i in range(b):
        for _ in range(30):
            key, start = rng.integers(88), rng.integers(t)
            roll[i, key, start:start + rng.integers(1, 6)] = rng.integers(1, cfg.velocity_classes)
    return mel, torch.from_numpy(roll)


def _model(dtype="float32", seed=0, **over):
    cfg = ModelConfig(**{**SMALL, "compute_dtype": dtype, **over})
    torch.manual_seed(seed)
    m = TranscriptionModel(cfg)
    with torch.no_grad():  # larger biases and norms than the initialisers give
        for name, p in m.model.named_parameters():
            if name.endswith("bias") or "norm" in name:
                p.add_(0.1 * torch.randn_like(p))
    return m


def _weights(m):
    return {k: v.detach().clone() for k, v in m.model.state_dict().items()}


def _program(m, mel, roll, seed=7):
    """The program's training forward, loss and gradients."""
    m.train()
    m.zero_grad()
    out = m(mel, generator=torch.Generator().manual_seed(seed))
    loss = m.loss(out, roll)
    loss.backward()
    grads = {k: p.grad.detach().clone() for k, p in m.model.named_parameters()}
    return {k: v.detach() for k, v in out.items()}, loss.detach(), grads


def _reference(m, mel, roll, seed=7, precision="float32"):
    cfg = {k: getattr(m.config, k) for k in SMALL}
    w = {k: v.requires_grad_(True) for k, v in _weights(m).items()}
    with ref.no_tf32():
        out = ref.forward(w, mel, cfg, masks=ref.Masks(torch.Generator().manual_seed(seed)),
                          precision=precision)
        loss = ref.loss(out, roll)
        grads = dict(zip(w, torch.autograd.grad(loss, list(w.values()))))
    return {k: v.detach() for k, v in out.items()}, loss.detach(), grads


def _gaps(got, want):
    """The worst output's gap in norm over its norm; the loss's relative gap;
    the worst leaf's gradient gap in norm over the larger of its reference
    norm and the median leaf's; the median leaf's gap over its own norm."""
    (out, loss, grads), (r_out, r_loss, r_grads) = got, want
    outputs = max(float((out[k] - r_out[k]).norm() / r_out[k].norm()) for k in r_out)
    median = np.median([float(g.norm()) for g in r_grads.values()])
    leaf = {k: float((grads[k] - g).norm()) / max(float(g.norm()), median)
            for k, g in r_grads.items()}
    return (outputs, float(abs(loss - r_loss) / r_loss), max(leaf.values()),
            float(np.median(list(leaf.values()))))


def test_fp32_forward_loss_and_gradients_match_the_reference():
    m = _model()
    mel, roll = _inputs(m.config)
    got = _program(m, mel, roll)
    assert set(got[0]) == {f"{k}_{s}" for k in ("onset", "offset", "mpe", "velocity")
                           for s in ("freq", "time")}
    assert got[0]["velocity_time"].shape == (2, 88, 6, 10) and got[0]["mpe_freq"].shape == (2, 88, 6)
    # fp32 against fp32: the sums in another order (the conv before the
    # windows are cut, LayerNorm's E[x^2] - E[x]^2), nothing else
    outputs, loss, grad, _ = _gaps(got, _reference(m, mel, roll))
    assert outputs < 1e-5 and loss < 1e-6 and grad < 1e-4, (outputs, loss, grad)


def test_bf16_forward_loss_and_gradients_match_the_reference():
    m = _model("bfloat16")
    mel, roll = _inputs(m.config)
    got = _program(m, mel, roll)
    assert all(torch.isfinite(g).all() for g in got[2].values())
    # bf16 keeps 8 bits. Random weights at this width amplify the rounding
    # in the first blocks, whose input is the unnormalised embedding: single
    # leaves of the conv and the first attention read gaps of 0.2-2.5 against
    # a bf16-rounded reference as well, so the bounds are on the outputs
    # (0.02-0.08 on 4 seeds) and on the median leaf (0.010-0.041); the
    # float8 reference reads 0.17-0.57 and 0.069-0.14 there
    gaps = _gaps(got, _reference(m, mel, roll))
    assert gaps[0] < 0.12 and gaps[1] < 2e-3 and gaps[3] < 0.06, gaps
    low = _gaps(got, _reference(m, mel, roll, precision="float8"))
    assert low[0] > 0.12 or low[3] > 0.06, low


def _fp32_adam_steps(m, batches, dropout_seed, cfg: TrainConfig):
    """The reference's steps: the gradient by autograd, the global-norm clip
    (max_norm / (norm + 1e-6), at most 1), L2 weight decay added, Adam with
    bias correction. Returns the losses and the weights after."""
    w = _weights(m)
    mom = {k: torch.zeros_like(v) for k, v in w.items()}
    var = {k: torch.zeros_like(v) for k, v in w.items()}
    mcfg = {k: getattr(m.config, k) for k in SMALL}
    losses = []
    for step, (mel, roll) in enumerate(batches, start=1):
        masks = ref.Masks(dropout_generator(dropout_seed, step - 1, torch.device("cpu")))
        loss, grads = ref.gradients(w, mel, roll, mcfg, masks=masks)
        losses.append(float(loss))
        norm = torch.stack([g.norm() for g in grads.values()]).norm()
        coef = min(1.0, cfg.max_grad_norm / (float(norm) + 1e-6))
        for k in w:
            g = grads[k] * coef + cfg.weight_decay * w[k]
            mom[k] = 0.9 * mom[k] + 0.1 * g
            var[k] = 0.999 * var[k] + 0.001 * g * g
            denom = (var[k] / (1 - 0.999 ** step)).sqrt() + cfg.adam_eps
            w[k] = w[k] - cfg.learning_rate / (1 - 0.9 ** step) * mom[k] / denom
    return losses, w


def test_two_train_steps_match_the_reference_adam_steps():
    m = _model()
    cfg = TrainConfig(learning_rate=1e-3)
    batches = [_inputs(m.config, seed=s) for s in (1, 2)]
    want_losses, want = _fp32_adam_steps(m, batches, 11, cfg)
    state = TrainState(m, make_optimizer(m.parameters(), cfg))
    lengths = torch.full((2,), m.config.input_frames)
    losses = [train_step(state, (mel, roll, lengths), 11, max_grad_norm=cfg.max_grad_norm)["loss"]
              for mel, roll in batches]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-6)
    got = m.model.state_dict()
    # Adam's first steps move a weight by about lr whatever its gradient's
    # size: a gradient component near Adam's eps (1e-8), whose last bits
    # differ with the order of the sums, moves its weight by a share of lr.
    # So every weight within 2 lr (two steps), and all but 1 in 200 within
    # 1% of lr
    gap = torch.cat([(got[k] - v).abs().flatten() for k, v in want.items()])
    assert float(gap.max()) < 2 * cfg.learning_rate
    assert float((gap > 1e-2 * cfg.learning_rate).float().mean()) < 5e-3


def _zero_time_pos(m):
    with torch.no_grad():
        m.model.time_pos.weight.zero_()


def _swap_axes(m):
    """The turn to time as a plain reshape: pitches and frames mixed."""
    b_f = lambda p, b: p.reshape(b * 88, m.model.frames, m.model.dim)  # noqa: E731
    m.model.to_time = b_f


@pytest.mark.parametrize("fault", [_zero_time_pos, _swap_axes])
def test_a_planted_fault_fails_the_comparison(fault):
    """The time encoder's position embedding dropped, or the bin and pitch
    axes swapped in the turn to time: the fp32 bounds above catch each."""
    m = _model()
    mel, roll = _inputs(m.config)
    want = _reference(m, mel, roll)
    fault(m)
    outputs, loss, grad, _ = _gaps(_program(m, mel, roll), want)
    assert outputs > 1e-3 and grad > 1e-3, (outputs, loss, grad)


def test_parameter_count_at_the_published_widths():
    """The count from the equations: d = 256, FFN 512, 3 layers a stage, a
    Conv2d(1 -> 4, (1, 5)) over windows of 65 frames, 256 bins, 128 frames,
    88 pitches, 128 velocity classes."""
    d, ffn, m_bins, f, v = 256, 512, 256, 128, 128
    attn, ff, norm = 4 * (d * d + d), d * ffn + ffn + ffn * d + d, 2 * d
    heads = 3 * (d + 1) + d * v + v
    conv = 4 * 5 + 4 + (4 * 61) * d + d
    count = (conv + m_bins * d + 3 * (attn + ff + norm)  # frequency encoder
             + 88 * d + (attn + ff + norm) + 2 * (2 * attn + ff + norm) + heads  # decoder
             + f * d + 3 * (attn + ff + norm) + heads)  # time encoder
    with torch.device("meta"):
        model = TranscriptionModel(ModelConfig(**PUBLISHED))
    assert sum(p.numel() for p in model.parameters()) == count == 5_516_574
    assert isinstance(model.model, HFTTranscriber) and model.config.input_frames == 192


def test_ast_attention_is_unchanged_without_dropout():
    """``_attention`` with no dropout: bit for bit the softmax(q k^T / sqrt(d))
    v it computed before the option existed, in fp32 and bf16 operands."""
    g = torch.Generator().manual_seed(3)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn(2, 3, 5, 8, generator=g).to(dtype) for _ in range(3))
        mask = torch.tril(torch.ones(5, 5, dtype=torch.bool))
        logits = torch.matmul(q.float().reshape(6, 5, 8), k.float().reshape(6, 5, 8)
                              .transpose(1, 2)) * 8**-0.5
        w = torch.softmax(logits.masked_fill(~mask, transformer.NEG), dim=-1)
        want = torch.matmul(w.to(dtype).float(), v.float().reshape(6, 5, 8))
        want = want.view(2, 3, 5, 8).transpose(1, 2).reshape(2, 5, 24)
        for got in (transformer._attention(q, k, v, mask, dtype),
                    transformer._attention(q, k, v, mask, dtype, 0.0, None)):
            assert torch.equal(got, want)
    dropped = transformer._attention(q, k, v, None, dtype, 0.5, torch.Generator().manual_seed(0))
    assert not torch.equal(dropped, transformer._attention(q, k, v, None, dtype))


def test_segments_of_another_length_are_refused():
    m = _model()
    with pytest.raises(ValueError, match="segments"):
        m(torch.zeros(1, 12, 13))


def test_targets_read_the_velocity_at_onsets_of_the_trained_frames():
    from music_transcription_tpu_torch.ops.losses import hft_targets

    roll = torch.zeros(1, 88, 10)
    roll[0, 5, 1:4] = 90.0  # begun in the margin: no onset inside
    roll[0, 7, 4:6] = 33.0
    roll[0, 7, 6:9] = 33.0  # re-struck at once: one note of mpe, one onset
    onset, offset, mpe, velocity = hft_targets(roll, 3)
    assert onset.shape == (1, 88, 4) and velocity.dtype == torch.int64
    assert onset[0, 5].sum() == 0 and mpe[0, 5].tolist() == [1, 0, 0, 0]
    assert onset[0, 7].tolist() == [0, 1, 0, 0] and velocity[0, 7].tolist() == [0, 33, 0, 0]
    assert offset[0, 5].tolist() == [1, 0, 0, 0]
    assert math.isclose(float(velocity.sum()), 33.0)
