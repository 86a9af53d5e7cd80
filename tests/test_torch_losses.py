"""PyTorch port: the losses against the JAX package's ``ops/losses.py``.

The same seeded numpy inputs through both, fp32, within 1e-6 (relative to
the value's magnitude where it exceeds 1), including the time resampling of
logits whose T differs from the targets' and batches whose rows are all
padding (length 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_transcription_tpu.ops import losses as JL
from music_transcription_tpu_torch.ops import losses as L

TOL = 1e-6


def _close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= TOL * max(1.0, np.abs(ref).max())


def _inputs(b, t_logits, t, seed):
    rng = np.random.default_rng(seed)
    logits = (3 * rng.standard_normal((b, 88, t_logits))).astype(np.float32)
    targets = (rng.random((b, 88, t)) > 0.8).astype(np.float32)
    return logits, targets


def test_bce_with_logits():
    logits, targets = _inputs(2, 9, 9, seed=0)
    logits[0, 0, :3] = [80.0, -80.0, 0.0]  # the stable form at large |x|
    _close(L.bce_with_logits(torch.from_numpy(logits), torch.from_numpy(targets)),
           JL.bce_with_logits(jnp.asarray(logits), jnp.asarray(targets)))


@pytest.mark.parametrize("t_in,t_out", [(7, 7), (7, 13), (13, 7), (1, 5), (5, 1)])
def test_interpolate_time_linear(t_in, t_out):
    x = np.random.default_rng(t_in * 10 + t_out).standard_normal((2, 3, t_in)).astype(np.float32)
    _close(L.interpolate_time_linear(torch.from_numpy(x), t_out),
           JL.interpolate_time_linear(jnp.asarray(x), t_out))


def test_interpolate_time_linear_is_torch_interpolate():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 3, 11)).astype(np.float32))
    ref = torch.nn.functional.interpolate(x, size=17, mode="linear", align_corners=False)
    assert float((L.interpolate_time_linear(x, 17) - ref).abs().max()) <= TOL


@pytest.mark.parametrize("lengths", [None, [12, 5, 0], [0, 0, 0]])
@pytest.mark.parametrize("t_logits", [12, 9])
def test_masked_bce_and_multi_head_loss(lengths, t_logits):
    logits, targets = _inputs(3, t_logits, 12, seed=t_logits)
    heads = {name: logits + k for k, name in enumerate(("frame", "onset", "offset"))}
    jl = None if lengths is None else jnp.asarray(np.array(lengths, np.int32))
    tl = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    got = L.masked_bce_loss(torch.from_numpy(logits), torch.from_numpy(targets), tl)
    ref = JL.masked_bce_loss(jnp.asarray(logits), jnp.asarray(targets), jl)
    _close(got, ref)
    got_mh = L.transcription_loss({k: torch.from_numpy(v) for k, v in heads.items()},
                                  torch.from_numpy(targets), tl)
    ref_mh = JL.transcription_loss({k: jnp.asarray(v) for k, v in heads.items()},
                                   jnp.asarray(targets), jl)
    _close(got_mh, ref_mh)
    _close(L.transcription_loss(torch.from_numpy(logits), torch.from_numpy(targets), tl), ref)
    if lengths == [0, 0, 0]:  # all padding: the clamped denominator gives exactly 0
        assert float(got) == 0.0 and float(got_mh) == 0.0


@pytest.mark.parametrize("t", [1, 2, 10])
def test_derive_onset_offset_targets(t):
    _, targets = _inputs(2, t, t, seed=t)
    for got, ref in zip(L.derive_onset_offset_targets(torch.from_numpy(targets)),
                        JL.derive_onset_offset_targets(jnp.asarray(targets))):
        _close(got, ref)


@pytest.mark.parametrize("weighted", [False, True])
def test_token_cross_entropy(weighted):
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((2, 9, 20)).astype(np.float32)
    targets = rng.integers(0, 20, (2, 9)).astype(np.int64)
    targets[0, :4] = L.PAD_TOKEN  # ignored positions
    weights = rng.uniform(0.5, 3.0, 20).astype(np.float32) if weighted else None
    got = L.token_cross_entropy(torch.from_numpy(logits), torch.from_numpy(targets),
                                class_weights=None if weights is None else torch.from_numpy(weights))
    ref = JL.token_cross_entropy(jnp.asarray(logits), jnp.asarray(targets),
                                 class_weights=None if weights is None else jnp.asarray(weights))
    _close(got, ref)
    # torch's own CrossEntropyLoss agrees
    crit = torch.nn.CrossEntropyLoss(
        ignore_index=L.PAD_TOKEN, weight=None if weights is None else torch.from_numpy(weights))
    assert abs(float(got) - float(crit(torch.from_numpy(logits).view(-1, 20),
                                       torch.from_numpy(targets).view(-1)))) <= 1e-5
    # every position ignored: 0, not a division by zero
    all_pad = torch.full((2, 9), L.PAD_TOKEN)
    assert float(L.token_cross_entropy(torch.from_numpy(logits), all_pad)) == 0.0
