"""Loss functions, a port of the JAX package's ``ops/losses.py``.

  * numerically stable BCE with logits
  * length-masked mean with denominator ``mask.sum() * 88`` (clamped >= 1)
  * linear time resampling of the logits when their T differs from the
    targets' (torch ``F.interpolate(mode='linear', align_corners=False)``)
  * multi-head loss 0.5 frame + 0.25 onset + 0.25 offset, the onset/offset
    targets derived from the frame targets' differences
  * token cross-entropy with ignore index 2 (<pad>) and optional class weights
  * the hFT-Transformer's loss (``hft_loss``): over both output stages, the
    mean BCE of onset, offset and frame activity and the mean velocity
    cross-entropy, summed with weights 1, on a segment's trained frames
"""

from __future__ import annotations

import torch

PAD_TOKEN = 2  # REMI <pad>


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Element-wise binary cross-entropy on logits (stable log-sum-exp form)."""
    logits, targets = logits.float(), targets.float()
    return torch.clamp(logits, min=0.0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def interpolate_time_linear(x: torch.Tensor, out_t: int) -> torch.Tensor:
    """(B, P, T_in) -> (B, P, out_t), align_corners=False linear resampling."""
    in_t = x.shape[-1]
    if in_t == out_t:
        return x
    pos = (torch.arange(out_t, dtype=torch.float32, device=x.device) + 0.5) * (in_t / out_t) - 0.5
    pos = torch.clamp(pos, 0.0, in_t - 1)
    lo = torch.floor(pos).long()
    hi = torch.clamp(lo + 1, max=in_t - 1)
    w = pos - lo.float()
    return x[..., lo] * (1.0 - w) + x[..., hi] * w


def masked_bce_loss(logits: torch.Tensor, targets: torch.Tensor,
                    lengths: torch.Tensor | None = None) -> torch.Tensor:
    """Single-head frame loss. logits (B, P, T'), targets (B, P, T): logits
    are resampled to T if needed; with ``lengths`` padded frames are masked
    and the mean divides by mask.sum() * P (clamped to >= 1)."""
    _, p, t = targets.shape
    per_elem = bce_with_logits(interpolate_time_linear(logits, t), targets)
    if lengths is None:
        return per_elem.mean()
    mask = (torch.arange(t, device=targets.device)[None, :] < lengths[:, None]).float()
    denom = torch.clamp(mask.sum() * p, min=1.0)
    return (per_elem * mask[:, None, :]).sum() / denom


def derive_onset_offset_targets(targets: torch.Tensor):
    """Frame targets (B, P, T) -> (onset, offset): onset[t] = max(y[t] - y[t-1], 0)
    for t >= 1, offset[t] = max(y[t] - y[t+1], 0) for t < T - 1, borders zero."""
    onset, offset = torch.zeros_like(targets), torch.zeros_like(targets)
    if targets.shape[-1] > 1:
        diff = targets[..., 1:] - targets[..., :-1]
        onset[..., 1:] = torch.clamp(diff, min=0.0)
        offset[..., :-1] = torch.clamp(-diff, min=0.0)
    return onset, offset


def multi_head_loss(logits: dict, targets: torch.Tensor,
                    lengths: torch.Tensor | None = None) -> torch.Tensor:
    """0.5 frame + 0.25 onset + 0.25 offset."""
    onset_t, offset_t = derive_onset_offset_targets(targets)
    return (0.5 * masked_bce_loss(logits["frame"], targets, lengths)
            + 0.25 * masked_bce_loss(logits["onset"], onset_t, lengths)
            + 0.25 * masked_bce_loss(logits["offset"], offset_t, lengths))


def transcription_loss(logits, targets, lengths=None) -> torch.Tensor:
    """A dict of heads -> multi-head loss; a tensor -> single-head loss."""
    if isinstance(logits, dict):
        return multi_head_loss(logits, targets, lengths)
    return masked_bce_loss(logits, targets, lengths)


def token_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                        ignore_index: int = PAD_TOKEN,
                        class_weights: torch.Tensor | None = None) -> torch.Tensor:
    """Flattened cross-entropy, mean over the positions whose target is not
    ``ignore_index``. ``class_weights`` (V,) weights each position by its
    target's weight and divides by the sum of those weights (torch
    ``CrossEntropyLoss(weight=...)``)."""
    v = logits.shape[-1]
    logp = torch.log_softmax(logits.reshape(-1, v).float(), dim=-1)
    targets = targets.reshape(-1).long()
    nll = -logp.gather(1, targets[:, None])[:, 0]
    keep = (targets != ignore_index).float()
    if class_weights is not None:
        keep = keep * class_weights.float()[targets]
    return (nll * keep).sum() / torch.clamp(keep.sum(), min=1.0)


def hft_targets(roll: torch.Tensor, margin: int):
    """A velocity roll (B, 88, F + 2 * margin) (0 = off, 1-127 = on) -> the
    targets of its trained frames [margin, margin + F): (onset, offset, mpe)
    as floats (B, 88, F) and the velocity class (B, 88, F) as int64. mpe is
    roll > 0; onset and offset are ``derive_onset_offset_targets`` of mpe
    over the whole segment, so a note begun in the margin has no onset in
    the trained frames; the velocity class is the roll's value at an onset
    and 0 elsewhere."""
    mpe = (roll > 0).float()
    onset, offset = derive_onset_offset_targets(mpe)
    kept = slice(margin, roll.shape[-1] - margin)
    onset, offset, mpe = onset[..., kept], offset[..., kept], mpe[..., kept]
    velocity = torch.where(onset > 0, roll[..., kept].float(), 0.0).long()
    return onset, offset, mpe, velocity


def hft_loss(logits: dict, roll: torch.Tensor, margin: int) -> torch.Tensor:
    """The sum over the ``freq`` and ``time`` stages of the mean BCE with
    logits of onset, offset and mpe and the mean cross-entropy of velocity
    over its classes, each over every (pitch, frame) of the batch. BCE with
    logits stands where the published code takes a sigmoid and BCELoss: the
    same function, without the sigmoid's rounding."""
    onset, offset, mpe, velocity = hft_targets(roll, margin)
    total = torch.zeros((), device=roll.device)
    for stage in ("freq", "time"):
        for name, target in (("onset", onset), ("offset", offset), ("mpe", mpe)):
            total = total + bce_with_logits(logits[f"{name}_{stage}"], target).mean()
        v = logits[f"velocity_{stage}"]
        total = total + torch.nn.functional.cross_entropy(
            v.reshape(-1, v.shape[-1]).float(), velocity.reshape(-1))
    return total
