"""The reference's training steps and the numbers that judge a program's.

``reference_steps`` follows a configuration's first training steps in plain
float32: the forward and loss of its reference module, the gradient by
autograd, the global-norm clip (coefficient max_norm / (norm + 1e-6), at
most 1), L2 weight decay added to the clipped gradient, and Adam (beta 0.9,
0.999) with bias correction, the recipe's optimizer written out.

``leaf_gaps`` takes two sides' per-leaf norms and gives each leaf's gap
between them, over the reference's norm of that leaf or of the median leaf,
whichever is larger.
"""

from __future__ import annotations

import math
import statistics

import numpy as np
import torch

BETAS = (0.9, 0.999)


def no_tf32():
    """Context in which float32 products and convolutions are float32."""
    return _NoTF32()


class _NoTF32:
    def __enter__(self):
        self.saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


def leaf_norms(tensors: dict) -> dict[str, float]:
    names = list(tensors)
    norms = torch.stack([tensors[k].detach().double().norm() for k in names]).cpu().tolist()
    return dict(zip(names, norms))


def reference_steps(model, weights: dict, batches, masks, cfg: dict, *, lr: float,
                    eps: float, weight_decay: float, max_grad_norm: float,
                    precision: str = "float32") -> dict:
    """Steps of ``model`` (a reference module: ``forward``, ``loss``,
    ``is_trained``) from ``weights`` over ``batches`` [(mel, roll, lengths)],
    step i's dropout masks from ``masks[i]``. Returns the losses, the
    per-leaf norms of the first step's raw gradient and of the gradient Adam
    takes (clipped, weight decay added), and of each leaf's change."""
    w = {k: v.detach().float().clone() for k, v in weights.items()}
    names = [k for k in w if model.is_trained(k)]
    for k in names:
        w[k].requires_grad_(True)
    start = {k: w[k].detach().clone() for k in names}
    m = {k: torch.zeros_like(w[k]) for k in names}
    v = {k: torch.zeros_like(w[k]) for k in names}
    out = {"losses": []}
    with no_tf32():
        for step, ((mel, roll, lengths), stream) in enumerate(zip(batches, masks), start=1):
            loss = model.loss(model.forward(w, mel, cfg, masks=stream, precision=precision),
                              roll, lengths)
            grads = dict(zip(names, torch.autograd.grad(loss, [w[k] for k in names])))
            out["losses"].append(float(loss.detach()))
            with torch.no_grad():
                norm = torch.stack([g.norm() for g in grads.values()]).norm()
                coef = torch.clamp(max_grad_norm / (norm + 1e-6), max=1.0)
                if step == 1:
                    out["raw_grad"] = leaf_norms(grads)
                for k in names:
                    g = grads[k] * coef + weight_decay * w[k]
                    m[k].mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                    v[k].mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                    grads[k] = g
                if step == 1:
                    out["grad"] = leaf_norms(grads)
                for k in names:
                    denom = (v[k].sqrt() / math.sqrt(1 - BETAS[1] ** step)).add_(eps)
                    w[k].addcdiv_(m[k], denom, value=-lr / (1 - BETAS[0] ** step))
            del grads, loss
    with torch.no_grad():
        out["change"] = leaf_norms({k: w[k] - start[k] for k in names})
    return out


def leaf_gaps(got: dict, ref: dict, keep) -> dict[str, float]:
    """{leaf: |got - ref| / max(ref, median of ref over ``keep``)} over
    ``keep``."""
    keep = list(keep)
    med = statistics.median(ref[k] for k in keep)
    return {k: abs(got[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keep}


def median_leaf(got: dict, ref: dict, keep) -> float:
    """The median over ``keep`` of |got - ref| / ref."""
    return statistics.median(abs(got[k] - ref[k]) / max(ref[k], 1e-30) for k in keep)


def moved_leaves(raw_grad: dict, share: float = 1e-3) -> list[str]:
    """The leaves whose raw first gradient in the reference is at least
    ``share`` of the median leaf's: the others (a convolution's bias before a
    training BatchNorm, whose gradient is nought) move under Adam by
    round-off alone."""
    med = statistics.median(raw_grad.values())
    return [k for k, g in raw_grad.items() if g >= share * med]


def staged_batches(mel, roll, batch: int, seed: int, steps: int, round_bf16: bool, device):
    """The first ``steps`` batches of a cache staged on the card with its
    order shuffled: epoch e's order is ``np.random.default_rng(seed +
    e).shuffle(arange(n))``, cut into whole batches; under bfloat16 compute
    the mel is staged rounded to bfloat16. [(mel (B, 1, M, T), roll (B, 88,
    T), lengths (B,))] in float32 on ``device``, from the cache's host arrays
    (the mel in any float type, the roll 0 or 1)."""
    n = mel.shape[0]
    out, epoch = [], 0
    while len(out) < steps:
        idx = np.arange(n)
        np.random.default_rng(seed + epoch).shuffle(idx)
        for b in range(n // batch):
            if len(out) == steps:
                break
            sel = idx[b * batch:(b + 1) * batch]
            m = torch.from_numpy(mel[sel]).to(device).float()
            if round_bf16:
                m = m.to(torch.bfloat16).float()
            r = torch.from_numpy(roll[sel]).to(device).float()
            lengths = torch.full((len(sel),), mel.shape[-1], dtype=torch.int64, device=device)
            out.append((m[:, None], r, lengths))
        epoch += 1
    return out
