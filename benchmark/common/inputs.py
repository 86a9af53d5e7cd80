"""What the benchmark makes from ``--seed``: weights and a training cache. The program and the reference are handed the same.

``seeded_weights`` fills every floating entry of a module's state dict from
one generator on the card, in one draw of uniform numbers cut into leaves and
scaled as torch's default initialisers scale them (U(-1/sqrt(fan_in),
1/sqrt(fan_in)) for convolutions and dense layers, U(-k, k) with k =
1/sqrt(H) for the LSTM's weights and U(-2k, 2k) for its one combined bias),
with BatchNorm's and LayerNorm's affines and running statistics spread
around their starting values so that inference does not pass through an
identity. The module is only read for its entries' names, shapes and kinds.

``train_cache`` is ``chip_smoke.write_train_cache``'s content, log-mel-like
noise in dB and rolls of random sustained notes (10 to 119 frames each), but
with 4 to 119 notes a chunk where that has 40: chunks of music differ in
density, and rows that differ make a step over some of them read otherwise
than a step over all. It is drawn on the card in a few large calls and kept
in host memory, the mel in float16, which the program's collation widens to
float32 exactly.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn

NUM_KEYS = 88
FEWEST_NOTES, MOST_NOTES = 4, 120  # notes a chunk: 4 to 119


def _kinds(module: nn.Module) -> dict[str, str]:
    kinds = {}
    for prefix, m in module.named_modules():
        kind = ("norm" if isinstance(m, (nn.BatchNorm2d, nn.LayerNorm))
                else "dense" if isinstance(m, (nn.Conv2d, nn.Linear)) else None)
        if kind:
            for name, _ in m.named_parameters(recurse=False):
                kinds[f"{prefix}.{name}"] = kind
            for name, _ in m.named_buffers(recurse=False):
                kinds[f"{prefix}.{name}"] = kind
    return kinds


def _scaled(name: str, kind: str | None, u: torch.Tensor, shapes: dict) -> torch.Tensor:
    """Leaf ``name`` from uniform numbers ``u`` in (-1, 1)."""
    leaf = name.rsplit(".", 1)[-1]
    if kind == "norm":
        if leaf == "running_var":
            return 1.0 + 0.5 * u
        if leaf == "weight":
            return 1.0 + 0.1 * u
        return 0.1 * u  # bias, running_mean
    if kind == "dense":
        weight = shapes[name.rsplit(".", 1)[0] + ".weight"]
        fan_in = math.prod(weight[1:])
        return u / math.sqrt(fan_in)
    if leaf.startswith("weight_"):  # LSTM weight_ih / weight_hh: (4H, ·)
        return u / math.sqrt(shapes[name][0] // 4)
    if leaf.startswith("bias_ih"):
        return 2.0 * u / math.sqrt(shapes[name][0] // 4)
    return torch.zeros_like(u)  # bias_hh: held at zero


def seeded_weights(module: nn.Module, seed: int, device) -> dict[str, torch.Tensor]:
    """{name: float32 tensor on ``device``} for every floating entry of
    ``module``'s state dict (a module built on the meta device will do)."""
    sd = module.state_dict()
    names = [k for k, v in sd.items() if v.is_floating_point()]
    shapes = {k: tuple(sd[k].shape) for k in sd}
    kinds = _kinds(module)
    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(math.prod(shapes[k]) for k in names)
    flat = torch.rand(total, generator=gen, device=device).mul_(2.0).sub_(1.0)
    out, off = {}, 0
    for k in names:
        n = math.prod(shapes[k])
        out[k] = _scaled(k, kinds.get(k), flat[off:off + n].view(shapes[k]), shapes).contiguous()
        off += n
    return out


def train_cache(chunks: int, n_mels: int, frames: int, seed: int, device,
                block: int = 512) -> tuple[np.ndarray, np.ndarray]:
    """(mel (chunks, n_mels, frames) float16 dB, roll (chunks, 88, frames)
    uint8) on the host, drawn on ``device`` from one generator, ``block``
    chunks a draw."""
    gen = torch.Generator(device=device).manual_seed(seed)
    mel = torch.empty((chunks, n_mels, frames), dtype=torch.float16)
    roll = torch.empty((chunks, NUM_KEYS, frames), dtype=torch.uint8)
    most = MOST_NOTES - 1
    for a in range(0, chunks, block):
        n = min(block, chunks - a)
        m = torch.randn((n, n_mels, frames), generator=gen, device=device)
        mel[a:a + n].copy_(m.mul_(10.0).sub_(40.0).half())
        del m
        counts = torch.randint(FEWEST_NOTES, MOST_NOTES, (n, 1), generator=gen, device=device)
        keys = torch.randint(0, NUM_KEYS, (n, most), generator=gen, device=device)
        starts = torch.randint(0, frames, (n, most), generator=gen, device=device)
        lengths = torch.randint(10, 120, (n, most), generator=gen, device=device)
        kept = (torch.arange(most, device=device) < counts).int()
        row = (torch.arange(n, device=device)[:, None] * NUM_KEYS + keys) * (frames + 1)
        # +1 where a note starts, -1 where it ends; a key is on where the sum is
        edges = torch.zeros(n * NUM_KEYS * (frames + 1), dtype=torch.int32, device=device)
        edges.index_put_((row + starts,), kept, accumulate=True)
        edges.index_put_((row + (starts + lengths).clamp(max=frames),), -kept, accumulate=True)
        on = edges.view(n, NUM_KEYS, frames + 1).cumsum(-1, dtype=torch.int32)[..., :frames] > 0
        roll[a:a + n].copy_(on.to(torch.uint8))
    return mel.numpy(), roll.numpy()
