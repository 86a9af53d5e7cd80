"""Attention backend microbench: the plain attention against the clamped
flash kernels, forward and forward + backward.

The port of the JAX package's ``scripts/bench_attention.py``. It times the
large model's attention (``models/cnn_rnn.MultiHeadSelfAttention``: 8 heads,
head_dim 192, 1536 wide, bf16) at several sequence lengths, for the
crossover the "auto" rule stands for: "xla" is the plain attention
(materialized fp32 scores), "pallas" the hand-written kernels, K3 in the
forward and K3 with lse, K4a and K4b in the forward + backward (the
gradient of the input alone, as the JAX script takes it).

    python -m music_transcription_tpu_torch.bench.attention [--t 938 2048 4096] [--batch 2] \\
        [--device cuda|cpu]

Prints each backend's kernel launches a call, then the JAX script's line
``T=... <backend> fwd=...ms fwd+bwd=...ms``. ``--chain`` is the number of
calls in a timed window.
"""

from __future__ import annotations

import argparse
import sys


def build_parser():
    p = argparse.ArgumentParser(description="Attention backends: plain against the flash kernels")
    p.add_argument("--t", type=int, nargs="+", default=[938, 2048, 4096])
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--head_dim", type=int, default=192)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--chain", type=int, default=5, help="calls in a timed window")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    return p


def run(args) -> list[dict]:
    """Time both backends at every ``--t``; print the lines and return a row
    a (T, backend): fwd_ms, fwdbwd_ms and the launches a call of each."""
    import numpy as np
    import torch

    from music_transcription_tpu_torch.bench import clock, launches_since, kernel_launches, time_ms
    from music_transcription_tpu_torch.models.cnn_rnn import MultiHeadSelfAttention

    device = torch.device(args.device)
    hidden = args.heads * args.head_dim
    print(f"[attn-bench] device={device} hidden={hidden} heads={args.heads} b={args.batch} "
          f"({clock(device)})", file=sys.stderr)
    rows = []
    for t in args.t:
        x = torch.from_numpy(
            0.1 * np.random.default_rng(0).standard_normal((args.batch, t, hidden))
        ).to(device, torch.bfloat16)
        for backend in ("xla", "pallas"):
            torch.manual_seed(0)
            mod = MultiHeadSelfAttention(hidden, args.heads, backend=backend,
                                         dropout=0.0).to(device)
            xg = x.clone().requires_grad_(True)

            def fwd():
                with torch.no_grad():
                    return mod(x, torch.bfloat16)

            def fwdbwd():
                out = mod(xg, torch.bfloat16)
                return torch.autograd.grad(out.float().sum(), xg)[0]

            mod.eval()
            before = kernel_launches()
            f_ms, calls = time_ms(fwd, device, args.iters, chain=args.chain)
            f_launches = launches_since(before, calls)
            mod.train()
            before = kernel_launches()
            fb_ms, calls = time_ms(fwdbwd, device, args.iters, chain=args.chain)
            fb_launches = launches_since(before, calls)
            print(f"T={t:5d} {backend:6s} launches a call: fwd {f_launches} "
                  f"fwd+bwd {fb_launches}")
            print(f"T={t:5d} {backend:6s} fwd={f_ms:8.2f}ms fwd+bwd={fb_ms:8.2f}ms")
            rows.append(dict(t=t, backend=backend, fwd_ms=f_ms, fwdbwd_ms=fb_ms,
                             fwd_launches=f_launches, fwdbwd_launches=fb_launches))
    return rows


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from music_transcription_tpu_torch.bench import cuda_unavailable

    if cuda_unavailable(args.device):
        return 1
    run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
