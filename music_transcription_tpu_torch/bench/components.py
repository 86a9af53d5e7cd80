"""Train-step component breakdown + analytic roofline.

The port of the JAX package's ``scripts/bench_components.py``. It times
forward + backward of three stages of the 89M ``CNNRNNLarge`` separately at
the training shape (bf16, T = 938 frames of a 30 s chunk):

  * the conv stack: conv1, pool, res_block1, pool, res_block2, the 7x3
    freq-aware conv, pool (training-mode BatchNorm);
  * the LSTM tier: ``rnn_main`` (3 layers, H=512) and ``rnn_local`` (1
    layer, H/2) on the same features, each recurrence through K2a forward
    and K2b backward (4 launches of each a call);
  * the attention (the plain route, as trained);

each backward the gradient of the stage's input alone, as the JAX script
takes it. ``stage_macs`` counts each stage's multiply-accumulates of the
forward as the JAX script does, and a forward + backward is taken as 3x a
forward's FLOPs, so each stage prints the TFLOP/s it reached.

    python -m music_transcription_tpu_torch.bench.components [--batch_size 16] \\
        [--device cuda|cpu]

``--lstm_backend`` is kept for flag parity: both values run the hand-written
recurrence. ``--chain`` is the number of calls in a timed window.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

# the JAX script's fixed geometry: the default model's LSTM widths, 30 s chunks
HIDDEN_SIZE, NUM_LAYERS, CHUNK_LENGTH = 512, 3, 30.0


def stage_macs(B: int, T: int, n_mels: int, H: int) -> dict[str, int]:
    """Forward multiply-accumulates of each stage, the JAX script's count."""
    mels = n_mels

    def conv_macs(cout, hw, k, cin):
        return B * cout * hw * k * cin

    hw1, hw2 = (mels // 2) * T, (mels // 4) * T
    lstm_in = 256 * (mels // 8)
    return {
        "conv_stack": (
            conv_macs(32, mels * T, 9, 1)
            + conv_macs(64, hw1, 9, 32) + conv_macs(64, hw1, 9, 64) + conv_macs(64, hw1, 1, 32)
            + conv_macs(128, hw2, 9, 64) + conv_macs(128, hw2, 9, 128) + conv_macs(128, hw2, 1, 64)
            + conv_macs(256, hw2, 21, 128)
        ),
        "lstm_tier": (
            B * T * lstm_in * 4 * H * 2            # main l1 xw (both dirs)
            + 2 * (B * T * 2 * H * 4 * H * 2)      # main l2, l3 xw
            + 3 * (T * 2 * B * H * 4 * H)          # main recurrences
            + B * T * lstm_in * 4 * (H // 2) * 2   # local xw
            + T * 2 * B * (H // 2) * 4 * (H // 2)  # local recurrence
        ),
        "attention": (
            B * T * 1536 * 3 * 1536 + 2 * B * 8 * T * T * 192 + B * T * 1536 * 1536
        ),
    }


def card_line(device) -> str:
    """``nvidia-smi``'s name and power limit of the card, or the device."""
    if device.type != "cuda":
        return str(device)
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
             f"--id={device.index or 0}"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        import torch

        return torch.cuda.get_device_name(device)
    return out.splitlines()[0]


def run(args) -> dict[str, dict]:
    """Time the three stages; print the table and return, by stage, its ms,
    TFLOP, TFLOP/s and kernel launches a call."""
    import numpy as np
    import torch
    import torch.nn as nn

    from music_transcription_tpu_torch.bench import clock, kernel_launches, launches_since, time_ms
    from music_transcription_tpu_torch.config import AudioConfig
    from music_transcription_tpu_torch.models import cnn_rnn as M

    device = torch.device(args.device)
    acfg = AudioConfig(n_mels=args.n_mels, chunk_length=CHUNK_LENGTH)
    B, T, mels = args.batch_size, acfg.mel_frames_per_chunk, args.n_mels
    H, layers = HIDDEN_SIZE, NUM_LAYERS
    rng = np.random.default_rng(0)
    dt = torch.bfloat16

    class ConvStack(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv1 = nn.Sequential(nn.Conv2d(1, 32, 3, padding=1), nn.BatchNorm2d(32))
            self.res_block1 = M.ResidualBlock(32, 64)
            self.res_block2 = M.ResidualBlock(64, 128)
            self.freq_aware_conv = nn.Sequential(nn.Conv2d(128, 256, (7, 3), padding=(3, 1)),
                                                 nn.BatchNorm2d(256))

        def forward(self, x):
            x = M._pooled_conv_bn_relu(x, self.conv1[0], self.conv1[1], dt)
            x = self.res_block1(x, dt)
            x = M._maxpool_freq(x)
            x = self.res_block2(x, dt)
            return M._pooled_conv_bn_relu(x, self.freq_aware_conv[0], self.freq_aware_conv[1], dt)

    class LstmTier(nn.Module):
        def __init__(self, n_in):
            super().__init__()
            self.rnn_main = M.BiLSTMStack(n_in, H, layers)
            self.rnn_local = M.BiLSTMStack(n_in, H // 2, 1)

        def forward(self, x):
            return torch.cat([self.rnn_main(x, dt), self.rnn_local(x, dt)], dim=-1)

    class Attention(nn.Module):
        def __init__(self, n_in):
            super().__init__()
            self.attn = M.MultiHeadSelfAttention(n_in, 8, backend="xla", dropout=0.0)

        def forward(self, x):
            return self.attn(x, dt)

    def fwdbwd(mod, x):
        xg = x.requires_grad_(True)

        def fn():
            return torch.autograd.grad(mod(xg).float().sum(), xg)[0]

        return fn

    stages = {
        "conv_stack": (ConvStack, rng.standard_normal((B, 1, mels, T))),  # NCHW
        "lstm_tier": (lambda: LstmTier(256 * (mels // 8)),
                      rng.standard_normal((B, T, 256 * (mels // 8)))),
        "attention": (lambda: Attention(2 * H + H), rng.standard_normal((B, T, 2 * H + H))),
    }
    macs = stage_macs(B, T, mels, H)
    results = {}
    for name, (make, x) in stages.items():
        torch.manual_seed(0)
        mod = make().to(device).train()
        x = torch.from_numpy(x).to(device, dt)
        before = kernel_launches()
        ms, calls = time_ms(fwdbwd(mod, x), device, args.iters, chain=args.chain)
        tflop = 3 * 2 * macs[name] / 1e12  # fwd+bwd ~ 3x fwd
        results[name] = dict(ms=ms, tflop=tflop, tflops=tflop / (ms / 1e3),
                             launches=launches_since(before, calls))
        del mod, x
        if device.type == "cuda":
            torch.cuda.empty_cache()

    print(f"\nB={B} T={T} n_mels={mels} lstm={args.lstm_backend} device={device} "
          f"({clock(device)})")
    total_ms, total_tflop = 0.0, 0.0
    for name, r in results.items():
        total_ms += r["ms"]
        total_tflop += r["tflop"]
        print(f"{name:12s} fwd+bwd {r['ms']:7.1f} ms | {r['tflop']:6.2f} TFLOP | "
              f"{r['tflops']:6.1f} TFLOP/s achieved | launches a call {r['launches']}")
    print(f"{'SUM':12s}         {total_ms:7.1f} ms | {total_tflop:6.2f} TFLOP")
    print(f"on {card_line(device)}")
    return results


def build_parser():
    p = argparse.ArgumentParser(description="Train-step component breakdown")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--n_mels", type=int, default=320)
    p.add_argument("--chain", type=int, default=4, help="calls in a timed window")
    p.add_argument("--iters", type=int, default=4)
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--lstm_backend", type=str, default="pallas", choices=["scan", "pallas"],
                   help="kept for flag parity: both run the hand-written recurrence")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from music_transcription_tpu_torch.bench import cuda_unavailable

    if cuda_unavailable(args.device):
        return 1
    run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
