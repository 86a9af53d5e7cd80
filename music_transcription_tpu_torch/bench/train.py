"""Training-step throughput benchmark.

The port of the JAX package's ``scripts/bench_train.py``. It times the train
step (``parallel/train_step.train_step``: forward, the multi-head loss,
backward, the clip and the Adam update) of the default ``cnn_rnn_large``
(bf16) at the training shape (30 s chunks) on a seeded batch, and prints
``train step: X ms | Y chunks/s | Z audio-seconds/s`` (X the median step).

    python -m music_transcription_tpu_torch.bench.train [--batch_size 16] [--steps 8] \\
        [--device cuda|cpu]

Under ``torchrun --nproc_per_node N`` the step is data-parallel over the N
ranks, each with its rows of the batch; ``--data_parallel`` other than the
number of ranks launched raises, as in the training CLI. ``--lstm_backend``
and ``--rng_impl`` are kept for flag parity: both backends run the
hand-written recurrence, and the dropout masks come from a
``torch.Generator``.
"""

from __future__ import annotations

import argparse
import sys
import time

# the JAX script's fixed geometry: the default model's widths, 30 s chunks
HIDDEN_SIZE, NUM_LAYERS, CHUNK_LENGTH = 512, 3, 30.0


def build_parser():
    p = argparse.ArgumentParser(description="Train-step throughput")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--n_mels", type=int, default=320)
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--data_parallel", type=int, default=None,
                   help="data-parallel ranks: the number torchrun launched (the default)")
    p.add_argument("--lstm_backend", type=str, default="auto",
                   choices=["auto", "scan", "pallas"],
                   help="kept for flag parity: every value runs the hand-written recurrence")
    p.add_argument("--rng_impl", type=str, default="threefry2x32",
                   choices=["threefry2x32", "rbg"],
                   help="kept for flag parity: dropout masks come from a torch.Generator")
    return p


def run(args) -> dict:
    """Time ``--steps`` train steps after a first one; print the line (rank
    0) and return {"ms", "chunks_per_s", "audio_s_per_s", "first_s"}."""
    import numpy as np
    import torch

    from music_transcription_tpu_torch.bench import clock, time_ms
    from music_transcription_tpu_torch.config import AudioConfig, ModelConfig, TrainConfig
    from music_transcription_tpu_torch.parallel.distributed import (
        maybe_initialize_distributed,
        rank_and_world,
        rank_device,
    )
    from music_transcription_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from music_transcription_tpu_torch.parallel.train_step import (
        data_parallel,
        init_train_state,
        train_step,
    )

    rank, world = rank_and_world()
    n_dev = args.data_parallel or world
    if n_dev != world:
        raise ValueError(f"data_parallel={n_dev} differs from the {world} rank(s) of this run: "
                         f"launch {n_dev} ranks with torchrun --nproc_per_node {n_dev}")
    lstm_backend = args.lstm_backend
    if lstm_backend == "auto":  # the training CLI's policy
        lstm_backend = "pallas" if args.device != "cpu" else "scan"
    multi = maybe_initialize_distributed(args.device, verbose=False)
    device = rank_device(args.device)

    acfg = AudioConfig(n_mels=args.n_mels, chunk_length=CHUNK_LENGTH)
    t = acfg.mel_frames_per_chunk
    mcfg = ModelConfig(model_type="cnn_rnn_large", n_mels=args.n_mels,
                       hidden_size=HIDDEN_SIZE, num_layers=NUM_LAYERS,
                       compute_dtype="bfloat16", lstm_backend=lstm_backend)
    tcfg = TrainConfig(batch_size=args.batch_size)
    if rank == 0:
        print(f"devices={n_dev} batch={args.batch_size} T={t} ({clock(device)})",
              file=sys.stderr)
    state = init_train_state(mcfg, tcfg, device)
    rng = np.random.default_rng(0)
    mel = rng.standard_normal((args.batch_size, 1, args.n_mels, t)).astype(np.float32)
    roll = (rng.random((args.batch_size, 88, t)) > 0.95).astype(np.float32)
    lengths = np.full((args.batch_size,), t, np.int32)
    batch = (mel, roll, lengths)
    if multi:
        mesh = make_mesh(world, device.type)
        state = data_parallel(state, mesh)
        batch = shard_batch(batch, mesh)
    batch = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in batch)

    def step():
        return train_step(state, batch, 1, max_grad_norm=tcfg.max_grad_norm)

    t0 = time.perf_counter()
    step()  # ends in a host read of the loss and the gradient norm
    first_s = time.perf_counter() - t0
    if rank == 0:
        print(f"first step: {first_s:.1f}s", file=sys.stderr)
    ms, _ = time_ms(step, device, args.steps, warmup=0)
    chunks_per_s = args.batch_size / (ms / 1e3)
    audio_s_per_s = chunks_per_s * acfg.chunk_length
    if rank == 0:
        print(f"train step: {ms:.1f} ms | {chunks_per_s:.1f} chunks/s | "
              f"{audio_s_per_s:.0f} audio-seconds/s")
    return dict(ms=ms, chunks_per_s=chunks_per_s, audio_s_per_s=audio_s_per_s,
                first_s=first_s)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from music_transcription_tpu_torch.bench import cuda_unavailable
    from music_transcription_tpu_torch.parallel.distributed import shutdown

    if cuda_unavailable(args.device):
        return 1
    try:
        run(args)
    finally:
        shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
