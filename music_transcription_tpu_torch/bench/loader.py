"""Host input-pipeline throughput benchmark.

The port of the JAX package's ``scripts/bench_loader.py``. It measures what
the training loop consumes: ``Loader`` (threaded item decode + collate)
feeding ``device_prefetch`` (pinned host -> card copies on a side stream),
in chunks/s, from one of two sources:

  * cache: preprocessed chunks (``CachedMaestroDataset``), the steady-state
    training path;
  * raw: WAV decode + resample + the host mel on the fly
    (``MaestroDataset``), the cold path.

    python -m music_transcription_tpu_torch.bench.loader --cache_dir CACHE \\
        --batch_size 16 --batches 40 [--no_device] [--device cuda|cpu]
    python -m music_transcription_tpu_torch.bench.loader --root_dir ROOT --raw ...

It prints the JAX script's JSON line. The demand fields compare the rate
with what training consumes, batch_size / step time x chips, and need a
step time measured on this machine: ``--demand_step_ms`` (no default; the
fields are null without it) and ``--demand_chips`` (default 1), whose value
names the fields (``demand_<N>chip``, ``headroom_vs_<N>chip``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def build_parser():
    p = argparse.ArgumentParser(description="Input pipeline throughput")
    p.add_argument("--cache_dir", type=str, default=None)
    p.add_argument("--root_dir", type=str, default=None)
    p.add_argument("--raw", action="store_true",
                   help="force the raw WAV->mel path (ignore any cache)")
    p.add_argument("--split", type=str, default="train")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--batches", type=int, default=40)
    p.add_argument("--passes", type=int, default=1,
                   help="epochs over the loader (small caches need >1 for "
                        "a stable rate)")
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--n_mels", type=int, default=320)
    p.add_argument("--chunk_length", type=float, default=30.0)
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="where device_prefetch puts the batches (cuda: the default; "
                        "fails when no GPU is visible)")
    p.add_argument("--no_device", action="store_true",
                   help="measure Loader alone (no device_prefetch)")
    p.add_argument("--demand_step_ms", type=float, default=None,
                   help="train-step time (ms) for the demand fields; null without it")
    p.add_argument("--demand_chips", type=int, default=1,
                   help="chips the demand fields scale to (and are named by)")
    return p


def run(args) -> dict | None:
    """Time ``--passes`` x ``--batches`` batches after one warm batch;
    print the JSON line and return it (None when the dataset is too small
    or no source was given)."""
    import torch

    from music_transcription_tpu_torch.config import AudioConfig
    from music_transcription_tpu_torch.data.pipeline import Loader, device_prefetch

    acfg = AudioConfig(n_mels=args.n_mels, chunk_length=args.chunk_length)
    if args.cache_dir and not args.raw:
        from music_transcription_tpu_torch.data.cache import CachedMaestroDataset

        ds = CachedMaestroDataset(args.cache_dir, split=args.split)
        source = "cache"
    else:
        if not args.root_dir:
            print("need --root_dir (raw) or --cache_dir", file=sys.stderr)
            return None
        from music_transcription_tpu_torch.data.maestro import MaestroDataset

        ds = MaestroDataset(args.root_dir, split=args.split,
                            chunk_length=args.chunk_length, audio_cfg=acfg)
        source = "raw"

    pad_to = acfg.mel_frames_per_chunk
    loader = Loader(ds, args.batch_size, shuffle=True, seed=0,
                    num_workers=args.num_workers, drop_last=True, pad_to=pad_to)
    n_batches = min(args.batches, len(loader))
    if n_batches < 2:
        print(f"dataset too small: {len(ds)} items", file=sys.stderr)
        return None
    device = torch.device(args.device)

    def epoch_iter():
        it = iter(loader)
        if args.no_device:
            return it
        return device_prefetch(it, device, depth=2)

    def fence():
        if not args.no_device and device.type == "cuda":
            torch.cuda.synchronize(device)

    # warm one batch (thread-pool spin-up, file cache, device allocation)
    for _ in epoch_iter():
        break
    fence()

    t0 = time.perf_counter()
    n = 0
    for _ in range(args.passes):
        got = 0
        for _ in epoch_iter():
            n += 1
            got += 1
            if got >= n_batches:
                break
    fence()
    dt = time.perf_counter() - t0

    chunks_per_s = n * args.batch_size / dt
    chips = args.demand_chips
    demand = (None if args.demand_step_ms is None
              else args.batch_size / (args.demand_step_ms / 1000.0))
    result = {
        "metric": "loader_throughput",
        "source": source,
        "value": round(chunks_per_s, 1),
        "unit": "chunks/s",
        "audio_s_per_s": round(chunks_per_s * acfg.chunk_length, 0),
        "batches": n,
        "batch_size": args.batch_size,
        "num_workers": args.num_workers,
        "device_feed": not args.no_device,
        "demand_1chip": None if demand is None else round(demand, 1),
        f"demand_{chips}chip": None if demand is None else round(demand * chips, 1),
        f"headroom_vs_{chips}chip": (None if demand is None
                                     else round(chunks_per_s / (demand * chips), 2)),
    }
    print(json.dumps(result))
    return result


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from music_transcription_tpu_torch.bench import cuda_unavailable

    if cuda_unavailable(args.device):
        return 1
    return 0 if run(args) is not None else 2


if __name__ == "__main__":
    sys.exit(main())
