"""Training CLI for the CNN-RNN transcription models, and the port's
hFT-Transformer, on a CUDA card.

    python -m music_transcription_tpu_torch.train --root_dir maestro-v3.0.0 \\
        --cache_dir cached --model_type cnn_rnn_large --n_mels 320 --epochs 100 \\
        --batch_size 24 [-d cuda|cpu]

The hFT-Transformer at its published settings (hop 256, which this model
takes; segments of 128 frames with 32 margin frames on each side, so
``--chunk_length`` 3.072 s; ``--chunk_overlap`` a third, the margins'
1.024 s, so that the segments' trained frames tile the audio, the same
share as the preprocessing CLI's ``--overlap``; the rolls carry
velocities, from a cache written by the preprocessing CLI's
``--velocity``):

    python -m music_transcription_tpu_torch.train --model_type hft --n_mels 256 \\
        --hidden_size 256 --num_layers 3 --num_attention_heads 4 --dropout 0.1 \\
        --chunk_length 3.072 --chunk_overlap 0.3333333333333333 --batch_size 8

Data-parallel training runs one process a rank, launched by torchrun:

    torchrun --standalone --nproc_per_node N -m music_transcription_tpu_torch.train \
        <the flags above> [--partitioning dp|zero1|fsdp|tp] [--model_parallel M]

The flags and their defaults are those of the JAX package's
``scripts/train_cnn.py``, so a command line moves between the two. ``--device``
takes ``cuda`` (the default; the run exits 1 when no card is visible) or
``cpu``. Under torchrun each rank joins the process group
(``parallel/distributed.py``: NCCL with a card a rank, gloo when ranks share
a card or run on the CPU), takes its round-robin share of each split
(``ProcessShard``) and loads ``batch_size`` / n_data rows a step;
``--batch_size`` stays the global batch. ``--model_parallel M`` > 1 lays the
N ranks out as a ``(N / M, M)`` ``(data, model)`` mesh (``--data_parallel``
rows, N / M by default): rank r loads the rows of data index r // M, which
its M model peers share. Otherwise ``--data_parallel`` is the number of
ranks, and any other value raises (the JAX package takes a subset of its
devices; here that would leave ranks idle). ``--partitioning zero1`` shards
Adam's moments, ``fsdp`` the parameters and gradients too, ``tp`` the same
on the feature dims (all three on one node, with more than one rank; on a
2-D mesh they shard over ``model`` and replicate over ``data``; ``dp``
refuses ``--model_parallel`` > 1). ``--device_data on`` stages the whole cache
(a rank's shard) on the device once; ``slab`` (and ``auto`` on one card when
the staged cache would reach ``STAGE_LIMIT_BYTES``) rotates slabs of
``--slab_gb`` through the device (``data/pipeline.SlabRotatingLoader``),
with the validation split staged whole; ``off`` (and ``auto`` under
torchrun, as the JAX package streams on a mesh) streams batches from the
host.

Exit codes: 0 done, 1 error, 66 stall watchdog, 67 planned RSS recycle
(rerun with ``--resume auto`` to continue).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from datetime import datetime

# the JAX package's rule for staging the whole cache (bytes, train + val)
STAGE_LIMIT_BYTES = 11e9


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train a transcription model (PyTorch/CUDA)")
    d = p.add_argument_group("dataset")
    d.add_argument("--root_dir", type=str, default="maestro-v3.0.0")
    d.add_argument("--cache_dir", "--cached_dir", type=str, default=None,
                   help="preprocessed cache directory (auto-detected name if omitted)")
    d.add_argument("--year", type=str, default=None)
    d.add_argument("--subset_size", type=int, default=None, help="Quick debug run")

    t = p.add_argument_group("training")
    t.add_argument("--epochs", type=int, default=100)
    t.add_argument("--batch_size", type=int, default=24)
    t.add_argument("--lr", type=float, default=1e-4)
    t.add_argument("--weight_decay", type=float, default=1e-5)
    t.add_argument("--chunk_length", type=float, default=30.0)
    t.add_argument("--chunk_overlap", type=float, default=0.0)
    t.add_argument("--save_every", type=int, default=5)
    t.add_argument("--save_best_every", type=int, default=1,
                   help="write model_best at most every k epochs on val improvement")
    t.add_argument("--early_stop_patience", type=int, default=0,
                   help="stop when val loss has not improved for N epochs (0 = off)")
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--num_workers", type=int, default=8)
    t.add_argument("--start_epoch", type=int, default=1,
                   help="starting epoch number (auto-detected from the --resume "
                        "filename when left at 1)")

    m = p.add_argument_group("model")
    m.add_argument("--model_type", "--model", type=str, default="cnn_rnn_large",
                   choices=["cnn_rnn", "cnn_rnn_large", "hft"])
    m.add_argument("--n_mels", type=int, default=320)
    m.add_argument("--hidden_size", type=int, default=512)
    m.add_argument("--num_layers", type=int, default=3)
    m.add_argument("--dropout", type=float, default=0.2)
    m.add_argument("--num_attention_heads", type=int, default=8)
    m.add_argument("--no_attention", action="store_true")
    m.add_argument("--no_onset_offset_heads", action="store_true")
    m.add_argument("--use_attention", action="store_true", default=True, help=argparse.SUPPRESS)
    m.add_argument("--use_onset_offset_heads", action="store_true", default=True,
                   help=argparse.SUPPRESS)
    m.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    m.add_argument("--lstm_backend", type=str, default="auto",
                   choices=["auto", "scan", "pallas"],
                   help="kept for sidecar parity: auto = 'pallas' on the card, 'scan' on "
                        "the CPU; both run ops/lstm_kernel.py")

    e = p.add_argument_group("execution")
    e.add_argument("--device", "-d", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="device to train on (default: cuda; fails when no GPU is visible)")
    e.add_argument("--data_parallel", type=int, default=None,
                   help="data-parallel ranks: the number torchrun launched (the default)")
    e.add_argument("--partitioning", type=str, default="dp",
                   choices=["dp", "zero1", "fsdp", "tp"],
                   help="train-state placement over the ranks: dp replicated, zero1 Adam "
                        "moments sharded, fsdp parameters too, tp parameters on their "
                        "feature dims")
    e.add_argument("--model_parallel", type=int, default=1,
                   help="ranks of the model axis of a 2-D (data, model) mesh (> 1 needs "
                        "zero1, fsdp or tp)")
    e.add_argument("--resume", type=str, default=None,
                   help="checkpoint to resume from (.pt full state, .pth weights), or "
                        "'auto' for the newest in --run_dir")
    e.add_argument("--run_dir", type=str, default=None)
    e.add_argument("--out_root", type=str, default="outputs")
    e.add_argument("--background", action="store_true",
                   help="re-spawn detached with logs redirected")
    e.add_argument("--log_file", type=str, default=None,
                   help="log file path for background mode (auto-generated if not specified)")
    e.add_argument("--profile_steps", type=int, default=0,
                   help="trace the first N train steps with torch.profiler; the trace "
                        "carries the step's and the model's spans (train.*, model.*)")
    e.add_argument("--rng_impl", type=str, default="auto",
                   choices=["auto", "threefry2x32", "rbg"],
                   help="kept for sidecar parity; the port's dropout draws from a "
                        "torch.Generator")
    e.add_argument("--stall_timeout", "--stall-timeout", type=float, default=0.0,
                   help="exit 66 when no train/val step completes for this many "
                        "seconds (0 = off)")
    e.add_argument("--device_data", "--device-data", type=str, default="auto",
                   choices=["auto", "on", "off", "slab"],
                   help="stage the dataset on the device once and gather batches there. "
                        "auto = on a card: whole when the staged data stays under "
                        f"{STAGE_LIMIT_BYTES / 1e9:.0f} GB, slab rotation when it does not; "
                        "'slab' forces rotation; 'off' streams batches from the host")
    e.add_argument("--slab_gb", "--slab-gb", type=float, default=3.5,
                   help="HBM budget per slab for slab-rotation feeding "
                        "(double-buffered: peak data HBM = 2 slabs). Used "
                        "when the cache outgrows whole-cache staging")
    e.add_argument("--slab_passes", "--slab-passes", type=int, default=1,
                   help="passes over each staged slab before rotating (>1 "
                        "amortizes slow-link staging at a sampling-"
                        "correlation cost)")
    e.add_argument("--rss_watermark_gb", "--rss-watermark-gb", type=float, default=0.0,
                   help="checkpoint and exit 67 when host RSS crosses this at an epoch "
                        "boundary (0 = off)")
    return p


def spawn_background(argv: list[str], args, run_dir: str) -> None:
    """Re-run this command (``argv``) detached, its output in a log file."""
    os.makedirs(run_dir, exist_ok=True)
    log_path = args.log_file or os.path.join(run_dir, "train.log")
    argv = [a for a in argv if a != "--background"] + ["--run_dir", run_dir]
    with open(log_path, "a") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "music_transcription_tpu_torch.train"] + argv,
            stdout=log, stderr=subprocess.STDOUT, start_new_session=True)
    print(f"Training started in background (pid {proc.pid})")
    print(f"Logs: {log_path}")
    print(f"Check: ps aux | grep {proc.pid}")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    if args.run_dir is None:
        args.run_dir = os.path.join(args.out_root, datetime.now().strftime("%Y-%m-%d_%H-%M-%S"))
    if args.background:
        spawn_background(argv, args, args.run_dir)
        return 0

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("Error: CUDA is not available: no GPU is visible to PyTorch. "
              "Pass -d cpu to train on the CPU.")
        return 1

    from music_transcription_tpu_torch.parallel.distributed import (
        maybe_initialize_distributed,
        rank_device,
        shutdown,
    )
    from music_transcription_tpu_torch.train.loop import install_graceful_sigterm

    install_graceful_sigterm()  # `kill <pid>` flushes model_best as Ctrl-C does
    # before the first device use: under torchrun, join the ranks' group
    multi = maybe_initialize_distributed(args.device)
    try:
        return _train(args, multi, rank_device(args.device))
    finally:
        shutdown()  # a rank that stops holds no other rank in a collective


def _train(args, multi: bool, device) -> int:
    from music_transcription_tpu_torch.checkpoints import (
        epoch_from_checkpoint_name,
        latest_resumable_checkpoint,
    )
    from music_transcription_tpu_torch.config import (
        HFT_HOP_LENGTH,
        AudioConfig,
        CompatibilityError,
        ModelConfig,
        TrainConfig,
        validate_compatibility,
    )
    from music_transcription_tpu_torch.data.cache import (
        HybridMaestroDataset,
        load_metadata,
        metadata_path,
    )
    from music_transcription_tpu_torch.data.pipeline import (
        DeviceStagedLoader,
        Loader,
        SlabRotatingLoader,
    )
    from music_transcription_tpu_torch.parallel.distributed import (
        ProcessShard,
        data_coordinate,
        local_batch_size,
    )
    from music_transcription_tpu_torch.train.loop import HostMemoryRecycle, train_model
    from music_transcription_tpu_torch.train.watchdog import RECYCLE_EXIT_CODE

    lstm_backend = args.lstm_backend
    if lstm_backend == "auto":
        lstm_backend = "pallas" if args.device != "cpu" and args.partitioning == "dp" else "scan"
    hft = args.model_type == "hft"
    hop = HFT_HOP_LENGTH if hft else AudioConfig.hop_length
    audio_cfg = AudioConfig(n_mels=args.n_mels, chunk_length=args.chunk_length, hop_length=hop)
    model_cfg = ModelConfig(
        model_type=args.model_type, n_mels=args.n_mels, hidden_size=args.hidden_size,
        num_layers=args.num_layers, dropout=args.dropout,
        use_attention=not args.no_attention,
        use_onset_offset_heads=not args.no_onset_offset_heads,
        num_attention_heads=args.num_attention_heads,
        compute_dtype=args.compute_dtype, lstm_backend=lstm_backend)
    if hft and audio_cfg.roll_frames_per_chunk != model_cfg.input_frames:
        print(f"Error: hft trains on segments of {model_cfg.input_frames} frames "
              f"({model_cfg.segment_frames} and 2 x {model_cfg.margin_frames} margin); "
              f"--chunk_length {args.chunk_length} gives {audio_cfg.roll_frames_per_chunk} "
              f"at hop {hop}")
        return 1
    train_cfg = TrainConfig(
        epochs=args.epochs, batch_size=args.batch_size, learning_rate=args.lr,
        weight_decay=args.weight_decay, chunk_length=args.chunk_length,
        chunk_overlap=args.chunk_overlap, save_every=args.save_every,
        save_best_every=args.save_best_every, early_stop_patience=args.early_stop_patience,
        seed=args.seed, data_parallel=args.data_parallel, partitioning=args.partitioning,
        model_parallel=args.model_parallel, rng_impl=args.rng_impl,
        stall_timeout_s=args.stall_timeout, rss_watermark_gb=args.rss_watermark_gb,
        num_workers=args.num_workers)

    if args.cache_dir is None:
        args.cache_dir = "cached_dataset" if args.n_mels == 229 else f"cached_dataset_mels{args.n_mels}"
    if os.path.exists(metadata_path(args.cache_dir, "train")):
        try:
            for w in validate_compatibility(model_n_mels=args.n_mels,
                                            cache_meta=load_metadata(args.cache_dir, "train"),
                                            audio=audio_cfg):
                print(f"Warning: {w}")
        except CompatibilityError as exc:
            print(f"Error: {exc}")
            return 1

    common = dict(root_dir=args.root_dir, cache_dir=args.cache_dir,
                  chunk_length=args.chunk_length, audio_cfg=audio_cfg, year=args.year,
                  subset_size=args.subset_size)
    if hft:  # targets from velocity rolls
        common["velocity"] = True
    train_set = HybridMaestroDataset(split="train", overlap=args.chunk_overlap, **common)
    val_set = HybridMaestroDataset(split="validation", overlap=0.0, **common)
    if hft and any(d.use_cache and not d.dataset.metadata.get("velocity")
                   for d in (train_set, val_set)):
        print(f"Error: the cache {args.cache_dir} holds binary rolls; hft trains on velocity "
              f"rolls: preprocess with --velocity")
        return 1
    print(f"Train set size: {len(train_set)} chunks")
    print(f"Validation set size: {len(val_set)} chunks")
    loader_batch = args.batch_size  # the global batch; each rank loads its share
    if multi:
        # by data index: the model peers of a 2-D mesh load the same rows
        mp = max(1, args.model_parallel or 1)
        index, count = data_coordinate(mp)
        train_set = ProcessShard(train_set, index, count)
        val_set = ProcessShard(val_set, index, count)
        loader_batch = local_batch_size(args.batch_size, mp)

    # fixed-shape batches: a chunk's frames, or hft's segment
    pad_to = model_cfg.input_frames if hft else audio_cfg.mel_frames_per_chunk
    # Under bf16 compute the mel is staged as bf16 (the first convolution
    # makes the same cast) and the binary roll as uint8: about 43% of fp32.
    compact = args.compute_dtype == "bfloat16"
    per_frame = (args.n_mels * 2 + 88) if compact else 4 * (args.n_mels + 88)
    est_bytes = (len(train_set) + len(val_set)) * pad_to * per_frame
    one_card = args.device == "cuda" and not multi  # auto streams under torchrun
    use_staged = args.device_data == "on" or (args.device_data == "auto" and one_card
                                               and est_bytes < STAGE_LIMIT_BYTES)
    use_slab = not use_staged and (args.device_data == "slab"
                                   or (args.device_data == "auto" and one_card))
    roll_field = "velocity_fields" if hft else "u8_fields"
    staged_kw = {"bf16_fields": (0,), roll_field: (1,)} if compact else {}
    if use_staged:
        train_loader = DeviceStagedLoader(
            train_set, loader_batch, device=device, shuffle=True, seed=args.seed,
            num_workers=args.num_workers, drop_last=True, pad_to=pad_to, verbose=True,
            **staged_kw)
    elif use_slab:
        train_loader = SlabRotatingLoader(
            train_set, loader_batch, device=device, seed=args.seed,
            num_workers=args.num_workers, pad_to=pad_to, slab_bytes=args.slab_gb * 1e9,
            passes_per_slab=args.slab_passes, verbose=True, **staged_kw)
    else:
        train_loader = Loader(train_set, loader_batch, shuffle=True, seed=args.seed,
                              num_workers=args.num_workers, drop_last=True, pad_to=pad_to)
    if use_staged or use_slab:
        # the validation split is small beside the train split: staged whole
        val_loader = DeviceStagedLoader(
            val_set, loader_batch, device=device,
            num_workers=max(1, args.num_workers // 2), pad_to=pad_to, pad_last_batch=True,
            verbose=True, **staged_kw)
    else:
        # validation keeps the tail batch, padded with rows of length 0
        val_loader = Loader(val_set, loader_batch, num_workers=max(1, args.num_workers // 2),
                            pad_to=pad_to, pad_last_batch=True)
    if len(val_loader) == 0:
        val_loader = None

    if args.resume == "auto":
        args.resume = latest_resumable_checkpoint(args.run_dir)
        print(f"--resume auto -> {args.resume or 'fresh start'}")
    start_epoch = args.start_epoch
    if args.resume and args.start_epoch == 1:
        parsed = epoch_from_checkpoint_name(args.resume)
        if parsed is not None:
            start_epoch = parsed + 1
            print(f"Resuming from epoch {parsed}; starting at {start_epoch}")

    try:
        train_model(model_cfg=model_cfg, train_cfg=train_cfg, audio_cfg=audio_cfg,
                    train_loader=train_loader, val_loader=val_loader, run_dir=args.run_dir,
                    resume_from=args.resume, start_epoch=start_epoch, device=device,
                    profile_steps=args.profile_steps)
    except HostMemoryRecycle as r:
        print(f"\nRecycle requested: {r}")
        return RECYCLE_EXIT_CODE
    print(f"\nTraining complete. Artifacts in {args.run_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
