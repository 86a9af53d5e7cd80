"""Preprocessing CLI: a MAESTRO tree -> per-chunk cache files.

    python -m music_transcription_tpu_torch.preprocess --root_dir maestro-v3.0.0 \\
        --n_mels 320 --splits train,validation [--verify] [-d cuda|cpu]

The flags and their defaults are those of the JAX package's
``scripts/preprocess_dataset.py``: per-split caching with skip-if-exists and
``--force``, ``--mel`` or ``--waveform``, ``--tokenize`` (needs
``--waveform``) with ``--token_len``, ``--compact``, the cache directory
named by data type and n_mels when ``--cache_dir`` is left out,
``--dry_run``, ``--show_cache_info``, ``--verify``, ``--background`` with
``--log_file``, and a warning when the disk is short of space. ``--velocity``,
the port's own, stores velocity rolls for the hFT-Transformer (with
``--hop_length 256 --n_mels 256``).

``--device`` takes ``cuda`` (the default: a mel cache's log-mel runs on the
card in batches of ``--device_batch``; the run exits 1 when no card is
visible) or ``cpu`` (the numpy log-mel, in ``--num_workers`` processes).
Waveform and tokenized caches are written on the host either way.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
from datetime import datetime

SPLITS = ("train", "validation", "test")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Preprocess and cache the MAESTRO dataset")
    p.add_argument("--root_dir", type=str, default="maestro-v3.0.0")
    p.add_argument("--cache_dir", type=str, default=None,
                   help="auto-named by data type / n_mels when omitted")
    p.add_argument("--splits", type=str, default="train,validation,test")
    p.add_argument("--chunk_length", type=float, default=30.0)
    p.add_argument("--overlap", type=float, default=0.0)
    p.add_argument("--n_mels", type=int, default=229)
    p.add_argument("--sr", type=int, default=16000)
    p.add_argument("--hop_length", type=int, default=512)
    g = p.add_mutually_exclusive_group()
    g.add_argument("--mel", action="store_true", help="cache mel spectrograms (default)")
    g.add_argument("--waveform", action="store_true", help="cache raw waveforms (AST)")
    p.add_argument("--tokenize", action="store_true",
                   help="pre-tokenize rolls to REMI tokens (requires --waveform)")
    p.add_argument("--token_len", type=int, default=512,
                   help="token cap for --tokenize caches (pad/truncate length; "
                        "dense 30s chunks need ~1024 to avoid truncation)")
    p.add_argument("--compact", action="store_true",
                   help="store waveforms as int16 at PCM16 scale and binary "
                        "rolls as uint8 (~2.2x smaller waveform caches; "
                        "exact for 16-bit-PCM sources, half-LSB error after "
                        "resampling). Readers dequantize transparently")
    p.add_argument("--velocity", action="store_true",
                   help="store velocity rolls (1-127 where a key is on, 0 elsewhere; "
                        "uint8 with --compact), the hFT model's targets, in place of "
                        "binary ones")
    p.add_argument("--force", action="store_true", help="recompute existing chunks")
    p.add_argument("--num_workers", type=int, default=1)
    p.add_argument("--device", "-d", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default): the mel on the card, failing when no GPU is "
                        "visible; cpu: the numpy mel in --num_workers processes")
    p.add_argument("--device_batch", type=int, default=32)
    p.add_argument("--dry_run", action="store_true")
    p.add_argument("--show_cache_info", action="store_true")
    p.add_argument("--verify", action="store_true", help="verify cache integrity after run")
    p.add_argument("--background", action="store_true")
    p.add_argument("--log_file", type=str, default=None,
                   help="custom log file path (only with --background)")
    return p


def show_cache_info(cache_dir) -> None:
    from music_transcription_tpu_torch.data.cache import load_metadata, metadata_path

    print("=" * 70)
    print(f"CACHE INFO: {cache_dir}")
    print("=" * 70)
    found = False
    for split in SPLITS:
        if not os.path.exists(metadata_path(cache_dir, split)):
            continue
        found = True
        meta = load_metadata(cache_dir, split)
        split_dir = os.path.join(cache_dir, split)
        n_files = size = 0
        if os.path.isdir(split_dir):
            for f in os.scandir(split_dir):
                n_files += f.name.startswith("chunk_")
                size += f.stat().st_size
        kind = "tokens" if meta.get("tokenize") else (
            "waveform" if meta.get("return_waveform") else f"mel (n_mels={meta.get('n_mels')})")
        print(f"{split}: {meta['num_chunks']} chunks ({n_files} files, {size / 1e9:.2f} GB), "
              f"{meta.get('chunk_length')}s chunks, overlap={meta.get('overlap')}, type={kind}")
    if not found:
        print("(no cache metadata found)")


def spawn_background(argv: list[str], args) -> None:
    """Re-run this command (``argv``) detached, its output in a log file."""
    os.makedirs(args.cache_dir, exist_ok=True)
    log_path = args.log_file or os.path.join(
        args.cache_dir, f"preprocess_{datetime.now().strftime('%Y-%m-%d_%H-%M-%S')}.log")
    argv = [a for a in argv if a != "--background"]
    with open(log_path, "a") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "music_transcription_tpu_torch.preprocess"] + argv,
            stdout=log, stderr=subprocess.STDOUT, start_new_session=True)
    print(f"Preprocessing started in background (pid {proc.pid}); logs: {log_path}")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)

    if args.tokenize and not args.waveform:
        print("Error: --tokenize requires --waveform")
        return 1
    if args.cache_dir is None:
        if args.tokenize:
            args.cache_dir = "cached_dataset_tokens"
        elif args.waveform:
            args.cache_dir = "cached_dataset_waveform"
        elif args.n_mels == 229:
            args.cache_dir = "cached_dataset"
        else:
            args.cache_dir = f"cached_dataset_mels{args.n_mels}"
    if args.show_cache_info:
        show_cache_info(args.cache_dir)
        return 0

    splits = [s.strip() for s in args.splits.split(",")]
    for s in splits:
        if s not in SPLITS:
            print(f"Error: Invalid split '{s}'. Must be one of: train, validation, test")
            return 1
    if not os.path.isdir(args.root_dir):
        print(f"Error: dataset root not found: {args.root_dir}")
        return 1

    if args.dry_run:
        print("=" * 70)
        print("PREPROCESSING - DRY RUN")
        print("=" * 70)
        print(f"Root:        {args.root_dir}")
        print(f"Cache dir:   {args.cache_dir}")
        print(f"Splits:      {', '.join(splits)}")
        print(f"Chunks:      {args.chunk_length}s, overlap={args.overlap}")
        kind = "waveform+tokens" if args.tokenize else ("waveform" if args.waveform else "mel")
        print(f"Data type:   {kind}" + ("" if args.waveform else f" (n_mels={args.n_mels})"))
        print(f"Device:      {args.device}")
        print(f"Workers:     {args.num_workers}")
        print("This is a DRY RUN - nothing will be written.")
        return 0

    cache_parent = os.path.dirname(os.path.abspath(args.cache_dir))
    free_gb = shutil.disk_usage(cache_parent if os.path.isdir(cache_parent) else ".").free / 1e9
    if free_gb < 40 and not args.waveform:
        print(f"Warning: only {free_gb:.0f} GB free; a full n_mels={args.n_mels} "
              f"mel cache needs tens of GB.")

    if args.background:
        spawn_background(argv, args)
        return 0

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("Error: CUDA is not available: no GPU is visible to PyTorch. "
              "Pass -d cpu to preprocess on the CPU.")
        return 1

    from music_transcription_tpu_torch.config import AudioConfig
    from music_transcription_tpu_torch.data.cache import verify_cache
    from music_transcription_tpu_torch.data.preprocess import preprocess_split

    audio_cfg = AudioConfig(sample_rate=args.sr, hop_length=args.hop_length,
                            n_mels=args.n_mels, chunk_length=args.chunk_length)
    for split in splits:
        print(f"Preprocessing split '{split}'...")
        preprocess_split(
            root_dir=args.root_dir, cache_dir=args.cache_dir, split=split,
            audio_cfg=audio_cfg, chunk_length=args.chunk_length, overlap=args.overlap,
            return_waveform=args.waveform, tokenize=args.tokenize, force=args.force,
            num_workers=args.num_workers, device=args.device,
            device_batch=args.device_batch, compact=args.compact, token_len=args.token_len,
            velocity=args.velocity)
        if args.verify:
            ok, msg = verify_cache(args.cache_dir, split)
            print(f"[{split}] verify: {'OK' if ok else 'FAILED'} — {msg}")
            if not ok:
                return 1
    print(f"Done. Cache at {args.cache_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
