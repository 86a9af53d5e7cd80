"""Evaluation CLI: framewise F1 over a split, with threshold tuning, on a
CUDA card.

    python -m music_transcription_tpu_torch.evaluate --model model_best.pth \\
        --cache_dir cached_dataset_mels320 --split test --tune_threshold [-d cuda|cpu]

The flags are those of the JAX package's ``scripts/evaluate.py``, with
``-d/--device cuda|cpu`` (default cuda; the run exits 1 when no card is
visible): cache or raw data detected, the model config read from the
checkpoint's ``.json`` sidecar (or the CLI's overrides), and the modes
``--headless`` (``EVAL_MEAN_F1=<v>`` and the other ``EVAL_*=`` lines), the
coarse-to-fine ``--tune_threshold`` on ``--tune_split``, ``--onset_f1``,
``--window`` and ``--full_pieces`` (raw data), ``--dry_run``,
``--show_results``, ``--verify_compatibility`` and ``--background``. The
normal mode writes eval_summary.txt, confusion_matrix.png and per-sample
MIDIs under ``--out_dir``.

Probabilities are computed once per split in device batches; every threshold
of the sweep reuses them. Checkpoints are ``.pth`` + ``.json`` as
``transcribe.load_model`` reads them.

Across ranks, as the JAX package's multi-host evaluation:

    torchrun --standalone --nproc_per_node N -m music_transcription_tpu_torch.evaluate ...

each rank joins the group (``parallel/distributed.py``) before it touches a
device, takes its card (``rank_device``), and forwards its exact round-robin
share of the eval split and of the tune split (``ProcessShard(exact=True)``:
no sample twice) with no collective in the forward. Per-sample F1 and onset
F1 are gathered back into global order (NaN-padded to equal lengths), the
tuning grid's F1 sums and counts are summed over the ranks at every round
(``tune_threshold``'s ``grid_fn``), and the confusion is summed, so every
number is one process's. The gathers are of host arrays, over gloo (a gloo
group of their own when the ranks run NCCL). Rank 0 alone prints the
``EVAL_*`` lines and writes files; every rank leaves the group on every
exit. ``--full_pieces`` is not sharded: rank 0 scores every piece.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
from datetime import datetime

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Evaluate a transcription model (framewise F1)")
    p.add_argument("--model", type=str, required=False, help="checkpoint (.pth + .json sidecar)")
    p.add_argument("--split", type=str, default="test", choices=["train", "validation", "test"])
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--subset", type=int, default=None, help="evaluate only N samples")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--root_dir", type=str, default="maestro-v3.0.0")
    p.add_argument("--cache_dir", type=str, default=None)
    p.add_argument("--data_source", type=str, default="auto", choices=["auto", "cache", "full"],
                   help="auto-detect, cached chunks, or full raw files")
    p.add_argument("--year", type=str, default=None,
                   help="year filter (full files only, e.g. 2017)")
    p.add_argument("--log_file", type=str, default=None,
                   help="custom log file path (only with --background)")
    p.add_argument("--out_dir", type=str, default="eval_outputs")
    p.add_argument("--no_midi", action="store_true")
    p.add_argument("--midi_limit", type=int, default=50)
    p.add_argument("--headless", action="store_true",
                   help="print only EVAL_MEAN_F1=<v> (for scripts/benchmarks)")
    p.add_argument("--onset_f1", action="store_true",
                   help="also report note-level onset F1 (±50 ms tolerance)")
    p.add_argument("--full_pieces", action="store_true",
                   help="evaluate whole raw recordings through the inference pipeline "
                        "(chunk -> batched forward -> concatenated roll) against full-length "
                        "MIDI rolls, with a seam-vs-interior F1 breakdown. Raw data source "
                        "only; uses --threshold")
    p.add_argument("--overlap", type=float, default=0.0,
                   help="chunk overlap in seconds for --full_pieces (stitched rolls); "
                        "0 = non-overlapping chunks")
    p.add_argument("--seam_frames", type=int, default=8,
                   help="half-width (frames) of the band around chunk seams for --full_pieces")
    p.add_argument("--window", type=float, default=None,
                   help="evaluate at this inference window in seconds instead of the "
                        "checkpoint's chunk length (one forward at large T, flash attention "
                        "through the 'auto' rule). Raw data source only")
    p.add_argument("--onset_tolerance", type=float, default=0.05)
    p.add_argument("--device", "-d", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="device to evaluate on (default: cuda; fails when no GPU is visible)")
    # model config overrides (read from the checkpoint's sidecar when present)
    p.add_argument("--model_type", type=str, default=None)
    p.add_argument("--n_mels", type=int, default=None)
    p.add_argument("--hidden_size", type=int, default=None)
    p.add_argument("--num_layers", type=int, default=None)
    p.add_argument("--dropout", type=float, default=None,
                   help="model dropout rate (inactive at eval; accepted for CLI parity)")
    # threshold tuning
    p.add_argument("--tune_threshold", action="store_true")
    p.add_argument("--tune_split", type=str, default="validation",
                   choices=["train", "validation", "test"],
                   help="split the threshold is tuned on (default: validation). Equal to "
                        "--split, the reported F1 is tuned on the set it reports (a warning "
                        "says so)")
    p.add_argument("--tune_rounds", type=int, default=6)
    p.add_argument("--tune_range", type=float, nargs=2, default=[0.05, 0.95])
    p.add_argument("--tune_step", type=float, default=0.1)
    p.add_argument("--tune_min_step", type=float, default=0.01)
    # modes
    p.add_argument("--dry_run", action="store_true")
    p.add_argument("--show_results", type=str, default=None, metavar="RUN_DIR")
    p.add_argument("--verify_compatibility", action="store_true")
    p.add_argument("--background", action="store_true")
    return p


def detect_data_source(args):
    """--data_source full, else the cache when a metadata file for the split
    exists (in --cache_dir, or a default cache name), else raw."""
    from music_transcription_tpu_torch.data.cache import metadata_path

    if args.data_source == "full":
        return "raw", args.root_dir
    if args.cache_dir and os.path.exists(metadata_path(args.cache_dir, args.split)):
        return "cache", args.cache_dir
    for cand in ("cached_dataset_mels320", "cached_dataset"):
        if args.cache_dir is None and os.path.exists(metadata_path(cand, args.split)):
            return "cache", cand
    if args.data_source == "cache":
        raise SystemExit(f"Error: --data_source cache but no metadata found for split "
                         f"'{args.split}' in {args.cache_dir or 'cached_dataset[_mels320]'}")
    return "raw", args.root_dir


def _is_ast_checkpoint(model_path: str) -> bool:
    """Whether the checkpoint's sidecar names the AST model."""
    sidecar = os.path.splitext(model_path)[0] + ".json"
    try:
        with open(sidecar) as f:
            return json.load(f).get("model", {}).get("model_type") == "ast"
    except (OSError, ValueError, AttributeError):
        return False


def full_piece_eval(args, loaded, source_path) -> int:
    """Whole recordings through the inference path (chunks as one device
    batch, thresholded rolls concatenated or stitched), each scored against
    its full-length MIDI roll: per-piece framewise F1 (and onset F1), and F1
    over the +-``seam_frames`` band around chunk seams against the
    interior. The prediction runs at mel frames per chunk (938 per 30 s), the
    target at 31.25 fps (937.5 per 30 s): the half-frame drift per chunk is
    part of what this measures."""
    from music_transcription_tpu_torch import eval as E
    from music_transcription_tpu_torch.config import AudioConfig
    from music_transcription_tpu_torch.data.audio import split_into_chunks
    from music_transcription_tpu_torch.data.maestro import MaestroDataset
    from music_transcription_tpu_torch.transcribe import transcribe_chunks

    audio_cfg = loaded.audio_cfg
    ds = MaestroDataset(source_path, split=args.split, chunk_length=None, year=args.year,
                        return_waveform=True,
                        audio_cfg=AudioConfig(n_mels=loaded.model.config.n_mels,
                                              chunk_length=audio_cfg.chunk_length))
    n_eval = min(args.subset, len(ds)) if args.subset else len(ds)
    if n_eval == 0:
        print(f"Error: no pieces in split '{args.split}'")
        return 1
    t_chunk = audio_cfg.mel_frames_per_chunk
    w = max(1, args.seam_frames)
    hop_samples = hop_frames = None
    if args.overlap and args.overlap > 0.0:
        # as Transcriber(overlap=...): the hop snapped to the mel hop grid
        hop_samples = audio_cfg.chunk_samples - int(round(args.overlap * audio_cfg.sample_rate))
        hop_samples = max(audio_cfg.hop_length,
                          (hop_samples // audio_cfg.hop_length) * audio_cfg.hop_length)
        hop_frames = hop_samples // audio_cfg.hop_length
    f1s, onset_f1s = [], []
    seam = np.zeros(3, np.int64)  # tp, fp, fn on the frames near a seam
    interior = np.zeros(3, np.int64)
    for i in range(n_eval):
        wave, roll = ds[i]
        chunks = split_into_chunks(np.asarray(wave), audio_cfg.chunk_samples,
                                   hop_samples=hop_samples)
        pred = transcribe_chunks(loaded, chunks, threshold=args.threshold, hop_frames=hop_frames)
        t = min(pred.shape[1], roll.shape[1])
        p, g = pred[:, :t] > 0, np.asarray(roll)[:, :t] > 0
        f1s.append(E.f1_from_counts(int((p & g).sum()), int((p & ~g).sum()),
                                    int((~p & g).sum())))
        if args.onset_f1:
            _, _, of1 = E.note_onset_prf(p.astype(np.float32), g.astype(np.float32),
                                         fs=audio_cfg.frame_rate, tolerance_s=args.onset_tolerance)
            onset_f1s.append(of1)
        # the seam band: +-w frames around the frames where the output changes
        # source chunk: k * t_chunk when concatenated, k * hop + (t_chunk - hop) // 2
        # when stitched
        idx = np.arange(t)
        near = np.zeros(t, bool)
        for k in range(1, chunks.shape[0]):
            b = k * hop_frames + (t_chunk - hop_frames) // 2 if hop_frames is not None else k * t_chunk
            near |= np.abs(idx - b) < w
        for mask, acc in ((near, seam), (~near, interior)):
            pm, gm = p[:, mask], g[:, mask]
            acc += np.array([(pm & gm).sum(), (pm & ~gm).sum(), (~pm & gm).sum()], np.int64)
        if not args.headless:
            print(f"  piece {i + 1}/{n_eval}: {chunks.shape[0]} chunks, F1={f1s[-1]:.4f}")
    mean = float(np.mean(f1s))
    seam_f1 = E.f1_from_counts(*seam.tolist())
    interior_f1 = E.f1_from_counts(*interior.tolist())
    if args.headless:
        print(f"EVAL_MEAN_F1={mean:.6f}")
        print(f"EVAL_SEAM_F1={seam_f1:.6f}")
        print(f"EVAL_INTERIOR_F1={interior_f1:.6f}")
        if onset_f1s:
            print(f"EVAL_ONSET_F1={float(np.mean(onset_f1s)):.6f}")
        return 0
    print(f"Raw full-piece mean F1: {mean:.6f} over {n_eval} pieces (threshold {args.threshold})")
    print(f"Seam-band F1 (±{w} frames around chunk boundaries): {seam_f1:.6f}")
    print(f"Interior F1: {interior_f1:.6f}")
    if onset_f1s:
        print(f"Onset F1 (±{args.onset_tolerance * 1000:.0f} ms): {float(np.mean(onset_f1s)):.6f}")
    run_dir = os.path.join(args.out_dir, datetime.now().strftime("%Y-%m-%d_%H-%M-%S"))
    os.makedirs(run_dir, exist_ok=True)
    extra = {"model": args.model, "split": args.split, "source": "raw full pieces",
             f"seam F1 (±{w} frames)": f"{seam_f1:.6f}", "interior F1": f"{interior_f1:.6f}"}
    if hop_frames is not None:
        extra["overlap"] = f"{args.overlap}s (hop {hop_frames} frames, stitched)"
    if onset_f1s:
        extra["mean onset F1"] = f"{float(np.mean(onset_f1s)):.6f}"
    E.write_summary(os.path.join(run_dir, "eval_summary.txt"), np.asarray(f1s), args.threshold,
                    extra=extra)
    print(f"Results written to {run_dir}")
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)

    if args.show_results:
        path = os.path.join(args.show_results, "eval_summary.txt")
        if not os.path.exists(path):
            print(f"Error: Summary file not found: {path}")
            return 1
        with open(path) as f:
            print(f.read())
        return 0

    if args.model is None:
        print("Error: --model is required")
        return 1

    if args.background:
        os.makedirs(args.out_dir, exist_ok=True)
        log_path = args.log_file or os.path.join(
            args.out_dir, f"eval_{datetime.now().strftime('%Y-%m-%d_%H-%M-%S')}.log")
        with open(log_path, "a") as log:
            proc = subprocess.Popen(
                [sys.executable, "-m", "music_transcription_tpu_torch.evaluate"]
                + [a for a in argv if a != "--background"],
                stdout=log, stderr=subprocess.STDOUT, start_new_session=True)
        print(f"Evaluation started in background (pid {proc.pid}); logs: {log_path}")
        return 0

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("Error: CUDA is not available: no GPU is visible to PyTorch. "
              "Pass -d cpu to evaluate on the CPU.")
        return 1

    from music_transcription_tpu_torch.parallel.distributed import (
        maybe_initialize_distributed,
        rank_device,
        shutdown,
    )

    # before the first device use: under torchrun, join the ranks' group
    multi = maybe_initialize_distributed(args.device, verbose=not args.headless)
    try:
        return _evaluate(args, multi, rank_device(args.device))
    finally:
        shutdown()  # a rank that returns holds no other rank in a collective


class _Ranks:
    """The host-array collectives of evaluation across ranks, over gloo: the
    default group, or one of its own when the ranks run NCCL."""

    def __init__(self):
        import torch.distributed as dist

        from music_transcription_tpu_torch.parallel.distributed import backend, rank_and_world

        self.dist = dist
        self.rank, self.size = rank_and_world()
        self.group = dist.new_group(backend="gloo") if backend() != "gloo" else None

    def all_gather(self, a):
        """(size, *a.shape) float64: every rank's ``a``, in rank order."""
        import torch

        t = torch.from_numpy(np.ascontiguousarray(a, np.float64))
        out = [torch.empty_like(t) for _ in range(self.size)]
        self.dist.all_gather(out, t, group=self.group)
        return torch.stack(out).numpy()

    def global_per_sample(self, local, n_eval: int):
        """Per-sample scores of the exact round-robin shards back in global
        order (shard item i on rank p is global item i * size + p)."""
        m = -(-n_eval // self.size)
        padded = np.full(m, np.nan)
        padded[:len(local)] = local
        return self.all_gather(padded).T.reshape(-1)[:n_eval]

    def grid_fn(self, E):
        """``tune_threshold``'s grid: every rank's F1 sums and counts summed."""
        def grid(cached, thresholds):
            sums, count = E.grid_f1_sums(cached, thresholds)
            g = self.all_gather(np.concatenate([sums, [float(count)]]))
            return g[:, :-1].sum(axis=0) / max(1.0, float(g[:, -1].sum()))

        return grid


def _evaluate(args, multi: bool, device) -> int:
    from music_transcription_tpu_torch import eval as E
    from music_transcription_tpu_torch.config import (
        AudioConfig,
        CompatibilityError,
        ModelConfig,
        validate_compatibility,
    )
    from music_transcription_tpu_torch.data.cache import CachedMaestroDataset, load_metadata
    from music_transcription_tpu_torch.data.maestro import MaestroDataset
    from music_transcription_tpu_torch.data.pipeline import Loader
    from music_transcription_tpu_torch.parallel.distributed import ProcessShard
    from music_transcription_tpu_torch.transcribe import LoadedModel, load_model

    ranks = _Ranks() if multi else None
    is_main = ranks is None or ranks.rank == 0
    source, source_path = detect_data_source(args)

    # model config: the sidecar, else the CLI's overrides, else the defaults
    overrides = {k: getattr(args, k) for k in ("model_type", "n_mels", "hidden_size",
                                               "num_layers", "dropout")
                 if getattr(args, k) is not None}
    model_cfg = ModelConfig(**overrides) if overrides else None
    # the sidecar is read directly: CLI overrides would mask its model_type
    if _is_ast_checkpoint(args.model) or (model_cfg is not None and model_cfg.is_ast):
        print("Error: this is an AST (token-route) checkpoint; framewise evaluation "
              "needs frame logits: use python -m music_transcription_tpu_torch.evaluate_ast.")
        return 1
    try:
        loaded = load_model(args.model, model_cfg=model_cfg, device=device)
    except ValueError as exc:  # an orbax directory: the conversion hint
        print(f"Error: {exc}")
        return 1
    audio_cfg = loaded.audio_cfg
    n_mels = loaded.model.config.n_mels

    if args.window:
        # one forward over a longer window; "auto" attention takes the flash
        # kernel once the fp32 scores outgrow the threshold, as Transcriber does
        if source == "cache":
            print("Error: --window needs the raw data source (the cache stores "
                  "fixed-length chunks); pass --data_source full.")
            return 1
        audio_cfg = dataclasses.replace(audio_cfg, chunk_length=float(args.window))
        if loaded.model.config.attention_backend != "pallas":
            loaded.model.set_attention_backend("auto")
        loaded = LoadedModel(model=loaded.model, audio_cfg=audio_cfg)

    if args.full_pieces:
        if source == "cache":
            print("Error: --full_pieces needs the raw data source (whole recordings); "
                  "pass --data_source full.")
            return 1
        return full_piece_eval(args, loaded, source_path) if is_main else 0

    def make_dataset(split):
        if source == "cache":
            return CachedMaestroDataset(source_path, split, verbose=not args.headless)
        return MaestroDataset(source_path, split=split, chunk_length=audio_cfg.chunk_length,
                              year=args.year,
                              audio_cfg=AudioConfig(n_mels=n_mels,
                                                    chunk_length=audio_cfg.chunk_length))

    if source == "cache":
        try:
            for w in validate_compatibility(model_n_mels=n_mels,
                                            cache_meta=load_metadata(source_path, args.split),
                                            audio=audio_cfg):
                print(f"Warning: {w}")
        except CompatibilityError as exc:
            print(f"Error: {exc}")
            return 1
        if args.verify_compatibility:
            print("Compatibility check passed.")
            return 0
    elif args.verify_compatibility:
        print("Raw data source; nothing to verify beyond file presence.")
        return 0
    dataset = make_dataset(args.split)

    n_total = len(dataset)
    n_eval = min(args.subset, n_total) if args.subset else n_total

    if args.dry_run:
        print("=" * 70)
        print("MODEL EVALUATION - DRY RUN")
        print("=" * 70)
        print(f"Checkpoint:  {args.model}")
        print(f"Model type:  {loaded.model.config.model_type}")
        print(f"n_mels:      {n_mels}")
        print(f"Split:       {args.split}")
        print(f"Data source: {source} ({source_path})")
        print(f"Samples:     {n_eval}{f' (of {n_total})' if n_eval != n_total else ''}")
        print(f"Threshold:   {args.threshold}")
        print(f"Device:      {args.device}")
        if args.tune_threshold:
            print(f"Tuning:      rounds={args.tune_rounds} range={args.tune_range} "
                  f"step={args.tune_step} min_step={args.tune_min_step} "
                  f"tune_split={args.tune_split}")
        print("This is a DRY RUN - no evaluation will be performed.")
        return 0

    if args.subset:
        dataset = _Subset(dataset, n_eval)
    verbose = not args.headless and is_main

    def predict(ds):
        if multi:  # this rank's exact share: no sample twice
            ds = ProcessShard(ds, exact=True)
        loader = Loader(ds, args.batch_size, num_workers=4, pad_to=audio_cfg.mel_frames_per_chunk)
        return E.predict_probs(loaded.model, loader, verbose=verbose,
                               pad_batch_to=args.batch_size)

    cached = predict(dataset)

    if args.tune_threshold:
        # tuned on a split disjoint from the reported one by default; the
        # tuned threshold is frozen, then the eval split is scored at it
        if args.tune_split == args.split:
            if is_main:
                print(f"Warning: --tune_split equals --split ('{args.split}'): the threshold "
                      f"is tuned on the split it is reported on (the reported F1 is "
                      f"optimistically biased).")
            cached_tune = cached
        else:
            try:
                tune_ds = make_dataset(args.tune_split)
            except Exception as exc:
                print(f"Error: cannot load --tune_split '{args.tune_split}' from {source} "
                      f"source {source_path}: {exc}\nPass --tune_split {args.split} to tune on "
                      f"the eval split (which leaks the eval set into the threshold).")
                return 1
            if len(tune_ds) == 0:
                print(f"Error: --tune_split '{args.tune_split}' is empty in {source} source "
                      f"{source_path}.")
                return 1
            cached_tune = predict(tune_ds)
        best_t, best_f1 = E.tune_threshold(
            cached_tune, rounds=args.tune_rounds, tune_range=tuple(args.tune_range),
            step=args.tune_step, min_step=args.tune_min_step, verbose=verbose,
            grid_fn=None if ranks is None else ranks.grid_fn(E))
        if is_main and args.headless:
            print(f"EVAL_BEST_THRESHOLD={best_t:.6f}")
        elif is_main:
            print(f"Best threshold: {best_t:.6f} (tuned on '{args.tune_split}', "
                  f"tune-split mean F1 {best_f1:.6f})")
        args.threshold = best_t

    f1_scores = E.per_sample_f1(cached, args.threshold)
    if ranks is not None:
        f1_scores = ranks.global_per_sample(f1_scores, n_eval)
    mean = float(f1_scores.mean()) if f1_scores.size else 0.0
    onset_scores = None
    if args.onset_f1:
        onset_scores = E.per_sample_onset_f1(cached, args.threshold, fs=audio_cfg.frame_rate,
                                             tolerance_s=args.onset_tolerance)
        if ranks is not None:
            onset_scores = ranks.global_per_sample(onset_scores, n_eval)

    if args.headless:
        if is_main:
            print(f"EVAL_MEAN_F1={mean:.6f}")
            if onset_scores is not None:
                print(f"EVAL_ONSET_F1={float(onset_scores.mean()):.6f}")
        return 0

    confusion = E.global_confusion(cached, args.threshold)
    if ranks is not None:
        # every rank joins the sum; rank 0 alone writes
        confusion = ranks.all_gather(confusion).sum(axis=0).astype(np.int64)
        if not is_main:
            return 0

    run_dir = os.path.join(args.out_dir, datetime.now().strftime("%Y-%m-%d_%H-%M-%S"))
    os.makedirs(run_dir, exist_ok=True)
    extra = {"model": args.model, "split": args.split, "source": source, "device": args.device}
    if ranks is not None:
        extra["ranks"] = ranks.size
    if args.tune_threshold:
        extra["threshold tuned on"] = args.tune_split
    if onset_scores is not None:
        extra[f"mean onset F1 (±{args.onset_tolerance * 1000:.0f} ms)"] = (
            f"{float(onset_scores.mean()):.6f}")
    E.write_summary(os.path.join(run_dir, "eval_summary.txt"), f1_scores, args.threshold,
                    extra=extra)
    E.plot_confusion(os.path.join(run_dir, "confusion_matrix.png"), confusion)
    if not args.no_midi:
        E.write_sample_midis(cached, args.threshold, os.path.join(run_dir, "midis"),
                             fs=audio_cfg.frame_rate, limit=args.midi_limit)
    print(f"Mean F1: {mean:.6f} over {len(f1_scores)} samples")
    print(f"Results written to {run_dir}")
    return 0


class _Subset:
    """The first ``n`` items of a dataset."""

    def __init__(self, ds, n: int):
        self.ds, self.n = ds, n

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i):
        return self.ds[i]


if __name__ == "__main__":
    sys.exit(main())
