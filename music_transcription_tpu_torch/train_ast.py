"""AST training CLI on a CUDA card: frame-supervised encoder pretraining,
the encoder transplant, and teacher-forced token training with scheduled
sampling, pitch-weighted cross-entropy and note-F1 model selection.

    python -m music_transcription_tpu_torch.train_ast --pretrain_frames \\
        --root_dir maestro-v3.0.0 --val_split validation --run_dir runs/pre
    python -m music_transcription_tpu_torch.train_ast --root_dir maestro-v3.0.0 \\
        --encoder_init runs/pre/model_best.pth --freeze_encoder \\
        --scheduled_sampling 0.5 --pitch_loss_weight 3 --val_split validation \\
        --val_note_f1_every 1 --best_metric note_f1 --run_dir runs/ast [-d cuda|cpu]

Port of the JAX package's ``scripts/train_ast.py``: its flags, aliases and
defaults, its checks and their messages, its batch order and its
``training_log.txt`` lines. The steps are in ``train/ast_step.py``. Where it
differs:

  * ``--device`` (``-d``) takes ``cuda`` (the default; the run exits 1 when
    no card is visible) or ``cpu``;
  * the run writes ``model_final.pth`` and ``model_best.pth`` into
    ``--run_dir``, each with an ``X.json`` sidecar: ``{"model", "audio"}``
    for the token model, which ``transcribe.load_model``, the serving CLI and
    ``evaluate_ast`` read as they are, and ``{"pretrain_encoder", "audio"}``
    for a pretraining run. ``--encoder_init`` and ``--resume`` read such a
    ``.pth``;
  * the optimizer is ``torch.optim.Adam`` as ``optax.adam`` (no weight decay,
    no clipping); dropout masks come from a per-step ``torch.Generator``
    seeded from (seed + 1, step), the scheduled-sampling mask from one of
    its own;
  * with ``--device_data`` staging, the token ids are range-checked once, on
    the host, when they are staged (the streamed ones batch by batch).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
from datetime import datetime

# the JAX package's rule for staging the whole split on the device (bytes)
from music_transcription_tpu_torch.train.__main__ import STAGE_LIMIT_BYTES


def build_parser() -> argparse.ArgumentParser:
    # every flag also takes the reference's dash spelling (--subset-size)
    p = argparse.ArgumentParser(description="Train the AST token-generation model (PyTorch/CUDA)")
    p.add_argument("--root_dir", "--root-dir", type=str, default="maestro-v3.0.0")
    p.add_argument("--cache_dir", "--cached_dir", "--cached-dir", type=str,
                   default=None, help="tokenized or waveform cache (optional)")
    p.add_argument("--split", type=str, default="train")
    p.add_argument("--year", type=str, default=None)
    p.add_argument("--subset_size", "--subset-size", type=str, default="all",
                   help="'all' or an integer (0 == all)")
    p.add_argument("--epochs", "--num_epochs", "--num-epochs", type=int, default=5)
    p.add_argument("--batch_size", "--batch-size", type=int, default=4)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--model_type", "--model-type", type=str, default="ast", choices=["ast"])
    p.add_argument("--chunk_length", "--chunk-length", type=float, default=10.0)
    p.add_argument("--chunk_overlap", "--chunk-overlap", type=float, default=0.0)
    p.add_argument("--max_token_len", "--max-token-len", type=int, default=256)
    p.add_argument("--decoder_layers", "--decoder-layers", type=int, default=4)
    p.add_argument("--decoder_dim", "--decoder-dim", type=int, default=384)
    p.add_argument("--decoder_heads", "--decoder-heads", type=int, default=6)
    p.add_argument("--remi_vocab_size", "--remi-vocab-size", type=int, default=512)
    p.add_argument("--tokenizer", type=str, default="remi", choices=["remi", "event"],
                   help="remi = pianoroll walk (models/remi_tokenizer.py); event = "
                        "NOTE_ON/OFF/TIME_SHIFT from note events (models/event_tokenizer.py)")
    p.add_argument("--dropout", type=float, default=0.2)
    # mel-patch encoder geometry: the same for the AST model and the pretrainer
    p.add_argument("--encoder_layers", "--encoder-layers", type=int, default=4)
    p.add_argument("--encoder_dim", "--encoder-dim", type=int, default=384)
    p.add_argument("--encoder_heads", "--encoder-heads", type=int, default=6)
    p.add_argument("--patch_frames", "--patch-frames", type=int, default=4)
    p.add_argument("--encoder_n_mels", "--encoder-n-mels", type=int, default=128)
    # the recipe: 1. --pretrain_frames; 2. --encoder_init RUN/model_best.pth --freeze_encoder
    p.add_argument("--pretrain_frames", "--pretrain-frames",
                   action=argparse.BooleanOptionalAction, default=False,
                   help="pretrain only the mel-patch encoder with a framewise 88-key head "
                        "(masked BCE against piano rolls) instead of training the token model")
    p.add_argument("--encoder_init", "--encoder-init", type=str, default=None,
                   help="model_best.pth / model_final.pth of a --pretrain_frames run; its "
                        "encoder is transplanted into the AST model (with --freeze_encoder: "
                        "the frozen-pretrained-encoder pattern)")
    p.add_argument("--mock_encoder", "--use_mock_encoder", "--use-mock-encoder",
                   action=argparse.BooleanOptionalAction, default=False)
    p.add_argument("--freeze_encoder", "--freeze-encoder",
                   action=argparse.BooleanOptionalAction, default=False)
    p.add_argument("--val_split", "--val-split", type=str, default=None,
                   help="track per-epoch CE on this split (e.g. 'validation') and keep the "
                        "best state for model_best")
    p.add_argument("--val_batches", "--val-batches", type=int, default=16,
                   help="cap on validation batches per epoch")
    p.add_argument("--val_note_f1_every", "--val-note-f1-every", type=int, default=0,
                   help="every N epochs, generate on the first --val_note_f1_batches "
                        "validation batches and log note-level micro F1 (0 = off; needs "
                        "--val_split)")
    p.add_argument("--val_note_f1_batches", "--val-note-f1-batches", type=int, default=2,
                   help="validation batches to generate on per note-F1 pass (each is "
                        "--max_token_len sequential decode steps)")
    p.add_argument("--best_metric", "--best-metric", type=str, default="ce",
                   choices=["ce", "note_f1"],
                   help="what selects model_best and drives early stopping: 'ce' = "
                        "validation token cross-entropy (every epoch), 'note_f1' = generated "
                        "note-level F1 (on --val_note_f1_every epochs; requires it)")
    p.add_argument("--early_stop_patience", "--early-stop-patience", type=int, default=0,
                   help="stop when the validation score has not improved for N epochs "
                        "(0 = run all --epochs); needs --val_split")
    p.add_argument("--save_best_every", "--save-best-every", type=int, default=0,
                   help="write the retained best state to model_best every N epochs, not "
                        "only at exit, so a killed run loses at most N epochs")
    p.add_argument("--device_data", "--device-data", type=str, default="auto",
                   choices=["auto", "on", "off"],
                   help="stage the whole split on the device once and gather batches "
                        "there. auto = on a card when the data stays under "
                        f"{STAGE_LIMIT_BYTES / 1e9:.0f} GB")
    p.add_argument("--stall_timeout", "--stall-timeout", type=float, default=0.0,
                   help="exit 66 when no train/val step completes for this many seconds, "
                        "so a supervisor can resume from the last --save_best_every flush "
                        "(0 = off)")
    p.add_argument("--compact_data", "--compact-data",
                   action=argparse.BooleanOptionalAction, default=False,
                   help="stage waveforms as int16 at PCM16 scale (half the device bytes), "
                        "widened after the gather: exact for audio decoded from 16-bit PCM")
    p.add_argument("--scheduled_sampling", "--scheduled-sampling", type=float, default=0.0,
                   help="with probability p, decoder input positions are replaced by the "
                        "model's own teacher-forced argmax (a two-pass step; the first pass "
                        "takes no gradient). p ramps linearly from 0 to this value over "
                        "--ss_ramp_epochs")
    p.add_argument("--ss_ramp_epochs", "--ss-ramp-epochs", type=int, default=10,
                   help="epochs to ramp --scheduled_sampling from 0 to its final value")
    p.add_argument("--pitch_loss_weight", "--pitch-loss-weight", type=float, default=1.0,
                   help="cross-entropy weight on NOTE_ON/NOTE_OFF target tokens (torch "
                        "CrossEntropyLoss(weight=...) semantics; 1.0 = off). Validation CE "
                        "stays unweighted")
    p.add_argument("--sanity_checks", "--run_sanity_checks", "--run-sanity-checks",
                   action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--sanity_max_len", "--sanity-max-len", type=int, default=256,
                   help="token budget used by the sanity round-trip check")
    p.add_argument("--device", "-d", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="device to train on (default: cuda; fails when no GPU is visible)")
    p.add_argument("--run_dir", "--run-dir", type=str, default=None)
    p.add_argument("--resume", type=str, default=None,
                   help=".pth to resume the weights from (the optimizer starts cold)")
    p.add_argument("--seed", type=int, default=0)
    return p


def run_sanity_checks(dataset, tokenizer, max_token_len: int) -> None:
    """A dataset sample and the tokenizer's round trip on its roll."""
    import numpy as np

    print("Running sanity checks...")
    wave, roll = dataset[0]
    print(f"  sample 0: waveform {wave.shape} ({wave.shape[-1] / 16000:.1f}s), roll {roll.shape}")
    seq = tokenizer.encode_from_pianoroll(roll, max_len=max_token_len)
    decoded = tokenizer.decode_to_pianoroll(seq, max_t=roll.shape[-1])
    t = decoded.shape[1]
    agree = float((decoded == np.asarray(roll)[:, :t]).mean()) if t else 1.0
    print(f"  tokenizer round-trip: {len(seq)} tokens, {agree:.1%} frame agreement")
    if agree < 0.95:
        print("  ⚠ round-trip agreement below 95% (roll longer than token budget?)")
    print("Sanity checks passed.")


class TokenizingView:
    """(waveform, roll) items as (waveform, tokens), tokenized on the fly;
    a pretokenized dataset's items pass as they are."""

    def __init__(self, ds, tokenizer, max_len: int, tokenized: bool):
        self.ds, self.tokenizer, self.max_len, self.tokenized = ds, tokenizer, max_len, tokenized

    def __len__(self) -> int:
        return len(self.ds)

    def __getitem__(self, i):
        import numpy as np

        wave, second = self.ds[i]
        if self.tokenized:
            return wave, second
        return wave, np.asarray(self.tokenizer.encode_from_pianoroll(second, max_len=self.max_len),
                                np.int64)


def range_checked_collate(vocab_size: int):
    """``collate_tokens`` that raises on a token id outside [0, vocab_size):
    on the host, per streamed batch, or once over the staged split."""
    from music_transcription_tpu_torch.data.pipeline import collate_tokens

    def collate(items, pad_to=None):
        wave, tokens = collate_tokens(items, pad_to=pad_to)
        if tokens.size and (tokens.min() < 0 or tokens.max() >= vocab_size):
            raise ValueError(f"Token id out of range: min={tokens.min()}, max={tokens.max()}, "
                             f"vocab={vocab_size}")
        return wave, tokens

    return collate


def _staged(args, device, n_items: int, item_bytes: float) -> bool:
    return args.device_data == "on" or (args.device_data == "auto" and device.type != "cpu"
                                        and n_items * item_bytes < STAGE_LIMIT_BYTES)


def _loader(dataset, args, device, *, staged: bool, shuffle: bool, collate, pad_to: int,
            num_workers: int, limit: int | None = None):
    """The streaming Loader, or the DeviceStagedLoader (its first ``limit``
    items, waves int16 with --compact_data): the same batches in the same
    order, drop_last."""
    from music_transcription_tpu_torch.data.pipeline import DeviceStagedLoader, Loader

    kw = dict(shuffle=shuffle, seed=args.seed, num_workers=num_workers, drop_last=True,
              collate=collate, pad_to=pad_to)
    if not staged:
        return Loader(dataset, args.batch_size, **kw)
    return DeviceStagedLoader(dataset, args.batch_size, device=device, limit=limit,
                              compact_fields=(0,) if args.compact_data else (), verbose=True,
                              **kw)


class _RunOps:
    """What both loops share: the stall watchdog, the --save_best_every
    cadence of model_best and the exit flush. The best state is tracked
    lower-is-better; a higher-is-better metric (note F1) is tracked negated
    and shown with ``sign`` -1."""

    def __init__(self, args, save, metric_name: str = "val_loss", sign: float = 1.0):
        self.watchdog = None
        if args.stall_timeout:
            from music_transcription_tpu_torch.train.watchdog import StallWatchdog

            self.watchdog = StallWatchdog(args.stall_timeout)
        self.every = args.save_best_every
        self.save = save
        self.metric_name, self.sign = metric_name, sign
        self.flushed_val = float("inf")
        self.last_flush_epoch = -(10**9)

    def beat(self) -> None:
        if self.watchdog is not None:
            self.watchdog.beat()

    def on_best(self, best_state, best_val: float, epoch: int) -> None:
        """On an improvement: write model_best at most every N epochs."""
        if self.every and epoch - self.last_flush_epoch >= self.every:
            self.save("model_best", best_state)
            self.flushed_val, self.last_flush_epoch = best_val, epoch

    def finish(self, state, best_state, best_val: float, best_epoch: int) -> None:
        """The loops' ``finally``: on a clean end or an abort (Ctrl-C,
        SIGTERM) write model_final and the best state not yet written."""
        if self.watchdog is not None:  # disarmed first: the writes must not trip it
            self.watchdog.stop()
        self.save("model_final", state)
        if best_state is not None:
            print(f"Best {self.metric_name} {self.sign * best_val:.4f} at epoch {best_epoch}")
            if best_val < self.flushed_val:  # the cadence may hold it already
                self.save("model_best", best_state)


def _snapshot(module) -> dict:
    """A copy of ``module``'s state on its device: the parameters change in
    place at the next step."""
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def _saver(run_dir: str, sidecar: dict):
    import torch

    from music_transcription_tpu_torch.checkpoints import write_sidecar

    def save(name: str, state: dict) -> None:
        path = os.path.join(run_dir, f"{name}.pth")
        torch.save({k: v.cpu() for k, v in state.items()}, path)
        write_sidecar(path, sidecar)
        print(f"Saved {path}")

    return save


def pretrain_main(args, subset, device) -> int:
    """--pretrain_frames: the mel-patch encoder trained with a framewise
    88-key head (``ASTEncoderPretrainer``, fp32) against piano rolls."""
    from functools import partial

    import torch

    from music_transcription_tpu_torch.checkpoints import load_torch_checkpoint
    from music_transcription_tpu_torch.config import AudioConfig, config_to_dict
    from music_transcription_tpu_torch.data.cache import CachedMaestroDataset, metadata_path
    from music_transcription_tpu_torch.data.maestro import MaestroDataset
    from music_transcription_tpu_torch.data.pipeline import collate_wave_roll
    from music_transcription_tpu_torch.models.transformer import ASTEncoderPretrainer
    from music_transcription_tpu_torch.train.ast_step import (
        make_adam,
        pretrain_eval,
        pretrain_step,
        step_generators,
    )
    from music_transcription_tpu_torch.train.loop import to_device

    audio_cfg = AudioConfig(chunk_length=args.chunk_length)

    def make_ds(split, sub=None):
        if args.cache_dir and os.path.exists(metadata_path(args.cache_dir, split)):
            ds = CachedMaestroDataset(args.cache_dir, split, subset_size=sub, prefer_roll=True)
            meta = ds.metadata
            if not meta.get("return_waveform"):
                raise SystemExit(
                    f"Error: cache {args.cache_dir} (split '{split}') has no waveforms; "
                    f"encoder pretraining needs a --waveform or --tokenize cache.")
            if meta.get("chunk_length") not in (None, args.chunk_length):
                raise SystemExit(f"Error: cache chunk_length={meta.get('chunk_length')}s != "
                                 f"--chunk_length {args.chunk_length}.")
            return ds
        return MaestroDataset(
            args.root_dir, split=split, year=None if args.year in (None, "all") else args.year,
            chunk_length=args.chunk_length, overlap=args.chunk_overlap, subset_size=sub,
            return_waveform=True, audio_cfg=audio_cfg)

    dataset = make_ds(args.split, subset)
    print(f"Pretrain set: {len(dataset)} chunks (frame-supervised)")
    collate = partial(collate_wave_roll, roll_pad_to=audio_cfg.roll_frames_per_chunk)
    wave_bytes = 2 if args.compact_data else 4
    staged = _staged(args, device, len(dataset),
                     wave_bytes * audio_cfg.chunk_samples
                     + 4 * 88 * audio_cfg.roll_frames_per_chunk)
    pad = audio_cfg.chunk_samples

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        model = ASTEncoderPretrainer(
            encoder_layers=args.encoder_layers, encoder_dim=args.encoder_dim,
            encoder_heads=args.encoder_heads, patch_frames=args.patch_frames,
            n_mels=args.encoder_n_mels, dropout=args.dropout)
    if args.resume:
        load_torch_checkpoint(args.resume, model)
        print(f"Resumed params from {args.resume}")
    model.to(device)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"Encoder pretrainer: {n_params / 1e6:.1f}M params "
          f"({args.encoder_layers}L x {args.encoder_dim}d, "
          f"patch_frames={args.patch_frames}, n_mels={args.encoder_n_mels})")
    optimizer = make_adam(model.parameters(), args.lr)

    loader = _loader(dataset, args, device, staged=staged, shuffle=True, collate=collate,
                     pad_to=pad, num_workers=4)
    if staged:
        # the JAX loop counts the staged epochs from 1 (the streaming Loader's from 0)
        loader.epoch = 1
        print(f"Device-staged training data: {loader.n} chunks")
    val_loader = None
    if args.val_split:
        val_ds = make_ds(args.val_split)
        if len(val_ds) < args.batch_size:
            raise SystemExit(f"Error: --val_split '{args.val_split}' has {len(val_ds)} "
                             f"chunks < batch_size {args.batch_size}.")
        # staged: only the first val_batches * batch_size chunks are ever scored
        val_loader = _loader(val_ds, args, device, staged=staged, shuffle=False,
                             collate=collate, pad_to=pad, num_workers=2,
                             limit=args.val_batches * args.batch_size)
        print(f"Validation set: {len(val_ds)} chunks (up to {args.val_batches} batches/epoch)")

    run_dir = args.run_dir or os.path.join(
        "outputs", "ast_pretrain_" + datetime.now().strftime("%Y-%m-%d_%H-%M-%S"))
    os.makedirs(run_dir, exist_ok=True)
    log_path = os.path.join(run_dir, "training_log.txt")
    sidecar = {
        "pretrain_encoder": {
            "encoder_layers": args.encoder_layers,
            "encoder_dim": args.encoder_dim,
            "encoder_heads": args.encoder_heads,
            "patch_frames": args.patch_frames,
            "encoder_n_mels": args.encoder_n_mels,
        },
        "audio": config_to_dict(audio_cfg),
    }
    ops = _RunOps(args, _saver(run_dir, sidecar))
    best_val, best_state, best_epoch = float("inf"), None, 0
    step = 0
    try:
        for epoch in range(1, args.epochs + 1):
            total, n = 0.0, 0
            for batch in loader:
                wave, roll, lengths = to_device(batch, device)
                gen, _ = step_generators(args.seed + 1, step, device)
                loss = pretrain_step(model, optimizer, wave, roll, lengths, generator=gen)
                step += 1
                total += float(loss)
                ops.beat()
                n += 1
            line = f"Epoch {epoch}/{args.epochs}: train_loss={total / max(1, n):.4f}"
            if val_loader is not None:
                vtotal, vn = 0.0, 0
                tp = fp = fn = 0
                # closed here, not by its finalizer, where an interrupt is dropped
                with contextlib.closing(iter(val_loader)) as val_batches:
                    for batch in val_batches:
                        vloss, btp, bfp, bfn = pretrain_eval(
                            model, *to_device(batch, device)).tolist()
                        vtotal += vloss
                        ops.beat()
                        tp, fp, fn = tp + int(btp), fp + int(bfp), fn + int(bfn)
                        vn += 1
                        if vn >= args.val_batches:
                            break
                vloss = vtotal / max(1, vn)
                f1 = 2 * tp / max(1, 2 * tp + fp + fn)
                line += f" val_loss={vloss:.4f} val_frame_f1={f1:.4f}"
                if vloss < best_val:
                    best_val, best_state, best_epoch = vloss, _snapshot(model), epoch
                    ops.on_best(best_state, best_val, epoch)
            print(line, flush=True)
            with open(log_path, "a") as f:
                f.write(line + "\n")
            if (args.early_stop_patience and val_loader is not None
                    and epoch - best_epoch >= args.early_stop_patience):
                print(f"Early stop: no val improvement since epoch {best_epoch} "
                      f"(patience {args.early_stop_patience})")
                break
    finally:
        ops.finish(model.state_dict(), best_state, best_val, best_epoch)
    return 0


def transplant_encoder(module, ckpt_path: str, model_cfg) -> None:
    """Copy the encoder of a --pretrain_frames checkpoint (``.pth`` + its
    ``.json`` sidecar) into the ``ASTTranscriber`` ``module``: the sidecar's
    geometry must match ``model_cfg``, and every encoder subtree must be in
    the checkpoint with the model's keys and shapes."""
    import json

    import torch

    from music_transcription_tpu_torch.models.transformer import (
        encoder_state_dict,
        encoder_subtree,
    )

    sidecar_path = os.path.splitext(ckpt_path)[0] + ".json"
    if os.path.isfile(sidecar_path):
        with open(sidecar_path) as f:
            pre = json.load(f).get("pretrain_encoder")
        if pre:
            for k, want in (
                ("encoder_layers", model_cfg.encoder_layers),
                ("encoder_dim", model_cfg.encoder_dim),
                ("encoder_heads", model_cfg.encoder_heads),
                ("patch_frames", model_cfg.patch_frames),
                ("encoder_n_mels", model_cfg.encoder_n_mels),
            ):
                if pre.get(k, want) != want:
                    raise SystemExit(
                        f"Error: --encoder_init geometry mismatch: checkpoint {k}={pre.get(k)} "
                        f"vs model {k}={want}. Pass matching --{k} flags.")

    def by_subtree(state: dict) -> dict:
        out: dict = {}
        for key, v in encoder_state_dict(state).items():
            out.setdefault(encoder_subtree(key), {})[key] = v
        return out

    target = by_subtree(module.state_dict())
    if not target:
        raise SystemExit("Error: --encoder_init with --mock_encoder: the mock encoder has no "
                         "parameters to initialize.")
    src = by_subtree(torch.load(ckpt_path, map_location="cpu"))
    update = {}
    for k, sub in target.items():
        if k not in src:
            raise SystemExit(f"Error: --encoder_init checkpoint lacks encoder subtree '{k}' "
                             f"(is this a --pretrain_frames checkpoint?)")
        want_shapes = {name: tuple(v.shape) for name, v in sub.items()}
        got_shapes = {name: tuple(v.shape) for name, v in src[k].items()}
        if want_shapes != got_shapes:
            raise SystemExit(f"Error: --encoder_init subtree '{k}' shape mismatch: "
                             f"{got_shapes} vs model {want_shapes}")
        update.update(src[k])
    module.load_state_dict(update, strict=False)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.save_best_every and not args.val_split:
        raise SystemExit(
            "Error: --save_best_every needs --val_split — the cadence flushes the "
            "best-validation-CE params, and without validation tracking there is never a "
            "best state to flush (a wedged run would silently lose everything, the exact "
            "failure the flag exists to bound).")
    if args.val_note_f1_every and not args.val_split:
        raise SystemExit("Error: --val_note_f1_every needs --val_split — generation "
                         "validation runs on validation batches.")
    if args.best_metric == "note_f1" and not args.val_note_f1_every:
        raise SystemExit("Error: --best_metric note_f1 needs --val_note_f1_every N — the "
                         "metric only exists on epochs where generation validation runs.")
    if args.val_note_f1_every and args.pretrain_frames:
        raise SystemExit("Error: --val_note_f1_every is a token-route metric; the "
                         "--pretrain_frames loop already tracks val_frame_f1 every epoch.")
    subset = None if args.subset_size in ("all", "0") else int(args.subset_size)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("Error: CUDA is not available: no GPU is visible to PyTorch. "
              "Pass -d cpu to train on the CPU.")
        return 1
    device = torch.device(args.device)

    from music_transcription_tpu_torch.train.loop import install_graceful_sigterm

    install_graceful_sigterm()  # `kill <pid>` flushes model_best as Ctrl-C does
    if args.pretrain_frames:
        return pretrain_main(args, subset, device)
    return token_main(args, subset, device)


def token_main(args, subset, device) -> int:
    """The token model: teacher-forced training, validation CE, note-F1 by
    generation, model_best selection."""
    import numpy as np
    import torch

    from music_transcription_tpu_torch.checkpoints import load_torch_checkpoint
    from music_transcription_tpu_torch.config import AudioConfig, ModelConfig, config_to_dict
    from music_transcription_tpu_torch.data.cache import CachedMaestroDataset, metadata_path
    from music_transcription_tpu_torch.data.maestro import MaestroDataset
    from music_transcription_tpu_torch.data.pipeline import collate_tokens
    from music_transcription_tpu_torch.models.transcription import TranscriptionModel
    from music_transcription_tpu_torch.train.ast_step import (
        make_adam,
        pitch_class_weights,
        step_generators,
        token_eval_loss,
        token_step,
    )
    from music_transcription_tpu_torch.train.loop import to_device

    audio_cfg = AudioConfig(chunk_length=args.chunk_length)
    if args.tokenizer == "event":
        from music_transcription_tpu_torch.models.event_tokenizer import EventMIDITokenizer

        tokenizer = EventMIDITokenizer(vocab_size=args.remi_vocab_size,
                                       frame_rate=audio_cfg.frame_rate)
    else:
        from music_transcription_tpu_torch.models.remi_tokenizer import REMITokenizer

        tokenizer = REMITokenizer(vocab_size=args.remi_vocab_size)

    def check_cache_meta(meta, split) -> bool:
        """Waveforms, the requested chunking and a REMI vocabulary, for the
        train and the validation split alike; returns whether the split is
        pretokenized."""
        if not (meta.get("return_waveform") or meta.get("tokenize")):
            raise SystemExit(f"Error: cache {args.cache_dir} (split '{split}') holds mel "
                             f"features; the AST model needs a --waveform (or --tokenize) "
                             f"cache.")
        if meta.get("chunk_length") not in (None, args.chunk_length):
            raise SystemExit(f"Error: cache (split '{split}') chunk_length="
                             f"{meta.get('chunk_length')}s does not match --chunk_length "
                             f"{args.chunk_length}.")
        tokenized = meta.get("tokenize", False)
        if tokenized and args.tokenizer != "remi":
            raise SystemExit(f"Error: pre-tokenized caches are REMI-encoded (split '{split}'); "
                             f"use --tokenizer remi or a waveform cache.")
        return tokenized

    if args.cache_dir and os.path.exists(metadata_path(args.cache_dir, args.split)):
        dataset = CachedMaestroDataset(args.cache_dir, args.split, subset_size=subset)
        pretokenized = check_cache_meta(dataset.metadata, args.split)
    else:
        if args.cache_dir:
            print(f"Warning: no cache metadata at {args.cache_dir} for split '{args.split}'; "
                  f"falling back to the raw dataset at {args.root_dir}")
        dataset = MaestroDataset(
            args.root_dir, split=args.split,
            year=None if args.year in (None, "all") else args.year,
            chunk_length=args.chunk_length, overlap=args.chunk_overlap, subset_size=subset,
            return_waveform=True, audio_cfg=audio_cfg)
        pretokenized = False
    print(f"Train set: {len(dataset)} chunks (pretokenized={pretokenized})")
    if args.sanity_checks and not pretokenized:
        run_sanity_checks(dataset, tokenizer, args.sanity_max_len)

    wave_bytes = 2 if args.compact_data else 4
    staged = _staged(args, device, len(dataset),
                     wave_bytes * audio_cfg.chunk_samples + 8 * args.max_token_len)
    pad = audio_cfg.chunk_samples
    loader = _loader(TokenizingView(dataset, tokenizer, args.max_token_len, pretokenized), args,
                     device, staged=staged, shuffle=True,
                     collate=range_checked_collate(args.remi_vocab_size), pad_to=pad,
                     num_workers=4)

    model_cfg = ModelConfig(
        model_type="ast", dropout=args.dropout, remi_vocab_size=args.remi_vocab_size,
        decoder_layers=args.decoder_layers, decoder_dim=args.decoder_dim,
        decoder_heads=args.decoder_heads, encoder_layers=args.encoder_layers,
        encoder_dim=args.encoder_dim, encoder_heads=args.encoder_heads,
        patch_frames=args.patch_frames, encoder_n_mels=args.encoder_n_mels,
        use_mock_encoder=args.mock_encoder, freeze_encoder=args.freeze_encoder,
        tokenizer=args.tokenizer)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        model = TranscriptionModel(model_cfg)
    if args.encoder_init:
        transplant_encoder(model.model, args.encoder_init, model_cfg)
        print(f"Initialized encoder from {args.encoder_init}"
              + (" (frozen)" if args.freeze_encoder else ""))
    if args.resume:
        # the weights only: Adam starts cold
        load_torch_checkpoint(args.resume, model.model)
        print(f"Resumed params from {args.resume}")
    model.to(device)
    optimizer = make_adam(model.parameters(), args.lr)
    use_ss = args.scheduled_sampling > 0.0
    class_w = pitch_class_weights(tokenizer, args.remi_vocab_size, args.pitch_loss_weight)
    if class_w is not None:
        class_w = torch.from_numpy(class_w).to(device)

    val_loader = None
    if args.val_split:
        val_tokenized = False
        if args.cache_dir and os.path.exists(metadata_path(args.cache_dir, args.val_split)):
            val_ds = CachedMaestroDataset(args.cache_dir, args.val_split)
            val_tokenized = check_cache_meta(val_ds.metadata, args.val_split)
        else:
            val_ds = MaestroDataset(args.root_dir, split=args.val_split,
                                    chunk_length=args.chunk_length, overlap=0.0,
                                    return_waveform=True, audio_cfg=audio_cfg)
        if len(val_ds) < args.batch_size:
            # drop_last would give zero validation batches: a val_loss of 0.0
            # would become the best on epoch 1 and drive early stopping
            raise SystemExit(f"Error: --val_split '{args.val_split}' has {len(val_ds)} chunks "
                             f"< batch_size {args.batch_size}; validation would see zero "
                             f"batches. Shrink --batch_size or use more data.")
        val_loader = _loader(TokenizingView(val_ds, tokenizer, args.max_token_len,
                                            val_tokenized), args, device, staged=staged,
                             shuffle=False, collate=collate_tokens, pad_to=pad, num_workers=2,
                             limit=args.val_batches * args.batch_size)
        print(f"Validation set: {len(val_ds)} chunks (up to {args.val_batches} batches/epoch)")

    run_dir = args.run_dir or os.path.join(
        "outputs", "ast_" + datetime.now().strftime("%Y-%m-%d_%H-%M-%S"))
    os.makedirs(run_dir, exist_ok=True)
    log_path = os.path.join(run_dir, "training_log.txt")
    sidecar = {"model": config_to_dict(model_cfg), "audio": config_to_dict(audio_cfg)}
    by_f1 = args.best_metric == "note_f1"
    ops = _RunOps(args, _saver(run_dir, sidecar),
                  metric_name="val_note_f1" if by_f1 else "val_loss",
                  sign=-1.0 if by_f1 else 1.0)

    gen_val = None
    if args.val_note_f1_every:
        from music_transcription_tpu_torch.eval import decode_tokens_to_notes, note_f1, trim_tokens

        def gen_val() -> float:
            """Micro note F1 of greedy generation on the first
            --val_note_f1_batches validation batches, with evaluate_ast's
            default matching (onset 0.1 s, pitch 0.5)."""
            tot = {"tp": 0, "fp": 0, "fn": 0}
            bn = 0
            model.eval()
            for batch in val_loader:
                wave, tokens = to_device(batch, device)
                with torch.inference_mode():
                    gen = model(wave, generate_max_len=args.max_token_len).cpu().numpy()
                ops.beat()
                for g, t in zip(gen, tokens.cpu().numpy()):
                    notes = [decode_tokens_to_notes(
                        trim_tokens(seq.tolist(), eos_id=tokenizer.eos, pad_id=tokenizer.pad),
                        tokenizer, frame_rate=audio_cfg.frame_rate) for seq in (g, t)]
                    m = note_f1(notes[0], notes[1], onset_tol=0.1, pitch_tol=0.5)
                    for k in tot:
                        tot[k] += m[k]
                bn += 1
                if bn >= args.val_note_f1_batches:
                    break
            prec = tot["tp"] / (tot["tp"] + tot["fp"] + 1e-9)
            rec = tot["tp"] / (tot["tp"] + tot["fn"] + 1e-9)
            return 2 * prec * rec / (prec + rec + 1e-9)

    best_val, best_state, best_epoch = float("inf"), None, 0
    step = 0
    try:
        for epoch in range(1, args.epochs + 1):
            total, n = 0.0, 0
            # linear ramp 0 -> scheduled_sampling over ss_ramp_epochs
            ss_p = args.scheduled_sampling * min(1.0, epoch / max(1, args.ss_ramp_epochs))
            for batch in loader:
                wave, tokens = to_device(batch, device)
                gen, ss_gen = step_generators(args.seed + 1, step, device)
                loss = token_step(model, optimizer, wave, tokens, generator=gen,
                                  ss_p=ss_p if use_ss else None, ss_generator=ss_gen,
                                  class_weights=class_w)
                step += 1
                total += float(loss)  # the step's one host read
                ops.beat()
                n += 1
            line = f"Epoch {epoch}/{args.epochs}: train_loss={total / max(1, n):.4f}"
            if use_ss:
                line += f" ss_p={ss_p:.2f}"
            if val_loader is not None:
                vtotal, vn = 0.0, 0
                with contextlib.closing(iter(val_loader)) as val_batches:
                    for batch in val_batches:
                        vtotal += float(token_eval_loss(model, *to_device(batch, device)))
                        ops.beat()
                        vn += 1
                        if vn >= args.val_batches:
                            break
                vloss = vtotal / max(1, vn)
                line += f" val_loss={vloss:.4f}"
                score = vloss
                # with note-F1 selection the last epoch always scores it: a
                # cadence longer than the run must still give a best state
                force_f1 = by_f1 and epoch == args.epochs
                if gen_val is not None and (epoch % args.val_note_f1_every == 0 or force_f1):
                    nf1 = gen_val()
                    line += f" val_note_f1={nf1:.4f}"
                    if by_f1:
                        score = -nf1
                elif by_f1:
                    score = None  # the selection metric was not computed
                if score is not None and score < best_val:
                    best_val, best_state, best_epoch = score, _snapshot(model.model), epoch
                    ops.on_best(best_state, best_val, epoch)
            print(line)
            with open(log_path, "a") as f:
                f.write(line + "\n")
            if (args.early_stop_patience and val_loader is not None
                    and epoch - best_epoch >= args.early_stop_patience):
                print(f"Early stop: no val improvement since epoch {best_epoch} "
                      f"(patience {args.early_stop_patience})")
                break
    finally:
        ops.finish(model.model.state_dict(), best_state, best_val, best_epoch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
