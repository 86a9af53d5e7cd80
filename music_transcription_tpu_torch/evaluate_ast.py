"""AST (token-route) evaluation CLI: generate -> decode -> note-level F1, on
a CUDA card.

    python -m music_transcription_tpu_torch.evaluate_ast --model model.pth \\
        --root_dir maestro-v3.0.0 --split test --subset 8 --headless [-d cuda|cpu]

Port of the JAX package's ``scripts/evaluate_ast.py``, with its flags and
its ``EVAL_AST_*=`` lines. For each sample: generate tokens from the audio
(greedy, ``--beam``, ``--constrained``), trim at <eos> and drop <pad>,
decode generated and ground-truth tokens to notes, score by greedy onset
matching (|onset| <= ``--onset_tol``, |pitch| <= ``--pitch_tol``);
``--frame_f1`` adds the decoded rolls' frame F1, ``--out_dir`` writes MIDI
pairs, ``--teacher_forced`` scores next-token accuracy instead. Data come
from a waveform or tokenized cache (``--cache_dir``) or a raw MAESTRO tree
(``--root_dir``). The checkpoint is a ``.pth`` with its ``X.json`` sidecar,
as ``transcribe.load_model`` reads it. ``-d/--device`` takes ``cuda`` (the
default; the run exits 1 when no card is visible) or ``cpu``, where the JAX
script takes ``cpu|tpu``.
"""

from __future__ import annotations

import argparse
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Evaluate the AST token route")
    p.add_argument("--model", type=str, required=True,
                   help="checkpoint .pth (with its .json sidecar)")
    p.add_argument("--root_dir", "--root-dir", type=str, default="maestro-v3.0.0")
    p.add_argument("--cache_dir", "--cached_dir", "--cached-dir", type=str,
                   default=None, help="waveform/tokenized cache (optional)")
    p.add_argument("--split", type=str, default="test")
    p.add_argument("--year", type=str, default=None)
    p.add_argument("--subset", type=int, default=None,
                   help="evaluate only the first N samples")
    p.add_argument("--max_len", "--max-len", type=int, default=1024,
                   help="generation token budget")
    p.add_argument("--gen_batch_size", "--gen-batch-size", type=int, default=8,
                   help="samples generated per device batch")
    p.add_argument("--onset_tol", "--onset-tol", type=float, default=0.1,
                   help="onset tolerance in seconds")
    p.add_argument("--pitch_tol", "--pitch-tol", type=float, default=0.5,
                   help="pitch tolerance in semitones")
    p.add_argument("--tokenizer", type=str, default=None, choices=["remi", "event"],
                   help="remi = pianoroll walk (models/remi_tokenizer.py), "
                        "event = NOTE_ON/OFF/TIME_SHIFT (models/event_tokenizer.py); "
                        "defaults to the checkpoint's trained vocabulary (sidecar)")
    p.add_argument("--out_dir", "--out-dir", type=str, default=None,
                   help="write per-sample gen_<i>.mid / gt_<i>.mid here")
    p.add_argument("--midi_limit", type=int, default=8,
                   help="cap on per-sample MIDI pairs written")
    p.add_argument("--device", "-d", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="device to evaluate on (default: cuda; fails when no GPU is visible)")
    p.add_argument("--frame_f1", "--frame-f1", action="store_true",
                   help="also report frame-level P/R/F1 of the decoded rolls "
                        "vs the ground-truth rolls")
    p.add_argument("--teacher_forced", "--teacher-forced", action="store_true",
                   help="skip generation: measure teacher-forced next-token "
                        "accuracy (all tokens, and NOTE_ON pitch tokens only), "
                        "which separates 'the model cannot read pitch from "
                        "audio' from 'free-running generation drifts'")
    p.add_argument("--beam", type=int, default=1,
                   help="beam size for generation (default 1 = greedy). "
                        "Vectorized beam search with GNMT length "
                        "normalization; composes with --constrained")
    p.add_argument("--length_penalty", "--length-penalty", type=float,
                   default=0.6, help="beam length-normalization exponent")
    p.add_argument("--constrained", action="store_true",
                   help="grammar-constrained decoding: mask logits with the "
                        "tokenizer's transition_mask() so generation can only "
                        "emit sequences the encoder could produce")
    p.add_argument("--headless", action="store_true",
                   help="print a final EVAL_AST_NOTE_F1= line")
    return p


def _load_dataset(args, audio_cfg, tokenizer_name: str):
    """(dataset, pretokenized); ValueError for a cache that cannot serve."""
    from music_transcription_tpu_torch.data.cache import CachedMaestroDataset, metadata_path
    from music_transcription_tpu_torch.data.maestro import MaestroDataset

    if args.cache_dir and os.path.exists(metadata_path(args.cache_dir, args.split)):
        dataset = CachedMaestroDataset(args.cache_dir, args.split)
        meta = dataset.metadata
        if not (meta.get("return_waveform") or meta.get("tokenize")):
            raise ValueError(f"cache {args.cache_dir} holds mel features; AST evaluation "
                             f"needs a --waveform (or --tokenize) cache.")
        pretokenized = bool(meta.get("tokenize", False))
        if pretokenized and tokenizer_name != "remi":
            raise ValueError("pre-tokenized caches are REMI-encoded; rerun with "
                             "--tokenizer remi or point at a waveform cache.")
        return dataset, pretokenized
    if args.cache_dir:
        print(f"Warning: no cache metadata at {args.cache_dir} for split '{args.split}'; "
              f"falling back to the raw dataset at {args.root_dir}")
    dataset = MaestroDataset(
        args.root_dir, split=args.split,
        year=None if args.year in (None, "all") else args.year,
        chunk_length=audio_cfg.chunk_length, return_waveform=True, audio_cfg=audio_cfg)
    return dataset, False


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.teacher_forced and (args.constrained or args.beam > 1):
        parser.error("--teacher_forced scores the forward pass only; "
                     "--constrained/--beam shape generation and would be "
                     "silently ignored — drop one side")

    import numpy as np
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("Error: CUDA is not available: no GPU is visible to PyTorch. "
              "Pass -d cpu to evaluate on the CPU.")
        return 1

    from music_transcription_tpu_torch.data.midi import Note, notes_to_midi, save_midi
    from music_transcription_tpu_torch.eval import decode_tokens_to_notes, note_f1, trim_tokens
    from music_transcription_tpu_torch.models.event_tokenizer import EventMIDITokenizer
    from music_transcription_tpu_torch.models.remi_tokenizer import REMITokenizer
    from music_transcription_tpu_torch.transcribe import load_model

    sidecar = os.path.splitext(args.model)[0] + ".json"
    if not os.path.isdir(args.model) and not os.path.exists(sidecar):
        print(f"Error: no config sidecar {sidecar} beside {args.model}")
        return 1
    try:
        loaded = load_model(args.model, device=args.device)
    except ValueError as exc:  # an orbax directory: the conversion hint
        print(f"Error: {exc}")
        return 1
    model, model_cfg, audio_cfg = loaded.model, loaded.model.config, loaded.audio_cfg
    if not model_cfg.is_ast:
        print(f"Error: {args.model} is not an AST checkpoint "
              f"(model_type={model_cfg.model_type}); use "
              f"python -m music_transcription_tpu_torch.evaluate.")
        return 1
    device = next(model.parameters()).device

    if args.tokenizer is None:
        args.tokenizer = model_cfg.tokenizer
        print(f"Tokenizer: {args.tokenizer} (from checkpoint config)")
    elif args.tokenizer != model_cfg.tokenizer:
        print(f"Warning: --tokenizer {args.tokenizer} differs from the checkpoint's trained "
              f"vocabulary ({model_cfg.tokenizer}); decoded notes will be garbage unless "
              f"you know better.")
    fr = audio_cfg.frame_rate
    if args.tokenizer == "event":
        tokenizer = EventMIDITokenizer(vocab_size=model_cfg.remi_vocab_size, frame_rate=fr)
    else:
        tokenizer = REMITokenizer(vocab_size=model_cfg.remi_vocab_size)

    try:
        dataset, pretokenized = _load_dataset(args, audio_cfg, args.tokenizer)
    except ValueError as exc:
        print(f"Error: {exc}")
        return 1
    n = len(dataset)
    if args.subset:
        n = min(n, args.subset)
    print(f"Evaluating {n} samples (tokenizer={args.tokenizer}, "
          f"max_len={args.max_len}, onset_tol={args.onset_tol}s)")
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)

    pad_len = audio_cfg.chunk_samples

    def padded(wave):
        # zero-padded to the chunk length (the training collate's contract)
        w = np.asarray(wave, np.float32)[:pad_len]
        return np.pad(w, (0, pad_len - w.shape[-1]))

    def targets(second) -> list[int]:
        if pretokenized:
            return [int(t) for t in np.asarray(second).tolist()]
        return tokenizer.encode_from_pianoroll(np.asarray(second), max_len=args.max_len)

    if args.teacher_forced:
        # logits[:, t] predicts tokens[:, t + 1] (the training alignment)
        bs = min(8, n)
        n_eff = (n // bs) * bs if bs else 0
        tot = {"ok": 0, "valid": 0, "pitch_ok": 0, "pitch": 0}
        pitch_lo = tokenizer.note_on_base
        # REMI ids cover the 88 piano keys; the event vocab keeps full MIDI 0..127
        pitch_hi = pitch_lo + (128 if args.tokenizer == "event" else 88)
        for b0 in range(0, n_eff, bs):
            items = [dataset[i] for i in range(b0, b0 + bs)]
            w = torch.from_numpy(np.stack([padded(wave) for wave, _ in items]))
            tk = np.stack([np.asarray(targets(second), np.int64) for _, second in items])
            with torch.inference_mode():
                logits = model(w.to(device), targets=torch.from_numpy(tk).to(device))
                pred = logits.argmax(-1).cpu().numpy()
            tgt = tk[:, 1:]
            prd = pred[:, : tgt.shape[1]]
            valid = tgt != tokenizer.pad
            is_pitch = (tgt >= pitch_lo) & (tgt < pitch_hi) & valid
            tot["ok"] += int(((prd == tgt) & valid).sum())
            tot["valid"] += int(valid.sum())
            tot["pitch_ok"] += int(((prd == tgt) & is_pitch).sum())
            tot["pitch"] += int(is_pitch.sum())
        acc = tot["ok"] / max(1, tot["valid"])
        pacc = tot["pitch_ok"] / max(1, tot["pitch"])
        print(f"Teacher-forced next-token acc={acc:.4f} NOTE_ON-pitch acc={pacc:.4f} "
              f"({tot['pitch']} pitch tokens of {tot['valid']} valid, {n_eff} samples; "
              f"chance ~1/88)")
        if args.headless:
            print(f"EVAL_AST_TF_ACC={acc:.6f}")
            print(f"EVAL_AST_TF_PITCH_ACC={pacc:.6f}")
        return 0

    totals = {"tp": 0, "fp": 0, "fn": 0}
    frame = {"tp": 0, "pred": 0, "gt": 0}
    per_sample = []
    gen_kwargs = {}
    if args.constrained:
        gen_kwargs["allowed_next"] = torch.from_numpy(tokenizer.transition_mask()).to(device)
    if args.beam > 1:
        gen_kwargs.update(beam_size=args.beam, length_penalty=args.length_penalty,
                          eos_id=tokenizer.eos, pad_id=tokenizer.pad)
    bs = max(1, min(args.gen_batch_size, n))
    for b0 in range(0, n, bs):
        idxs = range(b0, min(b0 + bs, n))
        waves, gts, seconds = [], [], []
        for i in idxs:
            wave, second = dataset[i]
            waves.append(padded(wave))
            seconds.append(second)
            gts.append(targets(second))
        with torch.inference_mode():
            gen = model(torch.from_numpy(np.stack(waves)).to(device),
                        generate_max_len=args.max_len, **gen_kwargs).cpu().numpy()
        for row, i in enumerate(idxs):
            gen_tokens = trim_tokens(gen[row].tolist(), eos_id=tokenizer.eos,
                                     pad_id=tokenizer.pad)
            gt_tokens = trim_tokens(gts[row], eos_id=tokenizer.eos, pad_id=tokenizer.pad)
            gen_notes = decode_tokens_to_notes(gen_tokens, tokenizer, frame_rate=fr)
            gt_notes = decode_tokens_to_notes(gt_tokens, tokenizer, frame_rate=fr)
            m = note_f1(gen_notes, gt_notes, onset_tol=args.onset_tol, pitch_tol=args.pitch_tol)
            per_sample.append(m["f1"])
            for k in totals:
                totals[k] += m[k]
            print(f"[{i}] gen {len(gen_notes):4d} notes / gt {len(gt_notes):4d}: "
                  f"P={m['precision']:.3f} R={m['recall']:.3f} F1={m['f1']:.3f}")

            if args.frame_f1 and not pretokenized:
                gt_roll = np.asarray(seconds[row]) > 0.5
                gen_roll = tokenizer.decode_to_pianoroll(
                    gen_tokens, max_t=gt_roll.shape[-1]) > 0.5
                t_min = min(gt_roll.shape[-1], gen_roll.shape[-1])
                frame["tp"] += int((gt_roll[:, :t_min] & gen_roll[:, :t_min]).sum())
                # truncation is not free: frames past t_min count as misses
                frame["pred"] += int(gen_roll.sum())
                frame["gt"] += int(gt_roll.sum())

            if args.out_dir and i < args.midi_limit:
                for tag, trip in (("gen", gen_notes), ("gt", gt_notes)):
                    midi = notes_to_midi([Note(pitch=p, start=s, end=e, velocity=80)
                                          for p, s, e in trip])
                    save_midi(midi, os.path.join(args.out_dir, f"{tag}_{i}.mid"))

    tp, fp, fn = totals["tp"], totals["fp"], totals["fn"]
    prec = tp / (tp + fp + 1e-9)
    rec = tp / (tp + fn + 1e-9)
    micro = 2 * prec * rec / (prec + rec + 1e-9)
    mean = float(np.mean(per_sample)) if per_sample else 0.0
    print(f"\nNote-level micro P={prec:.4f} R={rec:.4f} F1={micro:.4f} "
          f"(mean per-sample F1={mean:.4f}, {n} samples)")
    if args.frame_f1 and frame["gt"]:
        fp_ = frame["tp"] / (frame["pred"] + 1e-9)
        fr_ = frame["tp"] / (frame["gt"] + 1e-9)
        ff1 = 2 * fp_ * fr_ / (fp_ + fr_ + 1e-9)
        print(f"Frame-level micro P={fp_:.4f} R={fr_:.4f} F1={ff1:.4f}")
        if args.headless:
            print(f"EVAL_AST_FRAME_F1={ff1:.6f}")
    if args.headless:
        print(f"EVAL_AST_NOTE_F1={micro:.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
