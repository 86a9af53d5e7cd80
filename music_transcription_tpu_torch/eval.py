"""Evaluation: framewise F1, threshold tuning, note metrics, report artifacts.

The port's copy of the JAX package's ``eval.py``. Probabilities are computed
once per dataset in batched forwards on the device (sigmoid kept on the host
as float16), so a threshold sweep costs one vectorized comparison per
candidate instead of a model forward. Framewise F1 comes from per-sample
tp / fp / fn counts over the valid frames (sklearn's binary ``f1_score`` with
``zero_division=0``). The tuning schedule is the reference's: a grid over
[min, max] by step, re-centred on the best +- 2 steps, the step halved,
until it falls below ``min_step``.

Everything but ``predict_probs`` is numpy, copied so that the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from music_transcription_tpu_torch.config import MIN_MIDI
from music_transcription_tpu_torch.data import midi as midi_io


@dataclass
class CachedPredictions:
    """Host-side cache of one pass over an eval set."""

    probs: list[np.ndarray]  # each (88, T_i), cache_dtype (default float16)
    targets: list[np.ndarray]  # each (88, T_i) bool
    lengths: list[int]


def predict_probs(model, loader, *, verbose: bool = False, pad_batch_to: int | None = None,
                  cache_dtype=np.float16) -> CachedPredictions:
    """One batched forward per loader batch on the model's device, under
    ``inference_mode``; sigmoid probabilities cached on the host.

    ``pad_batch_to`` zero-pads a smaller final batch up to a fixed size
    (padded rows are discarded), so every batch takes the same attention
    route under "auto" (the rule depends on the batch size), as in the JAX
    package.

    ``cache_dtype`` is the host cache precision. float16 (default) quantizes
    thresholds to ~5e-4 near 0.5, far below the 0.01 minimum tuning step;
    pass np.float32 for exact threshold comparisons."""
    device = next(model.parameters()).device
    model.eval()
    probs_l, targets_l, lengths_l = [], [], []
    for bi, (mel, roll, lengths) in enumerate(loader):
        mel = torch.as_tensor(np.asarray(mel))
        n_real = mel.shape[0]
        if pad_batch_to and n_real < pad_batch_to:
            mel = torch.cat([mel, mel.new_zeros((pad_batch_to - n_real, *mel.shape[1:]))])
        with torch.inference_mode():
            p = torch.sigmoid(model(mel.to(device)))[:n_real]
        p = p.float().cpu().numpy().astype(cache_dtype)
        for i in range(n_real):
            t = int(lengths[i])
            probs_l.append(p[i, :, :t])
            targets_l.append(np.asarray(roll[i, :, :t]) > 0)
            lengths_l.append(t)
        if verbose and (bi + 1) % 20 == 0:
            print(f"  eval forward {bi + 1}/{len(loader)}")
    return CachedPredictions(probs=probs_l, targets=targets_l, lengths=lengths_l)


def _counts(pred: np.ndarray, target: np.ndarray) -> tuple[int, int, int]:
    tp = int(np.logical_and(pred, target).sum())
    fp = int(np.logical_and(pred, ~target).sum())
    fn = int(np.logical_and(~pred, target).sum())
    return tp, fp, fn


def f1_from_counts(tp: int, fp: int, fn: int) -> float:
    denom = 2 * tp + fp + fn
    return 2.0 * tp / denom if denom > 0 else 0.0  # sklearn zero_division=0


def per_sample_f1(cached: CachedPredictions, threshold: float) -> np.ndarray:
    out = np.empty(len(cached.probs), np.float64)
    for i, (p, t) in enumerate(zip(cached.probs, cached.targets)):
        out[i] = f1_from_counts(*_counts(p > threshold, t))
    return out


def mean_f1(cached: CachedPredictions, threshold: float) -> float:
    """Mean of per-sample F1 (the reference's metric)."""
    arr = per_sample_f1(cached, threshold)
    return float(arr.mean()) if arr.size else 0.0


def grid_f1_sums(cached: CachedPredictions, thresholds: np.ndarray) -> tuple[np.ndarray, int]:
    """Per-threshold SUM of per-sample F1, and the sample count."""
    thresholds = np.asarray(thresholds, np.float32)
    sums = np.zeros(len(thresholds), np.float64)
    for p, t in zip(cached.probs, cached.targets):
        # (88*T, 1) vs (K,) comparison; tp/fp/fn per threshold
        flat = p.reshape(-1, 1) > thresholds[None, :]  # (N, K)
        tgt = t.reshape(-1, 1)
        tp = np.logical_and(flat, tgt).sum(axis=0)
        fp = np.logical_and(flat, ~tgt).sum(axis=0)
        fn = np.logical_and(~flat, tgt).sum(axis=0)
        denom = 2 * tp + fp + fn
        sums += np.where(denom > 0, 2.0 * tp / np.maximum(denom, 1), 0.0)
    return sums, len(cached.probs)


def grid_mean_f1(cached: CachedPredictions, thresholds: np.ndarray) -> np.ndarray:
    """Mean F1 for a whole grid of thresholds in one vectorized pass."""
    sums, count = grid_f1_sums(cached, thresholds)
    return sums / max(1, count)


def tune_threshold(cached: CachedPredictions, *, rounds: int = 6,
                   tune_range: tuple[float, float] = (0.05, 0.95), step: float = 0.1,
                   min_step: float = 0.01, verbose: bool = True,
                   grid_fn=None) -> tuple[float, float]:
    """Coarse-to-fine threshold search from cached probabilities (no model
    re-forward). Returns (best threshold, its mean F1).

    ``grid_fn(cached, thresholds) -> mean-F1 array`` replaces the local grid
    evaluation: evaluation across ranks passes one that reduces the grid
    over them (``evaluate.py``)."""
    if grid_fn is None:
        grid_fn = grid_mean_f1
    tune_min, tune_max = tune_range
    best_threshold, best_f1 = 0.5, -1.0
    for round_num in range(1, rounds + 1):
        thresholds = np.arange(tune_min, tune_max + step / 2, step)
        f1s = grid_fn(cached, thresholds)
        if verbose:
            print(f"=== Round {round_num}/{rounds} | range=[{tune_min:.4f}, "
                  f"{tune_max:.4f}] step={step:.4f} ===")
            for t, f in zip(thresholds, f1s):
                print(f"  t={t:.4f}  f1={f:.6f}")
        if f1s.size and f1s.max() > best_f1:
            best_f1 = float(f1s.max())
            best_threshold = float(thresholds[int(f1s.argmax())])
        if verbose:
            print(f"Round best: t={best_threshold:.4f} f1={best_f1:.6f}\n")
        tune_min = max(0.01, best_threshold - 2 * step)
        tune_max = min(0.99, best_threshold + 2 * step)
        step = step / 2
        if step < min_step:
            break
    return best_threshold, best_f1


# ---------------------------------------------------------------------------
# Note-level onset metrics (greedy onset matching within +-tolerance, per pitch)
# ---------------------------------------------------------------------------


def _onsets_per_pitch(roll: np.ndarray) -> list[np.ndarray]:
    """(88, T) binary roll -> per-pitch frame indices of 0->1 transitions."""
    active = roll > 0
    padded = np.zeros((active.shape[0], active.shape[1] + 1), bool)
    padded[:, 1:] = active
    changes = active & ~padded[:, :-1]
    return [np.nonzero(changes[p])[0] for p in range(roll.shape[0])]


def note_onset_prf(pred_roll: np.ndarray, true_roll: np.ndarray, fs: float,
                   tolerance_s: float = 0.05) -> tuple[float, float, float]:
    """Note-level onset precision / recall / F1 with greedy nearest matching
    within +-tolerance seconds (default +-50 ms)."""
    tol_frames = max(0, int(round(tolerance_s * fs)))
    pred_on = _onsets_per_pitch(pred_roll)
    true_on = _onsets_per_pitch(true_roll)
    tp = 0
    n_pred = sum(len(o) for o in pred_on)
    n_true = sum(len(o) for o in true_on)
    for p in range(len(pred_on)):
        preds = list(pred_on[p])
        for t_on in true_on[p]:
            if not preds:
                break
            dists = [abs(x - t_on) for x in preds]
            j = int(np.argmin(dists))
            if dists[j] <= tol_frames:
                tp += 1
                preds.pop(j)  # greedy: each predicted onset matches once
    precision = tp / n_pred if n_pred else 0.0
    recall = tp / n_true if n_true else 0.0
    f1 = 2 * precision * recall / (precision + recall) if (precision + recall) else 0.0
    return precision, recall, f1


def per_sample_onset_f1(cached: CachedPredictions, threshold: float, fs: float,
                        tolerance_s: float = 0.05) -> np.ndarray:
    out = np.empty(len(cached.probs), np.float64)
    for i, (p, t) in enumerate(zip(cached.probs, cached.targets)):
        _, _, out[i] = note_onset_prf((p > threshold).astype(np.float32),
                                      t.astype(np.float32), fs, tolerance_s)
    return out


# ---------------------------------------------------------------------------
# Token route (AST tier): note-level F1 on generated token sequences
# ---------------------------------------------------------------------------


def trim_tokens(token_list, eos_id: int = 1, pad_id: int = 2) -> list[int]:
    """Drop pads; keep everything up to and including <eos>."""
    out = []
    for t in token_list:
        t = int(t)
        if t == pad_id:
            continue
        out.append(t)
        if t == eos_id:
            break
    return out


def note_f1(pred_notes, ref_notes, onset_tol: float = 0.05, pitch_tol: float = 0.0) -> dict:
    """Greedy onset matching over (pitch, start, end) triples: each predicted
    note takes the closest unused reference note within both tolerances."""
    used = np.zeros(len(ref_notes), dtype=bool)
    tp = 0
    for pp, ps, _pe in pred_notes:
        best_j, best_dt = -1, None
        for j, (rp, rs, _re) in enumerate(ref_notes):
            if used[j] or abs(pp - rp) > pitch_tol:
                continue
            dt = abs(ps - rs)
            if dt <= onset_tol and (best_dt is None or dt < best_dt):
                best_dt, best_j = dt, j
        if best_j >= 0:
            used[best_j] = True
            tp += 1
    fp = len(pred_notes) - tp
    fn = len(ref_notes) - tp
    prec = tp / (tp + fp + 1e-9)
    rec = tp / (tp + fn + 1e-9)
    f1 = 2 * prec * rec / (prec + rec + 1e-9)
    return {"tp": tp, "fp": fp, "fn": fn, "precision": prec, "recall": rec, "f1": f1}


def decode_tokens_to_notes(tokens, tokenizer, frame_rate: float,
                           max_t: int = 4096) -> list[tuple]:
    """Token ids -> [(pitch, start_s, end_s)] under either vocabulary (an
    event tokenizer decodes to notes directly; REMI walks a piano roll)."""
    if hasattr(tokenizer, "decode_to_notes"):
        return [(n.pitch, n.start, n.end) for n in tokenizer.decode_to_notes(tokens)]
    roll = tokenizer.decode_to_pianoroll(tokens, max_t=max_t)
    return [(n.pitch, n.start, n.end) for n in midi_io.pianoroll_to_notes(roll, fs=frame_rate)]


# ---------------------------------------------------------------------------
# Report artifacts
# ---------------------------------------------------------------------------


def global_confusion(cached: CachedPredictions, threshold: float) -> np.ndarray:
    """2x2 [[tn, fp], [fn, tp]] over all valid frames."""
    tp = fp = fn = tn = 0
    for p, t in zip(cached.probs, cached.targets):
        pred = p > threshold
        tp += int(np.logical_and(pred, t).sum())
        fp += int(np.logical_and(pred, ~t).sum())
        fn += int(np.logical_and(~pred, t).sum())
        tn += int(np.logical_and(~pred, ~t).sum())
    return np.array([[tn, fp], [fn, tp]], np.int64)


def write_summary(path, f1_scores: np.ndarray, threshold: float, *, extra: dict | None = None,
                  n_best_worst: int = 5) -> None:
    """eval_summary.txt: the extra fields, threshold, F1 statistics and the
    worst and best samples."""
    order = np.argsort(f1_scores)
    with open(path, "w") as f:
        f.write("=" * 70 + "\n")
        f.write("EVALUATION SUMMARY\n")
        f.write("=" * 70 + "\n")
        for k, v in (extra or {}).items():
            f.write(f"{k}: {v}\n")
        f.write(f"threshold: {threshold}\n")
        f.write(f"samples: {len(f1_scores)}\n")
        f.write(f"mean F1: {f1_scores.mean():.6f}\n")
        f.write(f"std  F1: {f1_scores.std():.6f}\n")
        f.write(f"min  F1: {f1_scores.min():.6f}\n")
        f.write(f"max  F1: {f1_scores.max():.6f}\n\n")
        f.write(f"Worst {n_best_worst} samples:\n")
        for i in order[:n_best_worst]:
            f.write(f"  sample {i}: F1={f1_scores[i]:.6f}\n")
        f.write(f"\nBest {n_best_worst} samples:\n")
        for i in order[::-1][:n_best_worst]:
            f.write(f"  sample {i}: F1={f1_scores[i]:.6f}\n")


def plot_confusion(path, confusion: np.ndarray) -> None:
    """confusion_matrix.png; skipped where matplotlib is not installed."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    fig, ax = plt.subplots(figsize=(4, 4))
    frac = confusion / max(1, confusion.sum())
    ax.imshow(frac, cmap="Blues")
    for i in range(2):
        for j in range(2):
            ax.text(j, i, f"{confusion[i, j]:,}\n({frac[i, j]:.3%})",
                    ha="center", va="center", fontsize=9)
    ax.set_xticks([0, 1], ["pred off", "pred on"])
    ax.set_yticks([0, 1], ["true off", "true on"])
    ax.set_title("framewise confusion")
    fig.savefig(path, dpi=100, bbox_inches="tight")
    plt.close(fig)


def write_sample_midis(cached: CachedPredictions, threshold: float, out_dir, fs: float,
                       limit: int | None = None) -> None:
    os.makedirs(out_dir, exist_ok=True)
    n = len(cached.probs) if limit is None else min(limit, len(cached.probs))
    for i in range(n):
        roll = (cached.probs[i] > threshold).astype(np.float32)
        notes = midi_io.pianoroll_to_notes(roll, fs=fs, min_midi=MIN_MIDI)
        midi_io.save_midi(midi_io.notes_to_midi(notes), os.path.join(out_dir, f"sample_{i:04d}.mid"))
