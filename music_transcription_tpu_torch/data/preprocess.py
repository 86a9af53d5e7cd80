"""Dataset preprocessing: MAESTRO -> per-chunk cache files.

The port of the JAX package's ``data/preprocess.py``, with its two paths:

  * **device path** (mel caches on ``device="cuda"``): decoder threads read
    audio windows and piano rolls, and the log-mel runs on the device in
    fixed-shape batches (``ops/mel.log_mel_batch``). Tail chunks are
    zero-padded to chunk_samples and their mel cut back to 1 + n // hop
    frames, which is what the unpadded computation gives (center padding
    sees the same zeros); the per-chunk top_db floor is then applied on the
    host over exactly the retained frames, so a transient in the padded
    frames cannot move the floor. The cache matches the host path's within
    the fp32 STFT's tolerance.
  * **host path**: the numpy log-mel, in this process or in a pool of
    ``num_workers`` processes started by ``spawn`` (the parent has torch's
    threads and may hold a CUDA context, so ``fork`` is unsafe). Each worker
    builds its own dataset and writes disjoint chunk files (skip-if-exists,
    atomic rename); workers touch no CUDA. Waveform and tokenized caches
    always take this path.

Metadata per split has the reference's keys (num_chunks, chunk_length,
overlap, n_mels, sr, hop_length, return_waveform, tokenize) plus token_len,
compact, the chunk index and, for a cache of velocity rolls (1-127, the
hFT-Transformer's targets), velocity; it is written only when no chunk
failed.
"""

from __future__ import annotations

import os
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from music_transcription_tpu_torch.config import AudioConfig
from music_transcription_tpu_torch.data import cache as C
from music_transcription_tpu_torch.data.maestro import MaestroDataset
from music_transcription_tpu_torch.models.remi_tokenizer import REMITokenizer
from music_transcription_tpu_torch.ops.mel import log_mel_batch, log_mel_numpy, num_frames


def _dataset_kwargs(root_dir, split, audio_cfg, chunk_length, overlap, velocity=False):
    return dict(root_dir=root_dir, split=split, audio_cfg=audio_cfg,
                chunk_length=chunk_length, overlap=overlap, velocity=velocity,
                return_waveform=True)  # decode once; the mel is computed here


def _tokens_for(roll, max_len=512):
    return np.asarray(REMITokenizer().encode_from_pianoroll(roll, max_len=max_len), np.int64)


def _compact_arrays(arrays):
    """Compact storage: the waveform as int16 at PCM16 scale (exact for
    16-bit PCM sources, half an LSB after resampling), a binary or velocity
    roll as uint8. ``cache.load_chunk`` widens both back to float32."""
    out = dict(arrays)
    if "waveform" in out:
        out["waveform"] = C.quantize_i16(out["waveform"])
    roll = out.get("roll")
    # only a roll of whole numbers 0-127 is exact as uint8; anything else
    # stays float32
    if (roll is not None and roll.size and (roll >= 0).all() and (roll <= 127).all()
            and (roll == np.rint(roll)).all()):
        out["roll"] = roll.astype(np.uint8)
    return out


def _save_one(split_dir, idx, wave, roll, *, mel, tokenize, return_waveform,
              compact=False, token_len=512):
    if tokenize:
        arrays = {"waveform": wave, "tokens": _tokens_for(roll, max_len=token_len),
                  "roll": roll}
    elif return_waveform:
        arrays = {"waveform": wave, "roll": roll}
    else:
        min_len = min(mel.shape[1], roll.shape[1])
        arrays = {"mel": mel[:, :min_len], "roll": roll[:, :min_len]}
    C.save_chunk(split_dir, idx, _compact_arrays(arrays) if compact else arrays)


def _process_one(dataset, idx, split_dir, return_waveform, tokenize, audio_cfg, compact,
                 token_len) -> bool:
    """Decode, featurize and write one chunk on the host; False if it failed."""
    try:
        wave, roll = dataset[idx]
        mel = None if return_waveform or tokenize else log_mel_numpy(wave, audio_cfg)
        _save_one(split_dir, idx, wave, roll, mel=mel, tokenize=tokenize,
                  return_waveform=return_waveform, compact=compact, token_len=token_len)
        return True
    except Exception:  # one chunk's failure is reported and the split goes on
        print(f"\nError processing chunk {idx}:\n{traceback.format_exc()}")
        return False


# A pool worker's dataset, built once per process from the pickled kwargs.
_WORKER_CACHE: dict = {}


def _host_worker(args):
    """Pool worker: one chunk, with this process's own dataset. Returns
    (ok, skipped)."""
    (idx, ds_kwargs, split_dir, force, return_waveform, tokenize, audio_cfg,
     compact, token_len) = args
    if os.path.exists(C.chunk_path(split_dir, idx)) and not force:
        return True, True
    key = tuple(sorted((k, str(v)) for k, v in ds_kwargs.items()))
    dataset = _WORKER_CACHE.get(key)
    if dataset is None:
        dataset = _WORKER_CACHE[key] = MaestroDataset(**ds_kwargs)
    return _process_one(dataset, idx, split_dir, return_waveform, tokenize, audio_cfg,
                        compact, token_len), False


def preprocess_split(*, root_dir, cache_dir, split: str, audio_cfg: AudioConfig,
                     chunk_length: float = 30.0, overlap: float = 0.0,
                     return_waveform: bool = False, tokenize: bool = False,
                     force: bool = False, num_workers: int = 1, device="cuda",
                     use_device: bool | None = None, device_batch: int = 32,
                     verbose: bool = True, compact: bool = False,
                     token_len: int = 512, velocity: bool = False) -> dict:
    """Preprocess one split; returns {total, processed, skipped, failed}.
    ``velocity`` stores velocity rolls (``MidiFile.keys_roll``).

    ``use_device=None`` takes the device path exactly when ``device`` is a
    CUDA device and the cache is a mel cache; ``True`` runs the device path
    on ``device`` (a CPU device too), ``False`` the host path."""
    ds_kwargs = _dataset_kwargs(root_dir, split, audio_cfg, chunk_length, overlap, velocity)
    dataset = MaestroDataset(**ds_kwargs)
    n = len(dataset)
    split_dir = os.path.join(str(cache_dir), split)
    meta = {
        "num_chunks": n,
        "chunk_length": chunk_length,
        "overlap": overlap,
        "n_mels": audio_cfg.n_mels,
        "sr": audio_cfg.sample_rate,
        "hop_length": audio_cfg.hop_length,
        "return_waveform": bool(return_waveform or tokenize),
        "tokenize": bool(tokenize),
        "token_len": int(token_len) if tokenize else None,
        "compact": bool(compact),
        "chunks": dataset.chunks,
        # the key only where it is set: a binary cache's metadata is the JAX package's
        **({"velocity": True} if velocity else {}),
    }

    todo = [i for i in range(n) if force or not os.path.exists(C.chunk_path(split_dir, i))]
    stats = {"total": n, "processed": 0, "skipped": n - len(todo), "failed": 0}
    if not todo:
        C.save_metadata(cache_dir, split, meta)
        if verbose:
            print(f"[{split}] all {n} chunks already cached")
        return stats

    mel_cache = not return_waveform and not tokenize
    if use_device is None:
        use_device = torch.device(device).type == "cuda"
    if use_device and mel_cache:
        _preprocess_device(dataset, todo, split_dir, audio_cfg, device_batch, num_workers,
                           stats, compact=compact, device=torch.device(device))
    elif num_workers > 1:
        from multiprocessing import get_context

        args = [(i, ds_kwargs, split_dir, force, return_waveform or tokenize, tokenize,
                 audio_cfg, compact, token_len) for i in todo]
        with get_context("spawn").Pool(num_workers) as pool:
            for ok, was_skipped in pool.imap_unordered(_host_worker, args):
                stats["processed" if ok and not was_skipped else
                      "skipped" if ok else "failed"] += 1
    else:
        for i in todo:
            ok = _process_one(dataset, i, split_dir, return_waveform or tokenize, tokenize,
                              audio_cfg, compact, token_len)
            stats["processed" if ok else "failed"] += 1

    # only a run in which every chunk was written may claim a complete cache:
    # the cached dataset trusts the metadata
    if stats["failed"] == 0:
        C.save_metadata(cache_dir, split, meta)
    elif verbose:
        print(f"[{split}] {stats['failed']} chunks failed; metadata NOT written "
              f"(re-run to retry the failures)")
    if verbose:
        print(f"[{split}] processed={stats['processed']} skipped={stats['skipped']} "
              f"failed={stats['failed']} (of {n})")
    return stats


def _preprocess_device(dataset, todo, split_dir, audio_cfg, device_batch, num_workers,
                       stats, *, compact, device):
    """Decoder threads feeding fixed-shape log-mel batches on ``device``.

    Submission is windowed: at most 2 device batches of decoded chunks are
    in flight, so a split's waveforms are never all held at once."""

    def decode(i):
        wave, roll = dataset[i]
        return i, wave, roll

    with ThreadPoolExecutor(max_workers=max(1, num_workers)) as pool:
        window = 2 * device_batch
        futures = [(i, pool.submit(decode, i)) for i in todo[:window]]
        next_idx = len(futures)
        batch: list = []
        while futures:
            idx, fut = futures.pop(0)
            if next_idx < len(todo):
                futures.append((todo[next_idx], pool.submit(decode, todo[next_idx])))
                next_idx += 1
            try:
                batch.append(fut.result())
            except Exception:  # one chunk's failure is reported, as on the host path
                print(f"\nError processing chunk {idx}:\n{traceback.format_exc()}")
                stats["failed"] += 1
            if batch and (len(batch) == device_batch or not futures):
                _flush_device_batch(batch, split_dir, audio_cfg, stats, compact=compact,
                                    device=device)
                batch = []


def _flush_device_batch(batch, split_dir, audio_cfg, stats, *, compact, device):
    chunk_samples = audio_cfg.chunk_samples
    waves = np.zeros((len(batch), chunk_samples), np.float32)
    for bi, (_, wave, _) in enumerate(batch):
        t = min(len(wave), chunk_samples)
        waves[bi, :t] = wave[:t]
    # unclamped dB: the floor is applied below, over the retained frames only
    mels = log_mel_batch(torch.from_numpy(waves).to(device), audio_cfg,
                         apply_floor=False).cpu().numpy()  # (B, n_mels, frames)
    for bi, (idx, wave, roll) in enumerate(batch):
        t_frames = num_frames(min(len(wave), chunk_samples), audio_cfg.hop_length)
        mel = mels[bi, :, :t_frames]
        mel = np.maximum(mel, mel.max() - audio_cfg.top_db)
        min_len = min(mel.shape[1], roll.shape[1])
        arrays = {"mel": mel[:, :min_len], "roll": roll[:, :min_len]}
        C.save_chunk(split_dir, idx, _compact_arrays(arrays) if compact else arrays)
        stats["processed"] += 1
