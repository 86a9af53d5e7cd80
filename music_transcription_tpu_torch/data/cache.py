"""Preprocessed-chunk cache: write, read, verify.

The port's copy of the JAX package's ``data/cache.py`` (numpy only), so a
cache written by either package, or by the reference, loads in both:

  * native chunks are ``{split}/chunk_%06d.npz`` holding 'mel' | 'waveform'
    [+ 'tokens'] and 'roll'; int16 waveforms (PCM16 scale) and uint8 rolls
    are widened to float32 on load (a tokenized chunk reads as (waveform,
    tokens))
  * reference chunks ``chunk_%06d.pt`` load through ``torch.load``
  * metadata is ``{split}_metadata.pkl`` (num_chunks, chunk_length, overlap,
    n_mels, sr, hop_length, return_waveform, tokenize, chunks)

``HybridMaestroDataset`` uses the cache when its chunk_length and overlap
match the request, else loads chunks from the raw dataset. ``verify_cache``
checks a split's chunk count against its metadata and loads chunk 0.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

CHUNK_FMT = "chunk_{:06d}"
# PCM16 codec of compact waveforms: round(x * 32768) clipped to int16, and
# back x / 32768. The one scale of the encoder (quantize_i16, used by
# preprocessing's --compact and by device staging) and of the decoders
# (load_chunk, pipeline.dequantize_i16).
PCM16_SCALE = 32768.0


def metadata_path(cache_dir, split: str) -> str:
    return os.path.join(str(cache_dir), f"{split}_metadata.pkl")


def load_metadata(cache_dir, split: str) -> dict:
    # the cache's own metadata, written by this package, the JAX package or
    # the reference's preprocessing
    with open(metadata_path(cache_dir, split), "rb") as f:
        return pickle.load(f)


def save_metadata(cache_dir, split: str, meta: dict) -> None:
    os.makedirs(str(cache_dir), exist_ok=True)
    with open(metadata_path(cache_dir, split), "wb") as f:
        pickle.dump(meta, f)


def chunk_path(split_dir, idx: int, fmt: str = "npz") -> str:
    return os.path.join(str(split_dir), CHUNK_FMT.format(idx) + "." + fmt)


def quantize_i16(a: np.ndarray) -> np.ndarray:
    """Exact for audio decoded from 16-bit PCM; half-LSB error otherwise."""
    return np.clip(np.rint(a * PCM16_SCALE), -32768, 32767).astype(np.int16)


def save_chunk(split_dir, idx: int, arrays: dict) -> str:
    os.makedirs(str(split_dir), exist_ok=True)
    path = chunk_path(split_dir, idx)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)  # atomic: parallel writers produce whole files only
    return path


def load_chunk(split_dir, idx: int) -> dict:
    """Load a chunk by index: native .npz, or reference .pt via torch."""
    npz = chunk_path(split_dir, idx, "npz")
    if os.path.exists(npz):
        with np.load(npz) as z:
            out = {k: z[k] for k in z.files}
        if "waveform" in out and out["waveform"].dtype == np.int16:
            out["waveform"] = out["waveform"].astype(np.float32) / PCM16_SCALE
        if "roll" in out and out["roll"].dtype == np.uint8:
            out["roll"] = out["roll"].astype(np.float32)
        return out
    pt = chunk_path(split_dir, idx, "pt")
    if os.path.exists(pt):
        import torch

        data = torch.load(pt, map_location="cpu", weights_only=False)
        return {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v) for k, v in data.items()}
    raise FileNotFoundError(f"Cached chunk not found: {npz} (or .pt). Re-run preprocessing")


class CachedMaestroDataset:
    """Items: (waveform, tokens) for tokenized caches, (waveform, roll) for
    waveform caches, (mel (n_mels, T), roll (88, T)) for mel caches."""

    def __init__(self, cache_dir, split: str = "train", verbose: bool = True,
                 subset_size: int | None = None):
        self.cache_dir = str(cache_dir)
        self.split = split
        self.split_cache_dir = os.path.join(self.cache_dir, split)
        if not os.path.exists(metadata_path(cache_dir, split)):
            raise FileNotFoundError(
                f"Cache not found at {metadata_path(cache_dir, split)}. Run preprocessing first!")
        self.metadata = load_metadata(cache_dir, split)
        self.num_chunks = self.metadata["num_chunks"]
        # piece-level subsetting: chunks of the first N pieces (file_idx < N)
        self._indices = None
        if subset_size:
            chunks = self.metadata.get("chunks")
            if not chunks or "file_idx" not in chunks[0]:
                raise ValueError(
                    f"cache {cache_dir} has no per-chunk file_idx metadata; subset_size "
                    f"needs a cache written by the repo's preprocess_dataset.py")
            self._indices = [i for i, c in enumerate(chunks) if c["file_idx"] < subset_size]
            if not self._indices:
                raise ValueError(f"subset_size={subset_size} selects no chunks in split "
                                 f"'{split}' of {cache_dir}")
            self.num_chunks = len(self._indices)
        if not os.path.isdir(self.split_cache_dir):
            raise FileNotFoundError(
                f"Cache directory not found: {self.split_cache_dir}. Run preprocessing first!")
        if verbose:
            print(f"Loaded cached {split} dataset: {self.num_chunks} chunks, "
                  f"chunk_length={self.metadata.get('chunk_length')}s, dir={self.split_cache_dir}")

    def __len__(self) -> int:
        return self.num_chunks

    def __getitem__(self, idx: int):
        if self._indices is not None:
            idx = self._indices[idx]
        data = load_chunk(self.split_cache_dir, idx)
        if "tokens" in data:
            return data["waveform"], data["tokens"]
        if "waveform" in data:
            return data["waveform"], data["roll"]
        mel = np.asarray(data["mel"], np.float32)
        if mel.ndim == 3:  # reference caches store (1, n_mels, T)
            mel = mel[0]
        return mel, np.asarray(data["roll"], np.float32)


class HybridMaestroDataset:
    """The cache when it matches the request, the raw dataset otherwise."""

    def __init__(self, root_dir, cache_dir="cached_dataset", split: str = "train",
                 chunk_length: float | None = None, overlap: float = 0.0,
                 verbose: bool = True, **kwargs):
        self.use_cache = False
        if os.path.exists(metadata_path(cache_dir, split)):
            meta = load_metadata(cache_dir, split)
            if meta.get("chunk_length") == chunk_length and meta.get("overlap") == overlap:
                self.dataset = CachedMaestroDataset(cache_dir, split, verbose=verbose,
                                                    subset_size=kwargs.get("subset_size"))
                self.use_cache = True
                if verbose:
                    print("Using the cached dataset")
                return
        from music_transcription_tpu_torch.data.maestro import MaestroDataset

        self.dataset = MaestroDataset(root_dir=root_dir, split=split, chunk_length=chunk_length,
                                      overlap=overlap, **kwargs)
        if verbose:
            print("Using the raw dataset (slow); preprocess it into a cache for a speedup")

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, idx: int):
        return self.dataset[idx]


def verify_cache(cache_dir, split: str) -> tuple[bool, str]:
    """Chunk count against the metadata, then chunk 0 loaded and its keys
    checked. Returns (ok, message)."""
    try:
        meta = load_metadata(cache_dir, split)
    except FileNotFoundError:
        return False, f"missing metadata for split '{split}'"
    split_dir = os.path.join(str(cache_dir), split)
    if meta.get("num_chunks") == 0:
        # an empty split writes no chunk files and may have no directory
        return True, "0 chunks (empty split)"
    if not os.path.isdir(split_dir):
        return False, f"missing split directory {split_dir}"
    n_files = len([f for f in os.listdir(split_dir)
                   if f.startswith("chunk_") and not f.endswith(".tmp.npz")])
    if n_files != meta["num_chunks"]:
        return False, f"chunk count mismatch: metadata={meta['num_chunks']} files={n_files}"
    try:
        data = load_chunk(split_dir, 0)
    except Exception as e:  # a corrupt file of any kind fails the check, reported
        return False, f"failed to load chunk 0: {e}"
    want_keys = {"tokens", "waveform"} if meta.get("tokenize") else (
        {"waveform", "roll"} if meta.get("return_waveform") else {"mel", "roll"})
    if not want_keys <= set(data):
        return False, f"chunk 0 keys {sorted(data)} missing {sorted(want_keys - set(data))}"
    return True, f"{meta['num_chunks']} chunks ok"
