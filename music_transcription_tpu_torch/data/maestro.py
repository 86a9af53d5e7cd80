"""MAESTRO dataset: metadata, chunk index, features on the fly.

The port's copy of the JAX package's ``MaestroDataset``, with the same
indexing and numerics; the CSV is read with the standard library's ``csv``
module.

  * CSV-driven split / year / subset filtering (maestro-v3.0.0.csv, or the
    v2 name, or ``csv_path``)
  * chunk index: ``chunk_length`` windows advanced by
    ``chunk_samples * (1 - overlap)``; a tail chunk is kept when it covers
    at least half a window
  * per chunk: the audio window's log-mel (``ops.mel.log_mel_numpy``) and
    the binarized 88-key roll sampled at fs = sr / hop over
    ``np.linspace(start, end, int(dur * fs))``, both cut to the shorter length
  * ``return_waveform`` returns the samples instead of the log-mel
  * ``velocity`` gives a velocity roll (``MidiFile.keys_roll``: 1-127 where
    a key is on, 0 elsewhere) for the hFT-Transformer's targets
"""

from __future__ import annotations

import csv
import dataclasses
import os

import numpy as np

from music_transcription_tpu_torch.config import AudioConfig
from music_transcription_tpu_torch.data import audio as audio_io
from music_transcription_tpu_torch.data import midi as midi_io
from music_transcription_tpu_torch.ops.mel import log_mel_numpy


def _resolve_audio_path(root_dir: str, rel: str) -> str:
    """The CSV's audio path, or the same name as .mp3 when the .wav is absent."""
    path = os.path.join(root_dir, rel)
    if os.path.exists(path):
        return path
    if path.endswith(".wav"):
        alt = path[: -len(".wav")] + ".mp3"
        if os.path.exists(alt):
            return alt
        raise FileNotFoundError(
            f"audio file not found: {path} (also tried {alt}); check the dataset root and "
            f"the CSV's audio_filename column")
    raise FileNotFoundError(f"audio file not found: {path}; check the dataset root and the "
                            f"CSV's audio_filename column")


def read_csv_rows(csv_path, year=None, split: str | None = None,
                  subset_size: int | None = None) -> list[dict]:
    """The CSV's rows as dicts, filtered by year and split, the first
    ``subset_size`` of them."""
    with open(csv_path, newline="") as f:
        rows = list(csv.DictReader(f))
    if year is not None:
        rows = [r for r in rows if int(r["year"]) == int(year)]
    if split is not None:
        rows = [r for r in rows if r["split"] == split]
    return rows[:subset_size] if subset_size else rows


class MaestroDataset:
    """Chunked (or whole-file) MAESTRO access: ``dataset[i]`` is (mel
    (n_mels, T) float32, roll (88, T) float32), or (waveform (n,), roll)."""

    def __init__(self, root_dir, csv_path=None, year=None, split: str | None = "train",
                 audio_cfg: AudioConfig | None = None, subset_size: int | None = None,
                 chunk_length: float | None = None, overlap: float = 0.0,
                 return_waveform: bool = False, velocity: bool = False):
        self.root_dir = str(root_dir)
        self.cfg = audio_cfg or AudioConfig()
        if chunk_length is not None and chunk_length != self.cfg.chunk_length:
            self.cfg = dataclasses.replace(self.cfg, chunk_length=float(chunk_length))
        if chunk_length is not None and not (0.0 <= overlap < 1.0):
            raise ValueError(f"overlap must be in [0, 1); got {overlap} (overlap >= 1 would "
                             f"never advance the chunk window)")
        self.chunk_length = chunk_length
        self.overlap = overlap
        self.return_waveform = return_waveform
        self.velocity = velocity
        if csv_path is None:
            for name in ("maestro-v3.0.0.csv", "maestro-v2.0.0.csv"):
                csv_path = os.path.join(self.root_dir, name)
                if os.path.exists(csv_path):
                    break
            else:
                csv_path = os.path.join(self.root_dir, "maestro-v3.0.0.csv")
        self.rows = read_csv_rows(csv_path, year, split, subset_size)
        self.chunks: list[dict] = []
        if chunk_length is not None:
            self._build_chunk_index()

    def _build_chunk_index(self) -> None:
        sr = self.cfg.sample_rate
        chunk_samples = int(self.chunk_length * sr)
        hop_samples = int(chunk_samples * (1.0 - self.overlap))
        for file_idx, row in enumerate(self.rows):
            path = _resolve_audio_path(self.root_dir, row["audio_filename"])
            total_samples = int(audio_io.audio_duration(path) * sr)
            start = 0
            while start < total_samples:
                end = min(start + chunk_samples, total_samples)
                if (end - start) >= chunk_samples * 0.5:
                    self.chunks.append({"file_idx": file_idx, "start_sample": start,
                                        "end_sample": end, "start_time": start / sr,
                                        "end_time": end / sr})
                start += hop_samples
                if end >= total_samples:
                    break

    def __len__(self) -> int:
        return len(self.chunks) if self.chunk_length is not None else len(self.rows)

    def _midi(self, midi_path: str) -> midi_io.MidiFile:
        # a small per-instance cache of parsed MIDI files
        cache = self.__dict__.setdefault("_midi_cache", {})
        if midi_path not in cache:
            if len(cache) >= 32:
                cache.pop(next(iter(cache)))
            cache[midi_path] = midi_io.load_midi(midi_path)
        return cache[midi_path]

    def _paths(self, row: dict) -> tuple[str, str]:
        return (_resolve_audio_path(self.root_dir, row["audio_filename"]),
                os.path.join(self.root_dir, row["midi_filename"]))

    def __getitem__(self, idx: int):
        if self.chunk_length is None:
            audio_path, midi_path = self._paths(self.rows[idx])
            y, _ = audio_io.load_audio(audio_path, sr=self.cfg.sample_rate, mono=True)
            return self._pack(y, self._midi(midi_path).keys_roll(fs=self.cfg.frame_rate,
                                                                 velocity=self.velocity))
        info = self.chunks[idx]
        audio_path, midi_path = self._paths(self.rows[info["file_idx"]])
        dur = (info["end_sample"] - info["start_sample"]) / self.cfg.sample_rate
        y, _ = audio_io.load_audio(audio_path, sr=self.cfg.sample_rate, mono=True,
                                   offset=info["start_time"], duration=dur)
        fs = self.cfg.frame_rate
        times = np.linspace(info["start_time"], info["end_time"],
                            int((info["end_time"] - info["start_time"]) * fs))
        return self._pack(y, self._midi(midi_path).keys_roll(fs=fs, times=times,
                                                             velocity=self.velocity))

    def _pack(self, y: np.ndarray, roll: np.ndarray):
        if self.return_waveform:
            return y.astype(np.float32), roll.astype(np.float32)
        mel = log_mel_numpy(y, self.cfg)  # (n_mels, T)
        n = min(mel.shape[1], roll.shape[1])
        return mel[:, :n], roll[:, :n].astype(np.float32)
