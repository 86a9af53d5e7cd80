"""Host-side audio decode and resampling (numpy).

Decode a file to float32 mono in [-1, 1] at a requested sample rate,
optionally a [offset, duration) window of it. RIFF/WAVE (PCM 8/16/24/32-bit,
IEEE float32/64, WAVE_FORMAT_EXTENSIBLE) is decoded here; other containers
go through the optional ``soundfile`` package when it is installed.

Resampling is a polyphase FIR (scipy.signal.resample_poly with a Kaiser
window). A mono decode goes through the host kit (``native.py``, C++) when
it builds; the numpy decode below is its fallback and its oracle, and gives
the same samples.
"""

from __future__ import annotations

import math
import struct

import numpy as np

from music_transcription_tpu_torch import native

_KAISER_BETA = 14.769656459379492  # ~ kaiser_best quality


class AudioDecodeError(ValueError):
    pass


def _parse_wav_header(f):
    """Return (fmt_code, channels, sr, bits, data_offset, data_size)."""
    riff = f.read(12)
    if len(riff) < 12 or riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
        raise AudioDecodeError("not a RIFF/WAVE file")
    fmt_code = channels = sr = bits = None
    data_offset = data_size = None
    while True:
        hdr = f.read(8)
        if len(hdr) < 8:
            break
        chunk_id, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
        if chunk_id == b"fmt ":
            fmt = f.read(size)
            fmt_code, channels, sr = struct.unpack("<HHI", fmt[:8])
            bits = struct.unpack("<H", fmt[14:16])[0]
            if fmt_code == 0xFFFE and size >= 24:  # WAVE_FORMAT_EXTENSIBLE
                fmt_code = struct.unpack("<H", fmt[24:26])[0]
        elif chunk_id == b"data":
            data_offset = f.tell()
            data_size = size
            f.seek(size + (size & 1), 1)
        else:
            f.seek(size + (size & 1), 1)
    if fmt_code is None or data_offset is None:
        raise AudioDecodeError("missing fmt/data chunk")
    return fmt_code, channels, sr, bits, data_offset, data_size


def _decode_frames(raw: bytes, fmt_code: int, bits: int, channels: int) -> np.ndarray:
    """bytes -> float32 (n_frames, channels) in [-1, 1]."""
    if fmt_code == 1:  # PCM
        if bits == 16:
            x = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
        elif bits == 8:
            x = (np.frombuffer(raw, "u1").astype(np.float32) - 128.0) / 128.0
        elif bits == 24:
            b = np.frombuffer(raw, "u1").reshape(-1, 3)
            x = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            x = (x - ((x & 0x800000) << 1)).astype(np.float32) / 8388608.0
        elif bits == 32:
            x = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
        else:
            raise AudioDecodeError(f"unsupported PCM bit depth: {bits}")
    elif fmt_code == 3:  # IEEE float
        x = np.frombuffer(raw, "<f4" if bits == 32 else "<f8").astype(np.float32)
    else:
        raise AudioDecodeError(f"unsupported WAV format code: {fmt_code}")
    return x.reshape(-1, channels)


def load_wav(
    path,
    sr: int | None = None,
    mono: bool = True,
    offset: float = 0.0,
    duration: float | None = None,
) -> tuple[np.ndarray, int]:
    """Decode a WAV file -> (float32 samples, sample_rate).

    librosa.load semantics: mono mixdown is the channel mean; when ``sr``
    differs from the file rate, the signal is resampled and, with
    ``duration`` set, trimmed/zero-padded to round(duration * sr) samples.
    """
    decoded = _load_wav_native(path, offset, duration) if mono else None
    y, file_sr = decoded if decoded is not None else _load_wav_numpy(path, mono, offset,
                                                                      duration)
    if sr is not None and sr != file_sr:
        y = resample(y, file_sr, sr)
        if duration is not None:
            y = fix_length(y, int(round(duration * sr)))
        file_sr = sr
    return np.ascontiguousarray(y, dtype=np.float32), file_sr


def _load_wav_numpy(path, mono, offset, duration):
    """The numpy decode of the window at the file's rate: (samples, file_sr)."""
    with open(path, "rb") as f:
        fmt_code, channels, file_sr, bits, data_offset, data_size = _parse_wav_header(f)
        bytes_per_frame = channels * (bits // 8)
        total_frames = data_size // bytes_per_frame
        start_frame = min(int(round(offset * file_sr)), total_frames)
        if duration is None:
            n_frames = total_frames - start_frame
        else:
            n_frames = min(int(round(duration * file_sr)), total_frames - start_frame)
        f.seek(data_offset + start_frame * bytes_per_frame)
        raw = f.read(n_frames * bytes_per_frame)
    x = _decode_frames(raw, fmt_code, bits, channels)
    if not mono:
        return x.T, file_sr
    return (x.mean(axis=1) if channels > 1 else x[:, 0]), file_sr


def _load_wav_native(path, offset, duration):
    """The host kit's mono decode of the window: (samples, file_sr), or None
    when the kit is not built or does not take the file."""
    if not native.available():
        return None
    try:
        info = native.wav_info(path)
        start = min(int(round(offset * info.sample_rate)), info.n_frames)
        if duration is None:
            n = info.n_frames - start
        else:
            n = min(int(round(duration * info.sample_rate)), info.n_frames - start)
        return native.decode_wav(path, start, n), info.sample_rate
    except ValueError:
        return None


def load_audio(path, sr=None, mono=True, offset=0.0, duration=None):
    """Decode any supported audio file; WAV natively, others via soundfile
    if installed."""
    p = str(path)
    try:
        return load_wav(p, sr=sr, mono=mono, offset=offset, duration=duration)
    except AudioDecodeError:
        pass
    try:  # pragma: no cover - optional dependency
        import soundfile as sf

        with sf.SoundFile(p) as fh:
            file_sr = fh.samplerate
            fh.seek(int(round(offset * file_sr)))
            frames = -1 if duration is None else int(round(duration * file_sr))
            data = fh.read(frames=frames, dtype="float32", always_2d=True)
        y = data.mean(axis=1) if mono else data.T
        if sr is not None and sr != file_sr:
            y = resample(y, file_sr, sr)
            if duration is not None:
                y = fix_length(y, int(round(duration * sr)))
            file_sr = sr
        return np.ascontiguousarray(y, dtype=np.float32), file_sr
    except ImportError:
        raise AudioDecodeError(
            f"{p}: not a WAV file and no optional decoder (soundfile) is "
            f"installed; convert to WAV."
        )


def audio_duration(path) -> float:
    """Duration in seconds without decoding samples. Non-WAV containers go
    through the optional ``soundfile`` package when it is installed."""
    try:
        with open(path, "rb") as f:
            _, channels, sr, bits, _, data_size = _parse_wav_header(f)
        return data_size / (channels * (bits // 8)) / sr
    except AudioDecodeError:
        try:
            import soundfile as sf
        except ImportError:
            raise AudioDecodeError(f"{path}: not a WAV file and no optional decoder "
                                   f"(soundfile) is installed; convert it to WAV") from None
        info = sf.info(str(path))
        return info.frames / info.samplerate


def resample(y: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase anti-aliased resampling along the last axis."""
    if orig_sr == target_sr:
        return y
    from scipy import signal  # imported here: some 3 s that a CLI reading 16 kHz audio never pays

    g = math.gcd(int(orig_sr), int(target_sr))
    up, down = target_sr // g, orig_sr // g
    return signal.resample_poly(y, up, down, axis=-1, window=("kaiser", _KAISER_BETA)).astype(
        np.float32
    )


def fix_length(y: np.ndarray, size: int) -> np.ndarray:
    """Trim or zero-pad the last axis to exactly ``size`` samples."""
    n = y.shape[-1]
    if n > size:
        return y[..., :size]
    if n < size:
        pad = [(0, 0)] * (y.ndim - 1) + [(0, size - n)]
        return np.pad(y, pad)
    return y


def split_into_chunks(y: np.ndarray, chunk_samples: int,
                      hop_samples: int | None = None) -> np.ndarray:
    """(n,) audio -> (num_chunks, chunk_samples), zero-padding the tail.

    Chunks become a batch dimension so the whole recording runs through the
    model as one device batch. ``hop_samples`` < ``chunk_samples`` produces
    overlapping windows (chunk i starts at ``i * hop_samples``); pair with
    ``transcribe.stitch_rolls``. Default (None) is the non-overlapping layout.
    """
    n = y.shape[-1]
    if hop_samples is None or hop_samples >= chunk_samples:
        num_chunks = max(1, -(-n // chunk_samples))
        padded = fix_length(y, num_chunks * chunk_samples)
        return padded.reshape(num_chunks, chunk_samples)
    if hop_samples <= 0:
        raise ValueError(f"hop_samples must be positive, got {hop_samples}")
    num_chunks = 1 + max(0, -(-(n - chunk_samples) // hop_samples))
    padded = fix_length(y, (num_chunks - 1) * hop_samples + chunk_samples)
    out = np.empty((num_chunks, chunk_samples), padded.dtype)
    for i in range(num_chunks):
        out[i] = padded[i * hop_samples: i * hop_samples + chunk_samples]
    return out
