"""Log-mel spectrogram frontend, numerically matched to librosa defaults.

librosa 0.10 semantics, as in the JAX package's ``ops/mel.py``:

  * STFT: n_fft=2048, win_length=n_fft, periodic Hann window, center=True
    with zero padding, power spectrum |Z|^2
  * Slaney-scale mel filterbank with 'slaney' area normalization
  * power_to_db: 10*log10(max(amin, S)), then floored at (per-chunk max -
    top_db); the max is taken per batch element over mels and frames

The numpy helpers below are the port's copies of the JAX module's host
helpers; ``log_mel_numpy`` is the float64 oracle. ``log_mel_batch`` is the
device path: ``torch.stft`` in fp32, one mel matmul, the dB conversion.
It runs in full fp32 with TF32 off (ops/precision.py).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from music_transcription_tpu_torch.config import AudioConfig
from music_transcription_tpu_torch.ops.precision import full_fp32

# ---------------------------------------------------------------------------
# Filterbank / window construction (host, float64)
# ---------------------------------------------------------------------------


def hz_to_mel(freq: np.ndarray) -> np.ndarray:
    """Slaney mel scale: linear below 1 kHz, log above."""
    freq = np.asarray(freq, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = freq / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = freq >= min_log_hz
    mels = np.where(log_region, min_log_mel + np.log(np.maximum(freq, 1e-10) / min_log_hz) / logstep, mels)
    return mels


def mel_to_hz(mels: np.ndarray) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = mels >= min_log_mel
    freqs = np.where(log_region, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs)
    return freqs


def mel_filterbank(
    sr: int, n_fft: int, n_mels: int, fmin: float = 0.0, fmax: float | None = None
) -> np.ndarray:
    """(n_mels, 1 + n_fft//2) triangular Slaney-normalized filterbank."""
    if fmax is None:
        fmax = sr / 2.0
    n_bins = 1 + n_fft // 2
    fftfreqs = np.linspace(0.0, sr / 2.0, n_bins)
    mel_pts = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_pts[2:] - mel_pts[:-2])
    return weights * enorm[:, None]


def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann (scipy get_window('hann', N, fftbins=True))."""
    n = np.arange(win_length, dtype=np.float64)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)


def _padded_window(n_fft: int, win_length: int) -> np.ndarray:
    """Hann window zero-padded to n_fft, centered (librosa util.pad_center)."""
    w = hann_window(win_length)
    if win_length == n_fft:
        return w
    lpad = (n_fft - win_length) // 2
    out = np.zeros(n_fft, dtype=np.float64)
    out[lpad : lpad + win_length] = w
    return out


def num_frames(n_samples: int, hop_length: int) -> int:
    """Frame count for center=True STFT: 1 + n_samples // hop."""
    return 1 + n_samples // hop_length


def log_mel_numpy(y: np.ndarray, cfg: AudioConfig) -> np.ndarray:
    """(n_samples,) float audio -> (n_mels, T) float32 log-mel, T = 1 + n//hop."""
    n_fft, hop = cfg.n_fft, cfg.hop_length
    win = _padded_window(n_fft, cfg.effective_win_length)
    y = np.asarray(y, dtype=np.float64)
    padded = np.pad(y, n_fft // 2)  # center=True, zero pad
    t = num_frames(len(y), hop)
    idx = np.arange(n_fft)[None, :] + hop * np.arange(t)[:, None]
    frames = padded[idx] * win[None, :]
    spec = np.abs(np.fft.rfft(frames, axis=-1)) ** cfg.power  # (T, n_bins)
    fb = mel_filterbank(cfg.sample_rate, n_fft, cfg.n_mels, cfg.fmin, cfg.fmax)
    mel = spec @ fb.T  # (T, n_mels)
    log_spec = 10.0 * np.log10(np.maximum(cfg.amin, mel))
    log_spec = np.maximum(log_spec, log_spec.max() - cfg.top_db)
    return log_spec.T.astype(np.float32)  # (n_mels, T)


# ---------------------------------------------------------------------------
# Torch (device) implementation
# ---------------------------------------------------------------------------


@lru_cache(maxsize=8)
def _host_constants(key: tuple) -> tuple[np.ndarray, np.ndarray]:
    """(window (n_fft,), filterbank transposed (n_bins, n_mels)) as fp32."""
    sr, n_fft, win_length, n_mels, fmin, fmax = key
    win = _padded_window(n_fft, win_length).astype(np.float32)
    fb = mel_filterbank(sr, n_fft, n_mels, fmin, fmax).astype(np.float32)
    return win, np.ascontiguousarray(fb.T)


@lru_cache(maxsize=8)
def _device_constants(key: tuple, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """``_host_constants`` on ``device``, copied there once: a training step
    that computes its mel copies nothing from the host. Made outside
    inference mode, so a first call under it caches ordinary tensors."""
    with torch.inference_mode(False):
        return tuple(torch.from_numpy(a).to(device) for a in _host_constants(key))


def log_mel_batch(y: torch.Tensor, cfg: AudioConfig, apply_floor: bool = True) -> torch.Tensor:
    """(B, n_samples) audio -> (B, n_mels, T) float32 log-mel, on y's device.

    The top_db floor uses the per-sample max (one floor per chunk).
    ``apply_floor=False`` returns the unclamped dB values.
    """
    win, fb_t = _device_constants((cfg.sample_rate, cfg.n_fft, cfg.effective_win_length,
                                   cfg.n_mels, cfg.fmin, cfg.effective_fmax), y.device)
    with full_fp32():
        z = torch.stft(
            y.to(torch.float32), n_fft=cfg.n_fft, hop_length=cfg.hop_length,
            window=win, center=True, pad_mode="constant", return_complex=True,
        )  # (B, n_bins, T)
        spec = z.real * z.real + z.imag * z.imag
        if cfg.power != 2.0:
            spec = spec ** (cfg.power / 2.0)
        mel = torch.matmul(spec.transpose(1, 2), fb_t)  # (B, T, n_mels)
    log_spec = 10.0 * torch.log10(torch.clamp(mel, min=cfg.amin))
    if apply_floor:
        floor = log_spec.amax(dim=(-2, -1), keepdim=True) - cfg.top_db
        log_spec = torch.maximum(log_spec, floor)
    return log_spec.transpose(1, 2)  # (B, n_mels, T)
