"""ctypes binding of the host kit (``csrc/hostkit.cpp``): WAV decode and
piano-roll fill in C++ for the data loader.

The library is built with the system C++ compiler at first use into
``build/host/`` at the root of the checkout (listed in ``.gitignore``), named
by a hash of the source and the flags, so an edited source is rebuilt and a
stale library is never loaded. A build goes to a file of its own process and
is then renamed into place, so processes that build at once (test workers,
preprocessing workers) each load a whole library. Nothing is built or loaded
at import.

  * ``decode_wav(path, start_frame, n_frames)`` -> float32 mono samples
  * ``wav_info(path)`` -> (format, channels, sample_rate, bits, n_frames)
  * ``fill_roll(pitches, starts, ends, velocities, fs, n_cols)`` -> (128, T)

``available()`` gates every use: the callers in ``data/audio.py`` and
``data/midi.py`` keep their numpy paths as the fallback, and the tests hold
the library against them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "hostkit.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "host"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None
_tried = False


class _WavInfo(ctypes.Structure):
    _fields_ = [
        ("format", ctypes.c_int32),
        ("channels", ctypes.c_int32),
        ("sample_rate", ctypes.c_int32),
        ("bits", ctypes.c_int32),
        ("data_offset", ctypes.c_int64),
        ("n_frames", ctypes.c_int64),
    ]


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libhostkit-{digest.hexdigest()[:12]}.so"


def build() -> Path | None:
    """The library's path, compiled first if it is missing; None when no C++
    compiler builds it."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    for cxx in ("g++", "c++", "clang++"):
        if shutil.which(cxx) is None:
            continue
        try:
            proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                                  capture_output=True, text=True, timeout=120)
        except subprocess.TimeoutExpired:
            continue
        if proc.returncode == 0:
            os.replace(tmp, out)  # atomic: a concurrent build renames an identical file
            return out
    tmp.unlink(missing_ok=True)
    return None


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        path = build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        lib.mt_wav_info.argtypes = [ctypes.c_char_p, ctypes.POINTER(_WavInfo)]
        lib.mt_wav_info.restype = ctypes.c_int
        lib.mt_decode_wav.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                                      ctypes.POINTER(ctypes.c_float)]
        lib.mt_decode_wav.restype = ctypes.c_int64
        lib.mt_fill_roll.argtypes = [
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            ctypes.c_double, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ]
        lib.mt_fill_roll.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the library is built and loaded (building it at the first call)."""
    return _load() is not None


def wav_info(path) -> _WavInfo:
    info = _WavInfo()
    rc = _load().mt_wav_info(str(path).encode(), ctypes.byref(info))
    if rc != 0:
        raise ValueError(f"hostkit: cannot parse {path} (rc={rc})")
    return info


def decode_wav(path, start_frame: int = 0, n_frames: int | None = None) -> np.ndarray:
    """float32 mono samples (the channel mean) of the window; raises
    ValueError on encodings it does not take."""
    if n_frames is None:
        n_frames = wav_info(path).n_frames - start_frame
    out = np.empty(max(0, int(n_frames)), np.float32)
    if out.size == 0:
        return out
    got = _load().mt_decode_wav(str(path).encode(), int(start_frame), int(n_frames),
                                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if got < 0:
        raise ValueError(f"hostkit: decode failed for {path} (rc={got})")
    return out[:got]


def fill_roll(pitches, starts, ends, velocities, fs: float, n_cols: int) -> np.ndarray:
    """(128, n_cols) float64: each note's velocity added over the columns
    [int(start * fs), int(end * fs)), clipped to the roll."""
    pitches = np.ascontiguousarray(pitches, np.int32)
    starts = np.ascontiguousarray(starts, np.float64)
    ends = np.ascontiguousarray(ends, np.float64)
    velocities = np.ascontiguousarray(velocities, np.int32)
    roll = np.zeros((128, int(n_cols)), np.float64)
    _load().mt_fill_roll(len(pitches), pitches, starts, ends, velocities, float(fs),
                         int(n_cols), roll)
    return roll
