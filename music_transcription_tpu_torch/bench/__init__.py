"""Microbenchmarks of the port's layers, the ports of the JAX package's
``scripts/bench_*.py``:

    python -m music_transcription_tpu_torch.bench.attention [--t 938 2048 4096] [--batch 2]
    python -m music_transcription_tpu_torch.bench.components [--batch_size 16]
    python -m music_transcription_tpu_torch.bench.train [--batch_size 16] [--steps 8]
    python -m music_transcription_tpu_torch.bench.loader --cache_dir CACHE [--no_device]

Each takes ``--device cuda`` (the default; exits 1 when no card is visible)
or ``cpu``. ``time_ms`` times a call with CUDA events on a card and with the
host clock on the CPU (each bench says which in its output); the JAX
scripts chained calls inside one compiled loop to hide a remote dispatch's
latency, which a local card does not have. ``kernel_launches`` reads the
hand-written kernels' launch counters, which the benches report.
"""

from __future__ import annotations

import time

import numpy as np

from music_transcription_tpu_torch.ops import attention_kernel as _ak
from music_transcription_tpu_torch.ops import lstm_kernel as _lk
from music_transcription_tpu_torch.ops import precision as _precision

# the hand-written kernels the benches reach, by the ids of the port's records
KERNELS = {
    "K1": _lk.lstm_recurrence,
    "K2a": _lk.lstm_recurrence_fwd,
    "K2b": _lk.lstm_recurrence_bwd,
    "K3": _ak.flash_attention_clamped,
    "K3+lse": _ak.flash_attention_clamped_fwd,
    "K4a": _ak.flash_attention_clamped_dq,
    "K4b": _ak.flash_attention_clamped_dkv,
    "split_bf16": _precision.split_bf16,
}


def kernel_launches() -> dict[str, int]:
    """Every kernel's launch counter as it stands."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def launches_since(before: dict[str, int], calls: int = 1) -> dict[str, float]:
    """The launches of each kernel since ``before`` (``kernel_launches()``),
    per call over ``calls`` calls; kernels that did not launch are left out."""
    now = kernel_launches()
    return {k: (now[k] - before[k]) / calls for k in now if now[k] != before[k]}


def cuda_unavailable(device: str) -> bool:
    """True (after printing the port's message) when ``device`` is cuda and
    no card is visible."""
    import torch

    if device == "cuda" and not torch.cuda.is_available():
        print("Error: CUDA is not available: no GPU is visible to PyTorch. "
              "Pass --device cpu to run on the CPU.")
        return True
    return False


def clock(device) -> str:
    """The name of what ``time_ms`` reads on ``device``."""
    import torch

    return "CUDA events" if torch.device(device).type == "cuda" else "host clock"


def time_ms(fn, device, iters: int, warmup: int = 1, chain: int = 1) -> tuple[float, int]:
    """The median over ``iters`` timed windows of one call of ``fn`` (ms),
    each window ``chain`` calls back to back over their count, after
    ``warmup`` untimed calls; and the number of calls made. On a card a
    window runs between two CUDA events on the current stream, with no host
    synchronization inside it; on the CPU the host clock times it."""
    import torch

    for _ in range(warmup):
        fn()
    if torch.device(device).type == "cuda":
        windows = []
        torch.cuda.synchronize(device)
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(chain):
                fn()
            end.record()
            windows.append((start, end))
        torch.cuda.synchronize(device)
        ms = [s.elapsed_time(e) / chain for s, e in windows]
    else:
        ms = []
        for _ in range(iters):
            t0 = time.perf_counter()
            for _ in range(chain):
                fn()
            ms.append((time.perf_counter() - t0) * 1e3 / chain)
    return float(np.median(ms)), warmup + iters * chain
