"""What a run hands its metric readers, and the run's last line."""

from __future__ import annotations

import json
import math
import sys
from dataclasses import dataclass, field

from benchmark.common.device import Trace

# top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "music_transcription_tpu")
KEYS = ("correct", "attempted", "failed", "metrics", "device", "breakdown", "checks")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, the part before the first dot,
    is one of ``FORBIDDEN``, compared whole."""
    return sorted({n for n in list(sys.modules) if n.split(".", 1)[0] in FORBIDDEN})


@dataclass
class Window:
    """One run's measured window, as the metric readers see it."""

    model: dict  # the configuration's model fields
    reference: object  # its reference module: work counts
    frames: int  # frames of a chunk
    chunk_s: float
    setup_s: float = 0.0
    seconds: float = 0.0  # the window's length
    peak_bytes: int = 0  # the card's allocator peak over the window
    batch: int = 0  # training rows a step
    steps: int = 0  # training steps completed in the window
    trace: Trace | None = None  # the profiled stretch (--trace 1)
    traced_steps: int = 0
    traced_s: float = 0.0  # the stretch's wall time, inside the window


@dataclass
class Outcome:
    window: Window
    attempted: int
    failed: int
    checks: dict[str, tuple[float, float]]  # number -> (reading, limit)
    readings: dict = field(default_factory=dict)  # every number the run worked out


def is_correct(checks: dict) -> bool:
    return bool(checks) and all(math.isfinite(v) and v <= lim for v, lim in checks.values())


def last_line(outcome: Outcome, metrics: dict, device: dict, breakdown: dict | None) -> str:
    line = {"correct": is_correct(outcome.checks) and outcome.failed == 0,
            "attempted": outcome.attempted, "failed": outcome.failed,
            "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in outcome.checks.items()}
    return json.dumps(line)


def print_checks(checks: dict) -> None:
    """Each number compared beside its limit, the last lines on stderr."""
    for k, (v, lim) in checks.items():
        verdict = "ok" if math.isfinite(v) and v <= lim else "FAILS"
        print(f"check {k}: {v!r} limit {lim!r} {verdict}", file=sys.stderr, flush=True)
