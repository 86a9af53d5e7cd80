"""The card: its peaks, roofline bounds, and what a profiler trace says.

The peaks are NVIDIA's data-sheet figures for one H100 SXM at its full
power limit of 700 W (dense, no sparsity); ``card_line`` reads the card's
name and power limit, which every run prints beside its numbers.

The trace readings are copies of the program's own arithmetic in
``chip_smoke.py`` (``device_busy_union_ms``: the union of the device
intervals, so that a range annotated on the device counts its kernels once;
``device_time_by_kernel``: device time summed by name), here over a list of
events taken once from a ``torch.profiler`` run.
"""

from __future__ import annotations

import subprocess
from dataclasses import dataclass, field

import numpy as np

PEAK_BF16 = 989e12  # FLOP/s, dense tensor cores
PEAK_FP32 = 67e12  # FLOP/s, outside the tensor cores
PEAK_BYTES = 3.35e12  # B/s, HBM3


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi gave nothing"


def bound_s(flops: float, nbytes: float, peak: float) -> float:
    """The least time the card could take: operations over the peak rate or
    bytes over the memory's, whichever is longer."""
    return max(flops / peak, nbytes / PEAK_BYTES)


@dataclass
class Event:
    name: str
    start_ns: int
    end_ns: int


@dataclass
class Trace:
    """The device and host events of one profiled stretch."""

    device: list[Event] = field(default_factory=list)
    host: list[Event] = field(default_factory=list)  # CPU ops and annotations
    spans: list[Event] = field(default_factory=list)  # the harness's own annotations
    wall_s: float = 0.0

    @classmethod
    def from_profile(cls, prof, wall_s: float, span_names=()) -> "Trace":
        from torch.autograd import DeviceType

        trace = cls(wall_s=wall_s)
        names = set(span_names)
        for e in prof.profiler.kineto_results.events():
            ev = Event(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            if e.device_type() == DeviceType.CUDA:
                annotation = getattr(e, "is_user_annotation", lambda: False)()
                if not annotation and e.name() not in names:
                    trace.device.append(ev)
            elif e.name() in names:
                trace.spans.append(ev)
            else:
                trace.host.append(ev)
        return trace

    def busy_s(self) -> float:
        """The union of the device events' intervals, in seconds."""
        spans = sorted((e.start_ns, e.end_ns) for e in self.device)
        busy, end = 0, None
        for a, b in spans:
            if end is None or a > end:
                busy += b - a
                end = b
            elif b > end:
                busy += b - end
                end = b
        return busy / 1e9

    def seconds_by_name(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for e in self.device:
            out[e.name] = out.get(e.name, 0.0) + (e.end_ns - e.start_ns) / 1e9
        return out

    def seconds_matching(self, *parts: str) -> float:
        """Device seconds of the events whose name holds any of ``parts``."""
        return sum((e.end_ns - e.start_ns) / 1e9 for e in self.device
                   if any(p in e.name for p in parts))

    def idle_gaps(self) -> list[tuple[float, int, int]]:
        """The gaps between the device's busy intervals: (seconds, start,
        end), from the stretch's first host span or event to its last."""
        spans = sorted((e.start_ns, e.end_ns) for e in self.device)
        if not spans:
            return []
        edges = [e.start_ns for e in self.spans] or [spans[0][0]]
        first = min(min(edges), spans[0][0])
        last = max([e.end_ns for e in self.spans] + [max(b for _, b in spans)])
        gaps, end = [], first
        for a, b in spans:
            if a > end:
                gaps.append(((a - end) / 1e9, end, a))
            end = max(end, b)
        if last > end:
            gaps.append(((last - end) / 1e9, end, last))
        return gaps

    def breakdown(self, top: int = 10, looked_at: int = 500) -> dict:
        """The device operations that took most time, and the longest idle
        gaps (of the ``looked_at`` longest) summed by what the host was in:
        the harness's innermost span and the innermost host operation at the
        gap's middle."""
        ops = sorted(self.seconds_by_name().items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_gaps(), reverse=True)[:looked_at]
        by_what: dict[str, float] = {}
        if gaps:
            h_start = np.array([e.start_ns for e in self.host], np.int64)
            h_end = np.array([e.end_ns for e in self.host], np.int64)
            s_start = np.array([e.start_ns for e in self.spans], np.int64)
            s_end = np.array([e.end_ns for e in self.spans], np.int64)
            for sec, a, b in gaps:
                mid = (a + b) // 2
                what = [_innermost(self.spans, s_start, s_end, mid) or "harness",
                        _innermost(self.host, h_start, h_end, mid) or "no host op"]
                key = ": ".join(what)
                by_what[key] = by_what.get(key, 0.0) + sec
        idle = sorted(by_what.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:160], s] for n, s in ops],
                "idle_gaps": [[n[:160], s] for n, s in idle]}


def _innermost(events: list[Event], starts: np.ndarray, ends: np.ndarray, t: int) -> str | None:
    if not len(starts):
        return None
    inside = np.nonzero((starts <= t) & (ends >= t))[0]
    if not len(inside):
        return None
    return events[int(inside[np.argmax(starts[inside])])].name
