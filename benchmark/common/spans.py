"""The device time of a profiled stretch, put down to the program's spans.

The port opens a span where each layer's work is launched
(``music_transcription_tpu_torch/tracing.py``: ``train.*``, ``model.*``,
``data.gather``), on the profiler's clock. Each device event of the stretch
(a kernel, a copy or a set, as ``device.Trace`` counts them) is given one
span:

  * its launch is the runtime call (``cudaLaunchKernel``,
    ``cudaMemcpyAsync``, ``cuLaunchKernel``, ...) with the event's
    correlation id;
  * a launch inside an autograd node's ``autograd::engine::evaluate_function``
    operation is backward work: the node's sequence number leads to the
    forward operation that recorded it (on the forward's thread), and the
    event takes the innermost program span, on any thread, that holds that
    operation's start. A node no forward operation recorded
    (``AccumulateGrad``) leaves the event where its launch lies, in
    ``train.backward``;
  * any other launch takes the innermost program span, on any thread, that
    holds its start.

An event whose launch is not in the stretch, or lies in no program span,
is unattributed. ``Split`` holds the device seconds by span.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

PREFIXES = ("train.", "model.", "data.")
BACKWARD_OP = "autograd::engine::evaluate_function: "
STEP = "train.step"

# the metrics that read the split: the spans whose device time each sums
METRIC_SPANS = {
    "cnn_ms.train": ("model.cnn",),
    "rnn_ms.train": ("model.rnn",),
    "attention_ms.train": ("model.attention",),
    "heads_ms.train": ("model.heads", "train.loss"),
    "update_ms.train": ("train.clip", "train.update"),
    "gather_ms.train": ("data.gather",),
}
# the spans whose device time is not counted as attributed: backward nodes
# with no forward operation, and the step's own launches outside every phase
REMAINDER = ("train.backward", STEP)


def _is_device(e) -> bool:
    from torch.autograd import DeviceType

    return e.device_type() == DeviceType.CUDA


def _is_annotation(e) -> bool:
    return getattr(e, "is_user_annotation", lambda: False)()


def _is_runtime(e) -> bool:
    """A CUDA runtime or driver call (torch 2.11's events have no
    ``activity_type``; the calls' names are the API's)."""
    return e.name().startswith("cu")


@dataclass
class Split:
    """Device seconds of the stretch by program span."""

    seconds: dict[str, float] = field(default_factory=dict)
    unattributed: float = 0.0
    total: float = 0.0  # every device event's time, summed
    steps: int = 0  # ``train.step`` spans in the stretch
    kernels: dict[str, dict[str, float]] = field(default_factory=dict)  # span -> name -> s

    def ms_per_step(self, *names: str) -> float | None:
        """The device ms a step of ``names`` together, None when the stretch
        has none of them."""
        if not self.steps or not any(n in self.seconds for n in names):
            return None
        return 1e3 * sum(self.seconds.get(n, 0.0) for n in names) / self.steps

    def attributed_share(self) -> float:
        """The share of the summed device time given to a program span other
        than ``REMAINDER``."""
        if self.total <= 0:
            return 0.0
        kept = sum(s for n, s in self.seconds.items() if n not in REMAINDER)
        return kept / self.total

    def line(self) -> str:
        """One line: device ms a step by span, the unattributed remainder,
        and each as a share of the summed device time."""
        steps = max(self.steps, 1)
        total = self.total or 1.0
        parts = [f"{n} {1e3 * s / steps:.3f} ms ({100 * s / total:.2f}%)"
                 for n, s in sorted(self.seconds.items(), key=lambda kv: -kv[1])]
        parts.append(f"unattributed {1e3 * self.unattributed / steps:.3f} ms "
                     f"({100 * self.unattributed / total:.2f}%)")
        return (f"device time a step by program span over {self.steps} steps: "
                + ", ".join(parts)
                + f"; attributed outside {'/'.join(REMAINDER)}: "
                  f"{100 * self.attributed_share():.2f}%")

    def top_kernels(self, n: int = 12) -> dict[str, list]:
        """Each span's ``n`` device operations of most time, in ms a step."""
        steps = max(self.steps, 1)
        return {span: [[k[:120], 1e3 * s / steps] for k, s in
                       sorted(by.items(), key=lambda kv: -kv[1])[:n]]
                for span, by in self.kernels.items()}


class Attribution:
    """The program's spans and the host's launches of one profile, to put a
    device event or a host operation down to a span."""

    def __init__(self, events):
        events = list(events)
        host = [e for e in events if not _is_device(e)]
        self.device = [e for e in events if _is_device(e) and not _is_annotation(e)]
        spans = sorted((e for e in host if e.name().startswith(PREFIXES)),
                       key=lambda e: e.start_ns())
        self.span_names = [e.name() for e in spans]
        self.s_start = np.array([e.start_ns() for e in spans], np.int64)
        self.s_end = np.array([e.start_ns() + e.duration_ns() for e in spans], np.int64)
        self.runtime = {e.correlation_id(): e for e in host if _is_runtime(e)}
        ops = [e for e in host if not _is_runtime(e) and not _is_annotation(e)]
        self.backward: dict[int, tuple[np.ndarray, np.ndarray, list]] = {}
        nodes: dict[int, list] = {}
        for e in ops:
            if e.name().startswith(BACKWARD_OP):
                nodes.setdefault(e.start_thread_id(), []).append(e)
        for thread, held in nodes.items():
            held.sort(key=lambda e: e.start_ns())
            self.backward[thread] = (np.array([e.start_ns() for e in held], np.int64),
                                     np.array([e.start_ns() + e.duration_ns() for e in held],
                                              np.int64), held)
        # An operation records the sequence number the next autograd node will
        # take, and the counter moves on once a node is made: of the forward
        # operations with a number, the last to start made the node.
        self.forward: dict[tuple[int, int], int] = {}
        for e in ops:
            if e.sequence_nr() < 0 or self.node_at(e.start_thread_id(), e.start_ns()) is not None:
                continue
            key = (e.start_thread_id(), e.sequence_nr())
            if e.start_ns() > self.forward.get(key, -1):
                self.forward[key] = e.start_ns()

    def innermost(self, t: int) -> str | None:
        """The innermost program span, on any thread, that holds ``t``."""
        inside = np.nonzero((self.s_start <= t) & (self.s_end >= t))[0]
        if not len(inside):
            return None
        return self.span_names[int(inside[np.argmax(self.s_start[inside])])]

    def node_at(self, thread: int, t: int):
        """The backward node's operation on ``thread`` that holds ``t``, or None."""
        if thread not in self.backward:
            return None
        starts, ends, ops = self.backward[thread]
        i = int(np.searchsorted(starts, t, side="right")) - 1
        return ops[i] if i >= 0 and ends[i] >= t else None

    def forward_start(self, node) -> int | None:
        """The start of the forward operation that recorded ``node``."""
        if node.sequence_nr() < 0:
            return None
        return self.forward.get((node.fwd_thread_id(), node.sequence_nr()))

    def span_of_launch(self, thread: int, t: int) -> str | None:
        node = self.node_at(thread, t)
        if node is not None:
            start = self.forward_start(node)
            if start is not None:
                return self.innermost(start)
        return self.innermost(t)

    def split(self) -> Split:
        out = Split(steps=self.span_names.count(STEP))
        for e in self.device:
            sec = e.duration_ns() / 1e9
            out.total += sec
            call = self.runtime.get(e.correlation_id())
            name = None if call is None else self.span_of_launch(call.start_thread_id(),
                                                                 call.start_ns())
            if name is None:
                out.unattributed += sec
            else:
                out.seconds[name] = out.seconds.get(name, 0.0) + sec
            by_name = out.kernels.setdefault(name or "unattributed", {})
            by_name[e.name()] = by_name.get(e.name(), 0.0) + sec
        return out


def split_profile(prof) -> Split:
    """The split of a finished ``torch.profiler.profile``."""
    return Attribution(prof.profiler.kineto_results.events()).split()
