"""Set-up's phases, each timed on the host clock and printed on stderr."""

from __future__ import annotations

import sys
import time


class Phases:
    def __init__(self, t_start: float):
        self.last = t_start
        self.marks: list[tuple[str, float]] = []

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.marks.append((name, now - self.last))
        self.last = now

    def report(self) -> None:
        print("set-up phases (s): " + ", ".join(f"{n} {s:.2f}" for n, s in self.marks),
              file=sys.stderr, flush=True)
