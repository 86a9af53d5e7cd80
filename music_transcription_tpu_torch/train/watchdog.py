"""Stall watchdog and host-memory recycling (standard library only), the
port's copy of the JAX package's ``train/watchdog.py``.

``StallWatchdog``: a daemon thread that force-exits the process with
``STALL_EXIT_CODE`` (66) when no train or validation step has completed for
``timeout_s`` seconds, so a supervisor (``until python -m
music_transcription_tpu_torch.train ... --resume auto; do :; done``)
restarts it from the last best-state flush instead of waiting on a process
that makes no progress. ``os._exit`` because a main thread blocked in a
device call never sees an exception.

``RECYCLE_EXIT_CODE`` (67): the training loop's planned exit when host RSS
passes ``TrainConfig.rss_watermark_gb`` at an epoch boundary, after writing
a full-resume checkpoint.
"""

from __future__ import annotations

import os
import sys
import threading
import time

# distinct from shell and timeout conventions (124, 137, 143)
STALL_EXIT_CODE = 66
RECYCLE_EXIT_CODE = 67


class StallWatchdog:
    """``beat()`` after every completed unit of device work. Until the first
    beat the limit is ``first_grace_factor`` times longer: a fresh process
    builds its kernels and warms up before step 1."""

    def __init__(self, timeout_s: float, context: str = "train step",
                 check_every_s: float = 5.0, first_grace_factor: float = 4.0,
                 _exit=os._exit):
        self.timeout_s = float(timeout_s)
        self.context = context
        self._check = float(check_every_s)
        self._grace = float(first_grace_factor)
        self._exit = _exit  # injectable for tests
        self._beaten = False
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True, name="stall-watchdog")
        self._thread.start()

    def beat(self) -> None:
        self._beaten = True
        self._last = time.monotonic()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2 * self._check)

    def _run(self) -> None:
        while not self._stop.wait(self._check):
            stale = time.monotonic() - self._last
            limit = self.timeout_s if self._beaten else self.timeout_s * self._grace
            if stale > limit:
                sys.stderr.write(
                    f"\n[stall-watchdog] no completed {self.context} for {stale:.0f}s "
                    f"(> {limit:.0f}s). Exiting {STALL_EXIT_CODE} so a supervisor can resume "
                    f"from the last best-state flush (see --save_best_every).\n")
                sys.stderr.flush()
                self._exit(STALL_EXIT_CODE)
                return  # only reached with an injected test exit


def host_rss_gb() -> float:
    """Resident-set size of this process in GB (0.0 where unreadable)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return float(line.split()[1]) / 1e6  # kB -> GB
    except OSError:
        pass
    return 0.0
