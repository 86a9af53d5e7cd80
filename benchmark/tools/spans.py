"""One traced run of a training cell, with its device time put down to the
program's spans (``common/spans.py``).

    python3 benchmark/tools/spans.py --workload <name> --seed <n> [--seconds 10]

The run is a ``run.py --trace 1`` run: the same generator, stretch and
readers. ``device.Trace`` keeps each event's name and interval alone, so
this process also hands the stretch's profile to ``spans.split_profile``
before the trace is built from it. Prints on stderr the device time a step
by span, and one JSON line on stdout: the card, the cell's per-layer
metrics, the device ms a step of each layer (``spans.METRIC_SPANS``), the
share of the summed device time given to a span outside
``spans.REMAINDER``, and the rates of the traced stretch and of the rest
of the window (what tracing costs when on).
"""

import argparse
import json
import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark.common import registry, result, spans  # noqa: E402
from benchmark.common.device import Trace, card_line  # noqa: E402


def traced_run(cell, seed: int, seconds: float, device) -> dict:
    """One traced run of ``cell``: its outcome and the stretch's split."""
    got = []
    built = Trace.from_profile.__func__

    def from_profile(cls, prof, wall_s, span_names=()):
        got.append(spans.split_profile(prof))
        return built(cls, prof, wall_s, span_names)

    Trace.from_profile = classmethod(from_profile)
    try:
        outcome, _, _ = cell.generator().run(cell, seed=seed, seconds=seconds, trace=True,
                                             device=device, t_start=T_START)
    finally:
        Trace.from_profile = classmethod(built)
    w = outcome.window
    split = got[0] if got else None
    rest = w.seconds - w.traced_s
    return {
        "metrics": cell.read_metrics(cell.per_layer, w),
        "by_layer_ms": {m: split.ms_per_step(*names) if split else None
                        for m, names in spans.METRIC_SPANS.items()},
        "attributed_share": split.attributed_share() if split else None,
        "device_ms_a_step": 1e3 * split.total / split.steps if split and split.steps else None,
        "traced_steps": w.traced_steps, "span_steps": split.steps if split else 0,
        "traced_steps_per_s": w.traced_steps / w.traced_s if w.traced_s else None,
        "untraced_steps_per_s": (w.steps - w.traced_steps) / rest if rest > 0 else None,
        "correct": result.is_correct(outcome.checks) and outcome.failed == 0,
        "top_kernels": split.top_kernels() if split else None,
        "split": split.line() if split else None,
    }


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    args = p.parse_args()
    registry.pin_caches(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA card", file=sys.stderr)
        return 2
    cell = registry.cell(registry.load_benchmark(ROOT), args.workload, ROOT)
    line = traced_run(cell, args.seed, args.seconds, torch.device("cuda", 0))
    print(line.pop("split") or "error: the window held no traced stretch", file=sys.stderr,
          flush=True)
    print(json.dumps({"workload": args.workload, "seed": args.seed, "card": card_line(),
                      **line}), flush=True)
    return 0 if line["span_steps"] else 1


if __name__ == "__main__":
    sys.exit(main())
