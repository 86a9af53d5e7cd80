"""One run of one benchmark cell of the PyTorch/CUDA port on its card(s).

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell (``BENCHMARK.json``'s
``workloads``) names a configuration and a traffic mix; the mix names the
generator that builds the program's state from the seed, warms every shape the
traffic uses, runs the measured window for ``--seconds``, and judges what
the window produced against the plain reference (``reference/``) once it
has closed. With ``--trace 0`` the last line of standard output carries the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics, read
from a ``torch.profiler`` stretch inside the window. The numbers compared, each beside its limit, come last on standard
error and under ``checks`` in that line.

Exits 2, printing no result, when no card is visible (or fewer than the cell
asks for), and 4 when the process holds JAX, flax or the JAX package once
the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.common import registry, result  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, *, device=None, fault=None) -> int:
    """``device`` and ``fault`` are for the benchmark's own tests: a run on
    the CPU, and a program broken underneath the timed path."""
    args = parse(argv)
    registry.pin_caches(ROOT)
    cell = registry.cell(registry.load_benchmark(ROOT), args.workload, ROOT)
    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"error: {args.workload} needs {cell.chips} CUDA card(s); "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        from benchmark.common.device import card_line

        print(f"card: {card_line()}", file=sys.stderr, flush=True)
    outcome, device_info, breakdown = cell.generator().run(
        cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace), device=device,
        t_start=T_START, fault=fault)
    found = result.forbidden_modules()
    if found:
        print(f"error: the process holds {found} after the window", file=sys.stderr)
        return 4
    metrics = cell.read_metrics(cell.per_layer if args.trace else cell.end_to_end,
                                outcome.window)
    result.print_checks(outcome.checks)
    sys.stdout.flush()
    print(result.last_line(outcome, metrics, device_info, breakdown if args.trace else None),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
