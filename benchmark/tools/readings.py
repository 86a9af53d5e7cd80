"""Readings of a cell's compared numbers over many seeds in one process, the
measurements its limits are set from.

    python3 benchmark/tools/readings.py --workload <name> --mode program --seeds 1 2 3 ...
    python3 benchmark/tools/readings.py --workload <name> --mode control --seeds ...
    python3 benchmark/tools/readings.py --workload <name> --mode fault:half_batch --seeds ...

``program`` runs the cell (a window of ``--seconds``) and judges it as a run
does; ``control`` puts the reference computed one precision below the
configuration's (``--precision``, float8 for bfloat16) in the program's
place; ``fault:<name>`` runs the cell with the program broken underneath
(the generators' faults). One JSON line a seed, and a summary.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark.common import registry  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--mode", default="program")
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--precision", default="float8")
    args = p.parse_args()
    registry.pin_caches(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = registry.cell(registry.load_benchmark(ROOT), args.workload, ROOT)
    generator = cell.generator()
    rows = []
    for seed in args.seeds:
        t = time.perf_counter()
        if args.mode == "control":
            got = generator.control(cell, seed=seed, device=device, precision=args.precision)
        else:
            fault = args.mode.split(":", 1)[1] if args.mode.startswith("fault:") else None
            outcome, _, _ = generator.run(cell, seed=seed, seconds=args.seconds, trace=False,
                                       device=device, t_start=t, fault=fault)
            got = outcome.readings
        rows.append(got)
        print(json.dumps({"workload": args.workload, "mode": args.mode, "seed": seed,
                          "readings": got, "seconds": time.perf_counter() - t}), flush=True)
        torch.cuda.empty_cache()
    for k in rows[0]:
        vals = [r[k] for r in rows]
        print(f"{args.workload} {args.mode} {k}: min {min(vals)!r} max {max(vals)!r} "
              f"over {len(vals)} seeds", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
