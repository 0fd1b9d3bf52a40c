"""The readings a cell's limits are set from: the program's numbers compared (``harness.NUMBERS``) over many seeds and the control's over a few.

    python3 bssbench/calibrate.py --workload <cell> --seeds 101-112 --control-seeds 201-203 [--seconds 3]

One process: each program seed is a whole run of the cell (its pool, the
warm-up, a short window at the cell's own load, the comparison); each
control seed puts the reference in the control precision (``"tf32"``, see
``bssbench/reference/common.py``) in the program's place on as many requests
as a run compares. Prints one JSON line a reading, then per number the
largest program reading (the lower end of a limit) and the smallest control
reading (the upper end). The benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def seeds(text: str):
    """``"101-112"`` or ``"5,9,11"``."""
    if "-" in text:
        lo, hi = map(int, text.split("-"))
        return list(range(lo, hi + 1))
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)

    from bssbench import harness, mixture

    cell = harness.Cell(ROOT, args.workload)
    program, control = [], []
    for seed in seeds(args.seeds):
        t0 = time.perf_counter()
        result, checks, _ = harness.run(cell, seed, args.seconds, False, args.device)
        program.append({name: checks[name]["value"] for name in harness.NUMBERS})
        print(json.dumps({"workload": args.workload, "side": "program", "seed": seed, **program[-1],
                          "calls": result["attempted"], "seconds": time.perf_counter() - t0}), flush=True)
    for seed in seeds(args.control_seeds):
        t0 = time.perf_counter()
        pool = mixture.make_pool(seed, cell.config, cell.traffic)
        indices = list(range(min(len(pool), int(cell.traffic["compare_calls"]))))
        control.append(harness.control_numbers(cell, pool, indices, args.device))
        print(json.dumps({"workload": args.workload, "side": "control", "seed": seed, **control[-1],
                          "seconds": time.perf_counter() - t0}), flush=True)
    for name in harness.NUMBERS:
        print(json.dumps({"workload": args.workload, "number": name,
                          "lower": max((r[name] for r in program), default=None),
                          "upper": min((r[name] for r in control if r[name] is not None), default=None)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
