#!/usr/bin/env python3
"""The readings a cell's limits are set from, on the chip: for each seed a
run of the cell at its own size with a short window, the numbers the
program gives and those of the control, the plain reference in bfloat16
put in the program's place, on the same window's answers. The benchmark's
own runs never run the control.

    python3 pt_bench/control.py --workload NAME --seconds S --seeds N [N ...] [--fault F]

One JSON line per seed, then the largest program reading and the
smallest control reading of each number. With ``--fault`` the program
runs with that fault planted (``faults.py``) and no control is read.
"""

import argparse
import contextlib
import json
import sys
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parent.parent)

from pt_bench import faults, harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", choices=faults.NAMES, help="plant this fault in the program")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("pt_bench: the readings are taken on a CUDA device", file=sys.stderr)
        return 2
    lower, upper = {}, {}
    for seed in args.seeds:
        hook, undo = faults.plant(args.fault) if args.fault else (None, lambda: None)
        try:
            with contextlib.redirect_stdout(sys.stderr):
                r = harness.run(args.workload, seed, args.seconds, False, traffic_hook=hook,
                                control=not args.fault)
        finally:
            undo()
        program = r.get("readings") or {k: v["value"] for k, v in r["checks"].items()}
        control = r.get("control", {})
        print(json.dumps({"seed": seed, "fault": args.fault, "correct": r["correct"],
                          "program": program, "control": control}), flush=True)
        for k, v in program.items():
            lower[k] = max(lower.get(k, v), v)
        for k, v in control.items():
            upper[k] = min(upper.get(k, v), v)
    print(json.dumps({"workload": args.workload, "fault": args.fault, "seeds": len(args.seeds),
                      "program_max": lower, "control_min": upper}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
