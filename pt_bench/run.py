#!/usr/bin/env python3
"""The benchmark of the PyTorch + CUDA port on NVIDIA GPUs: one run of one
cell of ``BENCHMARK.json``.

    python3 pt_bench/run.py --workload NAME --seed N --seconds S --trace 0|1

It prints one JSON line as the last line of standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
a ``breakdown``, and last ``checks``, each number compared beside its
limit (also the last lines of standard error). Without a CUDA device, or
with fewer than the cell asks for, it exits 2 and prints no result; if
JAX or the JAX package was loaded, it exits 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# the checkout's root, not this script's directory, leads the import path
sys.path[0] = str(Path(__file__).resolve().parent.parent)

from pt_bench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"pt_bench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    with contextlib.redirect_stdout(sys.stderr):
        result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                             t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"pt_bench: the run loaded {found}", file=sys.stderr)
        return 3
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
