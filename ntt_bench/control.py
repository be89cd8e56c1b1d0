#!/usr/bin/env python3
"""The control of the benchmark's check, on the card at a cell's own size.

    python3 ntt_bench/control.py --workload <cell> --seeds 1 2 3 [--seconds 2]

For each seed it runs the cell as `run.py` does, with the entry's float64
reference (`reference/float64.py`) in the port's place for a short window,
and prints one JSON line with the numbers the check compared. `correct` has
to come out false on every seed: the check can fail. The benchmark's own
runs never run this.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control(work) -> None:
    """The entry's float64 reference in the port's place."""
    work.port_call = work.control_call


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    from ntt_bench import harness, spec

    cell = spec.load(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        r = harness.run_cell(cell, seed, args.seconds, False, "cuda", time.perf_counter(), patch=control)
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": r["correct"],
                          "attempted": r["attempted"], "checks": r["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
