#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the card this process sees.

    python3 ntt_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. It sets up the cell named in BENCHMARK.json
(the port's plan, inputs and key made on the card from --seed, the cell's
shapes warmed), runs the closed loop for --seconds, checks a sample of the
outputs against the plain reference, and prints one JSON line last on
standard output: with --trace 0 the cell's end-to-end metrics, with
--trace 1 its per-layer metrics from one torch.profiler session. The
numbers compared, each with its limit, are the last lines on standard error
and the last key of the JSON line.

It exits 2, printing no result, without a CUDA card (or with fewer cards
than the cell asks for), and 3 if the JAX package or JAX is loaded once the
window has closed. Build caches stay inside the checkout.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "ntt_bench", "_cache")
PROGRAM = "concrete_ntt_tpu_torch"


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    # fixed cache directories inside the checkout, whatever the program builds
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    # one process with few threads: the calls run on the card, and idle CPU
    # worker pools only compete with the thread that dispatches them
    os.environ["OMP_NUM_THREADS"] = os.environ["MKL_NUM_THREADS"] = "1"
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    from ntt_bench import harness, spec

    importlib.import_module(PROGRAM)  # the system under test: no run without it
    cell = spec.load(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"run: the cell needs {cell.chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_PROCESS)
    found = harness.forbidden_modules()
    if found:
        print(f"run: modules of JAX or the JAX package are loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
