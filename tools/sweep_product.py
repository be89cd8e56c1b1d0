#!/usr/bin/env python3
"""Sweep the tile and pipeline of the product plan's two channel-grid
kernels on one GPU: K1c (`mxu32_cuda.fwd_multi_perchannel`, the Bounded
forward; one and two operand limbs) and K1d (`pointwise_inv_multi`, the
fused pointwise product and inverse), pass by pass, over the tile codes of
`mxu32_cuda.TILES` (csrc/matmod_pass.cuh `tile`: 0 = 128 x 32 on a ring of
three stages, not K1d's first pass; 1 = 64 x 16 holding up to four stages
whole; 2 = 128 x 32 holding up to four stages whole; 3 = 128 x 64 on a ring
of three, not K1c's first pass, n >= 2^12 where a pass has n1 outputs), at
n = 2^11, 2^13, 2^14, 2^15, 2^16, 2^17 with B = 16 (`--batches` takes
others) and at (2^14, 8) and (2^16, 8), over 2 and 3 channel primes.

Each code is forced by replacing the wrapper's choice
(`mxu32_cuda._k1_tiles`) for its calls, as a pair of codes for the two
passes, checked against the plain twin (exact), then timed: the device time
of each pass's launch a call from one torch.profiler session
(`utils/profiling.device_times`), median of 20. `mxu32_cuda.k1_tile`
holds the rule this sweep picked; the summary lines give, per pass, the
fastest code beside the rule's. Run from the repository root: `python3
tools/sweep_product.py`; `--sizes 14 16` restricts the sizes (log2 n; the B
= 8 rows come with 14 and 16) and `--channels 2` the channel counts. Prints
one line a shape, the card line (nvidia-smi's name and power limit) and a
last JSON line; exits non-zero without a CUDA GPU or on a parity failure.
Imports no JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
_spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(_ROOT, "chip_smoke.py"))
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)
from concrete_ntt_tpu_torch.utils.profiling import device_times  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", type=int, nargs="*", default=[11, 13, 14, 15, 16, 17],
                    help="log2 n of the --batches rows (default 11 13 14 15 16 17; 2^14, 2^16 also at B = 8)")
    ap.add_argument("--channels", type=int, nargs="*", default=[2, 3])
    ap.add_argument("--batches", type=int, nargs="*", default=[16],
                    help="B of the --sizes rows (default 16)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sweep_product: torch.cuda.is_available() is False; this run needs a CUDA GPU",
              file=sys.stderr)
        return 1
    from concrete_ntt_tpu_torch.ops import cuda_build, mxu32_cuda as m
    from concrete_ntt_tpu_torch.tables import NATIVE64_PRIMES, primes32_ext

    cuda_build.load("mxu32_multi")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip()
    rng = np.random.default_rng(3)
    u32 = lambda shape: torch.from_numpy(  # noqa: E731
        rng.integers(0, 1 << 32, shape, dtype=np.uint32)).to(dev)
    rule = m._k1_tiles
    shapes = [(1 << k, b) for k in args.sizes for b in args.batches] + [
        (1 << k, 8) for k in (14, 16) if k in args.sizes]
    tasks, bad, chosen, timed = [], [], {}, set()

    def forced(fn, codes):
        def call():
            m._k1_tiles = lambda *a: codes
            return fn()
        return call

    for n, b in shapes:
        for c in args.channels:
            primes = tuple((NATIVE64_PRIMES if n <= 1 << 15 else primes32_ext())[:c])
            scales = tuple(pow(n, p - 2, p) * pow(2, 32, p) % p for p in primes)
            xs = (u32((c, b, n)), u32((c, b, n)))
            shape = f"n={n} B={b} C={c}"
            big = n >= 1 << 12  # code 3 on the column passes: n1 >= 64 outputs
            kernels = [
                (f"K1c 1 limb {shape}", "fwd", 1,
                 lambda xs=xs, primes=primes: m.fwd_multi_perchannel(xs[0], primes),
                 m.fwd_multi_perchannel_plain(xs[:1], primes),
                 ((0, 0), (1, 1), (2, 2)) + ((0, 3),) * big),
                (f"K1c 2 limbs {shape}", "fwd", 2,
                 lambda xs=xs, primes=primes: m.fwd_wide_multi_perchannel(*xs, primes),
                 m.fwd_multi_perchannel_plain(xs, primes),
                 ((0, 0), (1, 1), (2, 2)) + ((0, 3),) * big),
                (f"K1d {shape}", "inv", 1,
                 lambda xs=xs, primes=primes, scales=scales: m.pointwise_inv_multi(
                     *xs, primes, scales),
                 m.pointwise_inv_multi_plain(*xs, primes, scales),
                 ((1, 1), (2, 2), (3, 0)) + ((3, 3),) * big),
            ]
            for label, direction, limbs, fn, want, forcings in kernels:
                chosen[label] = rule(b, n, c, limbs, direction)
                for codes in forcings:
                    call = forced(fn, codes)
                    if not torch.equal(call(), want):
                        bad.append(f"{label} codes {codes}")
                    for i in range(2):
                        if (label, i, codes[i]) not in timed:  # else timed with another pair
                            timed.add((label, i, codes[i]))
                            tasks.append(((label, i, codes[i]),
                                          lambda call=call: (call, cs.is_pass), 2, i))
    times = device_times(tasks)
    m._k1_tiles = rule
    fmt = lambda v: "not measured" if v is None else f"{v:.4f} ms"  # noqa: E731
    best = {}
    for (label, i, code), v in times.items():
        print(f"sweep_product: {label} pass {i + 1} code {code} {m.TILES[code]}: device "
              f"{fmt(v)} (torch.profiler, median of {cs.REPS}) | {smi}", flush=True)
        if v is not None and v < best.get((label, i), (None, float("inf")))[1]:
            best[(label, i)] = (code, v)
    for (label, i), (code, v) in best.items():
        print(f"sweep_product: {label} pass {i + 1}: fastest code {code} ({v:.4f} ms), the rule's "
              f"{chosen[label][i]} ({fmt(times[(label, i, chosen[label][i])])})", flush=True)
    print(f"sweep_product: parity failures: {bad or 'none'}")
    print(smi)
    print(json.dumps({"device_ms": {f"{k[0]} pass {k[1] + 1} code {k[2]}": v
                                    for k, v in times.items()},
                      "rule": {k: list(v) for k, v in chosen.items()},
                      "parity_failures": bad}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
