#!/usr/bin/env python3
"""Sweep the launch shapes of prime32.Plan's two kernels on one GPU: K2's
tile per pass (`mxu32_cuda.TILES`: 128 x 32 and 64 x 16 rows x outputs) at
n = 2^11 .. 2^17, and K4's cluster size c (1, 2, 4, 8 blocks a polynomial,
2^8 .. 2^15 values a block) and round size (2 or 3 stages in registers, the
kernel's range) at n = 1024 .. 2^17, at batch 16 with the lt30 prime
1073479681 (K2) and a prime below 2^26 (K4).

Each shape is forced by replacing the wrapper's choice (`mxu32_cuda.k2_tile`,
`butterfly32_cuda.cluster_size` / `radix_log`) for its calls, checked
against the plain twin (exact), then timed: the device time of its kernel
launches a call from one torch.profiler session (the helpers of this
checkout's `chip_smoke.py`), median of 20. `mxu32_cuda.k2_tile` and
`butterfly32_cuda.cluster_size` / `radix_log` hold the rules this sweep
picked. Run from the repository root: `python3 tools/sweep_prime32.py`;
`--k2 14 15` and `--k4 14` restrict the sizes (log2 n) of each kernel's rows,
and an empty list (`--k4`) skips that kernel.
Prints one line a shape, the card line (nvidia-smi's name and power limit)
and a last JSON line; exits non-zero without a CUDA GPU or on a parity
failure. Imports no JAX.
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

B = 16
P_K2 = 1073479681


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--k2", type=int, nargs="*", default=list(range(11, 18)),
                    help="log2 n of K2's rows (default 11 .. 17)")
    ap.add_argument("--k4", type=int, nargs="*", default=[10, 11, 12, 14, 16, 17],
                    help="log2 n of K4's rows (default 10 11 12 14 16 17)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sweep_prime32: torch.cuda.is_available() is False; this run needs a CUDA GPU",
              file=sys.stderr)
        return 1
    from concrete_ntt_tpu_torch import prime32
    from concrete_ntt_tpu_torch.ops import butterfly32_cuda as bcu
    from concrete_ntt_tpu_torch.ops import cuda_build, mxu32_cuda
    from concrete_ntt_tpu_torch.utils.prime import (
        largest_prime_in_arithmetic_progression64 as prime_in_ap)

    for name in ("mxu32_pass", "butterfly32"):
        cuda_build.load(name)
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip()
    rng = np.random.default_rng(1)
    u32 = lambda shape, hi=1 << 32: torch.from_numpy(  # noqa: E731
        rng.integers(0, hi, shape, dtype=np.uint32)).to(dev)
    rules = (mxu32_cuda.k2_tile, bcu.cluster_size, bcu.radix_log)
    tasks, bad = [], []

    def k2_call(x, n, code, fn):
        def call():
            mxu32_cuda.k2_tile = lambda rows, outs: code
            mxu32_cuda._k2_launch.cache_clear()  # its records hold the tile of their first call
            return fn(x, n=n, p=P_K2)
        return call

    for n in (1 << k for k in args.k2):
        x = u32((B, n))
        for d, fn, plain in (("fwd", mxu32_cuda.fwd, mxu32_cuda.fwd_plain),
                             ("inv", mxu32_cuda.inv, mxu32_cuda.inv_plain)):
            want = plain(x, n=n, p=P_K2)
            for code in range(len(mxu32_cuda.TILES)):
                call = k2_call(x, n, code, fn)
                if not torch.equal(call(), want):
                    bad.append(f"K2 {d} n={n} tile {code}")
                tasks.append((f"K2 {d} n={n} tile {code} {mxu32_cuda.TILES[code]}",
                              lambda call=call: (call, cs.is_pass), 2))

    def k4_call(x, tbl, kw, c, r, fn):
        def call():
            bcu.cluster_size = lambda *a, **k: c
            bcu.radix_log = lambda e: r
            return fn(x, tbl, **kw)
        return call

    p_k4 = prime_in_ap(1 << 18, 1, 0, 1 << 26)
    for n in (1 << k for k in args.k4):
        plan = prime32.Plan.new(n, p_k4)
        kw = dict(p=p_k4, variant=plan.variant, p_neginv=plan.p_neginv)
        x = u32((B, n), p_k4)
        for d, fn, plain in (("fwd", bcu.try_fwd, bcu.fwd_plain),
                             ("inv", bcu.try_inv, bcu.inv_plain)):
            want = plain(x, plan._tbl, **kw)
            for c in (1, 2, 4, 8):
                if (c == 1 and n > 1 << 15) or (c > 1 and not 1 << 8 <= n // c <= 1 << 15):
                    continue
                for r in (2, 3):
                    call = k4_call(x, plan._tbl, kw, c, r, fn)
                    if not torch.equal(call(), want):
                        bad.append(f"K4 {d} n={n} c={c} rounds of {r}")
                    tasks.append((f"K4 {d} n={n} c={c} rounds of {r}",
                                  lambda call=call: (call, cs.is_k4), 1))
    times = cs.device_times(tasks)
    mxu32_cuda.k2_tile, bcu.cluster_size, bcu.radix_log = rules
    for key, v in times.items():
        print(f"sweep_prime32: {key} B={B}: device "
              f"{'not measured' if v is None else f'{v:.4f} ms'} (torch.profiler, median of "
              f"{cs.REPS}) | {smi}", flush=True)
    print(f"sweep_prime32: parity failures: {bad or 'none'}")
    print(smi)
    print(json.dumps({"device_ms": times, "parity_failures": bad}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
