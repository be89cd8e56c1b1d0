#!/usr/bin/env python3
"""Time prime32.Plan's two kernels, K2 (the single-prime four-step) and K4
(the butterfly stages), and the prime32 polymul, of the port checkout in the
current directory on one GPU.

Rows, at batch 16:
  * K2 fwd / inv (`mxu32_cuda.fwd` / `inv`, unscaled) at n in 2^11, 2^12,
    2^14, 2^15, 2^16, in lt30 (four matrix digit planes) and with a generic
    prime near 2^32 (five): the wrapper's CUDA-event median of 20 calls, the
    device time of its `matmod_pass` launches a call, and `torch._int_mm` on
    int8 matrices of the same two passes' shapes (the yardstick of the
    mainloop, which the port never calls);
  * K1a / K1b at (2^14, 8) over five channels, the same three numbers (their
    tiles are K1's own: the check that they did not move);
  * the prime32 transform of K4's tier, `ntt_dispatch.fwd32` / `inv32`, at
    (1024, 16) lt30, (2^14, 16) with p = 67043329 and (2^16, 16), (2^17, 16)
    with a prime below 2^26: the wrapper's median and the device time of all
    kernels of a call, beside the tier the checkout routes it to ("K4", or
    "stage" where a checkout's K4 ends at 2^15: the stage engine in plain
    torch);
  * `prime32.Plan.negacyclic_polymul` at (2^14, 16) lt30 and at (2^16, 16)
    with a prime below 2^26: min / median / max of 20 calls.

Device times come from one torch.profiler session
(`utils/profiling.device_times`; the other helpers from `chip_smoke.py` of
this script's own checkout; the package, kernels and wrappers from the
current directory), beside nvidia-smi's card name and
power limit. So an A/B of two checkouts on one card runs it from each in
turns, in one call:

    for d in parent change change parent; do (cd $d && python3 /abs/tools/ab_prime32.py); done

Prints one line a row, then the card line and a last JSON line {"rows":
{key: {...}}, "port": <checkout>}. Exits non-zero without a CUDA GPU.
Imports no JAX.
"""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())  # the checkout under test: its package, kernels, wrappers
# chip_smoke.py of this script's checkout (the current directory may hold another one)
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                               "chip_smoke.py"))
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)
from concrete_ntt_tpu_torch.utils.profiling import device_times  # noqa: E402

B = 16
LT30, GEN5 = 1073479681, 4293918721  # 2^18 | p - 1; four and five matrix digit planes
SMALL_P = 67043329                  # < 2^26, 2^16 | p - 1
K2_SIZES = (1 << 11, 1 << 12, 1 << 14, 1 << 15, 1 << 16)


def polymul_stats(fn, reps: int = cs.REPS) -> tuple:
    """(min, median, max) ms of fn() by CUDA events after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return min(times), statistics.median(times), max(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("ab_prime32: torch.cuda.is_available() is False; this run needs a CUDA GPU",
              file=sys.stderr)
        return 1
    from concrete_ntt_tpu_torch import prime32
    from concrete_ntt_tpu_torch.ops import cuda_build, mxu32, mxu32_cuda, ntt_dispatch
    from concrete_ntt_tpu_torch.tables import NATIVE64_PRIMES as PRIMES
    from concrete_ntt_tpu_torch.utils.prime import (
        largest_prime_in_arithmetic_progression64 as prime_in_ap)

    for name in ("mxu32_multi", "mxu32_pass", "butterfly32"):
        cuda_build.load(name)
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip()
    rng = np.random.default_rng(2024)
    u32 = lambda shape, hi=1 << 32: torch.from_numpy(  # noqa: E731
        rng.integers(0, hi, shape, dtype=np.uint32)).to(dev)
    small18 = prime_in_ap(1 << 18, 1, 0, 1 << 26)

    rows, tasks, labels = {}, [], {}

    def gemm_row(key, label, kernel, pairs):
        rows[key] = {"ms": cs.median_ms(kernel)}
        labels[key] = label
        tasks.append(((key, "device_ms"), lambda: (kernel, cs.is_pass), 2))

        def gemm():
            mats = pairs()
            return (lambda: [torch._int_mm(a, b) for a, b in mats]), cs.is_kernel

        tasks.append(((key, "gemm_ms"), gemm, None))

    for rname, p in (("lt30", LT30), ("generic5", GEN5)):
        n_d = mxu32._n_dplanes32(p)
        for n in K2_SIZES:
            n1, n2 = mxu32.four_step_factors(n)
            x = u32((B, n))
            for d, fn in (("fwd", mxu32_cuda.fwd), ("inv", mxu32_cuda.inv)):
                gemm_row(f"K2-{d}-{rname}-{n}", f"K2 {d} n={n} B={B} p={p} ({n_d} planes)",
                         cs.bind_now(lambda fn=fn: fn(x, n=n, p=p)),
                         cs.bind_now(lambda d=d: cs.gemm_pairs(dev, d, n1, n2, B, 1, 4, n_d)))
    n, b = 1 << 14, 8
    n1, n2 = mxu32.four_step_factors(n)
    limbs = (u32((b, n)), u32((b, n)))
    xm = u32((len(PRIMES), b, n))
    scaled = tuple(pow(n, q - 2, q) * pow(2, 32, q) % q for q in PRIMES)
    gemm_row("K1a-16384", f"K1a fwd_wide_multi n={n} B={b} C=5 2 limbs",
             lambda: mxu32_cuda.fwd_wide_multi(limbs, PRIMES),
             lambda: cs.gemm_pairs(dev, "fwd", n1, n2, b, len(PRIMES), 8))
    gemm_row("K1b-16384", f"K1b inv_multi n={n} B={b} C=5 scaled",
             lambda: mxu32_cuda.inv_multi(xm, PRIMES, scaled),
             lambda: cs.gemm_pairs(dev, "inv", n1, n2, b, len(PRIMES), 4))

    for n, p in ((1024, LT30), (1 << 14, SMALL_P), (1 << 16, small18), (1 << 17, small18)):
        plan = prime32.Plan.new(n, p)
        kw = dict(p=p, variant=plan.variant, p_neginv=plan.p_neginv)
        x = u32((B, n), p)
        tier = ntt_dispatch.tier32(n, p, plan.variant)
        for d, fn in (("fwd", ntt_dispatch.fwd32), ("inv", ntt_dispatch.inv32)):
            key = f"K4tier-{d}-{n}"
            kernel = cs.bind_now(lambda fn=fn: fn(x, plan._tbl, **kw))
            rows[key] = {"ms": cs.median_ms(kernel), "tier": tier}
            labels[key] = f"prime32 {d} tier {tier} n={n} B={B} p={p}"
            tasks.append(((key, "device_ms"), lambda kernel=kernel: (kernel, cs.is_kernel), None))

    for n, p, label in ((1 << 14, LT30, "lt30"), (1 << 16, small18, "p<2^26")):
        plan = prime32.Plan.new(n, p)
        a, c = u32((B, n), p), u32((B, n), p)
        lo, med, hi = polymul_stats(lambda: plan.negacyclic_polymul(a, c))
        key = f"polymul-{n}"
        rows[key] = {"min_ms": lo, "ms": med, "max_ms": hi,
                     "tier": ntt_dispatch.tier32(n, p, plan.variant)}
        labels[key] = f"prime32 polymul n={n} B={B} p={p} ({label})"

    prof = device_times(tasks)
    for (key, what), v in prof.items():
        rows[key][what] = v
    fmt = lambda v: "not measured" if v is None else f"{v:.4f} ms"  # noqa: E731
    for key, r in rows.items():
        extra = "".join(f", {k} {fmt(r[k])}" for k in ("device_ms", "gemm_ms") if k in r)
        if "min_ms" in r:
            extra = f", min {r['min_ms']:.4f} ms, max {r['max_ms']:.4f} ms"
        tier = f" [tier {r['tier']}]" if "tier" in r else ""
        print(f"ab_prime32: {key} ({labels[key]}){tier}: wrapper {r['ms']:.4f} ms{extra} "
              f"(median of {cs.REPS}) | {smi}", flush=True)
    print(smi)
    print(json.dumps({"rows": rows, "port": os.getcwd()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
