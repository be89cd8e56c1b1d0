#!/usr/bin/env python3
"""Time the native Plan32 lift kernels (`ops/crt_cuda.py`: native64's
`csrc/crt_lift.cu`, native128's two launches in `csrc/crt_lift128.cu`) and the
Plan32 polymul's pointwise product (`ops/pointwise_cuda.py`,
`csrc/mont32_pointwise.cu`) on the card beside their plain twins, the int64
chains of `ops/crt.py` and `ops/u32.py` mont_mul.

At each (B, n) of --shapes (native64 by default: the north-star cell's
(256, 2^14) and the smoke run's (8, 2^14); native128: the cell's (64, 2^16),
(8, 2^16) and (16, 2^17); the product over native64's five channels or
native128's ten at the same shapes), on canonical residues (the lifts) or
full-range words (the product) from a fixed seed: the kernels checked
against their plain twin bit for bit, then
  * device ms: each kernel launch of a call, and the plain twin's
    operations summed (one torch.profiler session, median of --reps calls,
    `utils/profiling.device_times`);
  * wrapper ms: one call by CUDA events, median of --reps (host dispatch
    included);
  * the bound of each launch: its bytes at 3.35 TB/s (native64: 28 a
    coefficient, five u32 residues read and two u32 limbs written;
    native128's digits: 80, ten u32 residues read and five u64 digits
    written; its limbs: 56, the digits read and four u32 limbs written;
    the product: 12 a coefficient and channel, two u32 operands read and
    one u32 written), and the launch's device share of it.
One line a shape, the card's name and power limit first, a JSON line last.

Usage: python3 tools/time_lift.py [--lift u64|u128|mont32|mont32x10] [--shapes 256:14 8:14]
       [--reps 20]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402


def event_ms(fn, reps: int) -> float:
    """Median ms of fn() by CUDA events, after three warm-up calls."""
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
    return statistics.median(times)


# the kernels: channels, wrapper and twin names in ops/crt_cuda.py (the
# lifts) or ops/pointwise_cuda.py (the product), each launch's kernel name and
# bytes a coefficient, default shapes (B:log2 n)
LIFTS = {
    "u64": (5, "rec_u64_from5", (("lift_u64_from5", 28),), ["256:14", "8:14"]),
    "u128": (10, "rec_u128_from10", (("lift_u128_digits", 80), ("lift_u128_limbs", 56)),
             ["64:16", "8:16", "16:17"]),
    "mont32": (5, "mont_mul32", (("mont32_pointwise", 60),), ["256:14", "8:14"]),
    "mont32x10": (10, "mont_mul32", (("mont32_pointwise", 120),), ["64:16", "8:16", "16:17"]),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lift", choices=sorted(LIFTS), default="u64")
    ap.add_argument("--shapes", nargs="+", help="B:log2(n) pairs")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_lift: needs a CUDA GPU", file=sys.stderr)
        return 2
    from concrete_ntt_tpu_torch.ops import crt_cuda, pointwise_cuda
    from concrete_ntt_tpu_torch.tables import native_channel_primes
    from concrete_ntt_tpu_torch.utils.profiling import HBM_BYTES_PER_S, device_times

    channels, wrapper, launches, shapes = LIFTS[args.lift]
    module = pointwise_cuda if args.lift.startswith("mont32") else crt_cuda
    kern, twin = getattr(module, wrapper), getattr(module, wrapper + "_plain")
    if module is crt_cuda:
        lift, plain = kern, twin
    else:  # the product's operands come as one pair
        lift = lambda ops, primes: kern(*ops, primes)
        plain = lambda ops, primes: twin(*ops, primes)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", "0"], capture_output=True, text=True).stdout.strip()
    print(f"# {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | torch {torch.__version__}",
          flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(2025)
    cases = []
    for spec in args.shapes or shapes:
        b, log2n = (int(v) for v in spec.split(":"))
        n = 1 << log2n
        primes = native_channel_primes(channels, n)
        if module is crt_cuda:
            res = torch.stack([torch.randint(0, p, (b, n), generator=gen, device=dev,
                                             dtype=torch.int64) for p in primes]).to(torch.int32)
            res = res.view(torch.uint32)
        else:
            res = tuple(torch.randint(-(1 << 31), 1 << 31, (channels, b, n), generator=gen,
                                      device=dev, dtype=torch.int32).view(torch.uint32)
                        for _ in range(2))
        got, want = lift(res, primes), plain(res, primes)
        torch.cuda.synchronize()
        if module is pointwise_cuda:
            got, want = (got,), (want,)
        if not all(torch.equal(g.view(torch.int32), w.view(torch.int32))
                   for g, w in zip(got, want)):
            print(f"FAIL {wrapper} [{b}, {n}] differs from its plain twin", flush=True)
            return 1
        cases.append((b, n, primes, res))
    names = tuple(name for name, _ in launches)
    tasks = []
    for i, (b, n, primes, res) in enumerate(cases):
        call = lambda res=res, primes=primes: lift(res, primes)
        ours = lambda ev: any(m in ev for m in names)
        for k, name in enumerate(names):
            tasks.append(((i, name), lambda call=call: (call, ours), len(names), k))
        tasks.append(((i, "plain"), lambda res=res, primes=primes: (
            lambda: plain(res, primes), lambda ev: True), None))
    dev_ms = device_times(tasks, args.reps)
    rows = []
    for i, (b, n, primes, res) in enumerate(cases):
        row = {"B": b, "n": n, "plain_device_ms": dev_ms[(i, "plain")],
               "kernel_ms": event_ms(lambda: lift(res, primes), args.reps),
               "plain_ms": event_ms(lambda: plain(res, primes), args.reps), "launches": []}
        parts = []
        for name, per in launches:
            bound = 1e3 * per * b * n / HBM_BYTES_PER_S
            ms = dev_ms[(i, name)]
            row["launches"].append({"name": name, "bytes": per * b * n, "bound_ms": bound,
                                    "device_ms": ms,
                                    "share_of_bound_pct": 100 * bound / ms if ms else None})
            parts.append(f"{name} {ms:.4f} ms ({100 * bound / ms:.1f} % of its bound "
                         f"{bound:.6f} ms, {per * b * n} B)" if ms else f"{name} not measured")
        rows.append(row)
        p_dev = row["plain_device_ms"]
        plain_txt = f"plain {p_dev:.4f} ms" if p_dev else "plain not measured"
        print(f"{wrapper} [{b}, {n}] == plain twin; device: {', '.join(parts)}, {plain_txt}; "
              f"wrapper (CUDA events, median of {args.reps}): kernels {row['kernel_ms']:.4f} ms, "
              f"plain {row['plain_ms']:.4f} ms; bounds at 3.35 TB/s | {smi}", flush=True)
    print(json.dumps({wrapper: rows, "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
