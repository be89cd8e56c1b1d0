#!/usr/bin/env python3
"""Time the native64 Plan32 lift kernel (`ops/crt_cuda.py`, `csrc/crt_lift.cu`)
on the card beside its plain twin, the int64 chain of `ops/crt.py`.

At each (B, n) of --shapes (default the north-star cell's (256, 2^14) and
the smoke run's (8, 2^14)), on canonical residues from a fixed seed: the
kernel checked against its plain twin bit for bit, then
  * device ms: the kernel's launch, and the plain twin's operations summed,
    a call (one torch.profiler session, median of --reps calls,
    `utils/profiling.device_times`);
  * wrapper ms: one call by CUDA events, median of --reps (host dispatch
    included);
  * the bound: 28 bytes a coefficient (five u32 residues read, two u32 limbs
    written) at 3.35 TB/s, and the kernel's device share of it.
One line a shape, the card's name and power limit first, a JSON line last.

Usage: python3 tools/time_lift.py [--shapes 256:14 8:14] [--reps 20]
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", nargs="+", default=["256:14", "8:14"],
                    help="B:log2(n) pairs")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_lift: needs a CUDA GPU", file=sys.stderr)
        return 2
    from concrete_ntt_tpu_torch.ops import crt_cuda
    from concrete_ntt_tpu_torch.tables import native_channel_primes
    from concrete_ntt_tpu_torch.utils.profiling import HBM_BYTES_PER_S, device_times

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", "0"], capture_output=True, text=True).stdout.strip()
    print(f"# {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | torch {torch.__version__}",
          flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(2025)
    cases = []
    for spec in args.shapes:
        b, log2n = (int(v) for v in spec.split(":"))
        n = 1 << log2n
        primes = native_channel_primes(5, n)
        res = torch.stack([torch.randint(0, p, (b, n), generator=gen, device=dev,
                                         dtype=torch.int64) for p in primes]).to(torch.int32)
        res = res.view(torch.uint32)
        got, want = crt_cuda.rec_u64_from5(res, primes), crt_cuda.rec_u64_from5_plain(res, primes)
        torch.cuda.synchronize()
        if not all(torch.equal(g.view(torch.int32), w.view(torch.int32))
                   for g, w in zip(got, want)):
            print(f"FAIL lift_u64_from5 [{b}, {n}] differs from its plain twin", flush=True)
            return 1
        cases.append((b, n, primes, res))
    tasks = []
    for i, (b, n, primes, res) in enumerate(cases):
        tasks.append(((i, "kernel"), lambda res=res, primes=primes: (
            lambda: crt_cuda.rec_u64_from5(res, primes), lambda name: "lift_u64_from5" in name), 1))
        tasks.append(((i, "plain"), lambda res=res, primes=primes: (
            lambda: crt_cuda.rec_u64_from5_plain(res, primes), lambda name: True), None))
    dev_ms = device_times(tasks, args.reps)
    rows = []
    for i, (b, n, primes, res) in enumerate(cases):
        bound = 1e3 * 28 * b * n / HBM_BYTES_PER_S
        k_dev, p_dev = dev_ms[(i, "kernel")], dev_ms[(i, "plain")]
        row = {"B": b, "n": n, "bytes": 28 * b * n, "bound_ms": bound,
               "kernel_device_ms": k_dev, "plain_device_ms": p_dev,
               "kernel_ms": event_ms(lambda: crt_cuda.rec_u64_from5(res, primes), args.reps),
               "plain_ms": event_ms(lambda: crt_cuda.rec_u64_from5_plain(res, primes), args.reps),
               "share_of_bound_pct": 100 * bound / k_dev if k_dev else None}
        rows.append(row)
        dev_txt = (f"kernel {k_dev:.4f} ms ({row['share_of_bound_pct']:.1f} % of the bound)"
                   if k_dev else "kernel not measured")
        plain_txt = f"plain {p_dev:.4f} ms" if p_dev else "plain not measured"
        print(f"lift_u64_from5 [{b}, {n}] == plain twin; device: {dev_txt}, {plain_txt}; "
              f"wrapper (CUDA events, median of {args.reps}): kernel {row['kernel_ms']:.4f} ms, "
              f"plain {row['plain_ms']:.4f} ms; bound {bound:.6f} ms ({row['bytes']} B at "
              f"3.35 TB/s) | {smi}", flush=True)
    print(json.dumps({"lift_u64_from5": rows, "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
