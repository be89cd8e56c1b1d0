#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (`concrete_ntt_tpu_torch`) on one GPU.

Drives the port's main path, `native64.Plan32(2^14).negacyclic_polymul` on
planar (lo, hi) uint32 limbs at batch 8, through the hand-written kernels
K1a (`fwd_wide_multi`) and K1b (`inv_multi`) of `csrc/mxu32_multi.cu`.

Phases, one line each, stopping with a non-zero exit at the first failure:
  1. device  — needs torch.cuda.is_available(); prints nvidia-smi's name and
               power limit.
  2. build   — compiles the kernels from the checkout's sources with nvcc.
  3. parity  — each kernel against its plain torch version on the card,
               exact equality, at (n, B) = (2^14, 8), (2^14, 5), (2^11, 3),
               (2^15, 2); K1a with 1 and 2 limbs, K1b unscaled and scaled.
  4. main    — three polymuls with fresh operands on the card; each equals
               the CPU plain path bit for bit, row 0 equals the numpy
               wrapping oracle, and the launch counters rise by exactly 2
               (K1a) and 1 (K1b) per call.
  5. times   — CUDA events, warm-up then the median of reps, at n = 2^14,
               B = 8: K1a, K1b, their plain versions, the whole polymul.
Then one JSON line per kernel summary, the nvidia-smi line, and last
`{"ok": true, "device": {...}}`.

Run from the repository root with no arguments: `python3 chip_smoke.py`.
Inputs come from numpy's default_rng(--seed); the script imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

N_MAIN, B_MAIN = 1 << 14, 8
REPS = 20
PARITY_SHAPES = ((1 << 14, 8), (1 << 14, 5), (1 << 11, 3), (1 << 15, 2))
SOURCE = "concrete_ntt_tpu_torch/csrc/mxu32_multi.cu"
REPLACES = {
    "fwd_wide_multi": "concrete_ntt_tpu/ops/mxu32_pallas.py:367",
    "inv_multi": "concrete_ntt_tpu/ops/mxu32_pallas.py:398",
}


class PhaseError(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def median_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    """Median device time of fn() over `reps` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=2024)
    args = ap.parse_args()

    # -- 1. device ------------------------------------------------------------
    if not torch.cuda.is_available():
        print("device: torch.cuda.is_available() is False; this run needs a CUDA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from concrete_ntt_tpu_torch import native64
    from concrete_ntt_tpu_torch.golden.polymul import negacyclic_convolution_wrapping_np
    from concrete_ntt_tpu_torch.ops import cuda_build, mxu32_cuda
    from concrete_ntt_tpu_torch.ops.u32 import limbs_to_np_u64, to_i64
    from concrete_ntt_tpu_torch.tables import NATIVE64_PRIMES as PRIMES

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | count {torch.cuda.device_count()}", flush=True)

    # -- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    so = cuda_build.build("mxu32_multi")
    mxu32_cuda._lib()
    with open(so[:-3] + ".log") as f:
        ptxas = [ln.strip() for ln in f if "registers" in ln or "Compiling entry" in ln]
    print(f"build: {os.path.relpath(so)} in {time.perf_counter() - t0:.1f} s; "
          + " | ".join(ptxas), flush=True)

    # -- 3. parity --------------------------------------------------------------
    rng = np.random.default_rng(args.seed)
    u32 = lambda shape: torch.from_numpy(
        rng.integers(0, 1 << 32, shape, dtype=np.uint32)).to(dev)
    max_err = {"fwd_wide_multi": 0, "inv_multi": 0}

    def compare(name: str, got, want, what: str) -> None:
        torch.cuda.synchronize()
        err = int((to_i64(got) - to_i64(want)).abs().max().item())
        max_err[name] = max(max_err[name], err)
        require(got.shape == want.shape and err == 0,
                f"parity: {name} {what} differs from its plain version (max |err| {err})")

    t0 = time.perf_counter()
    checks = 0
    for n, b in PARITY_SHAPES:
        limbs = (u32((b, n)), u32((b, n)))
        for nl in (1, 2):
            compare("fwd_wide_multi", mxu32_cuda.fwd_wide_multi(limbs[:nl], PRIMES),
                    mxu32_cuda.fwd_wide_multi_plain(limbs[:nl], PRIMES),
                    f"n={n} B={b} limbs={nl}")
            checks += 1
        x = u32((len(PRIMES), b, n))
        scaled = tuple(pow(n, p - 2, p) * pow(2, 32, p) % p for p in PRIMES)
        for scales in ((1,) * len(PRIMES), scaled):
            compare("inv_multi", mxu32_cuda.inv_multi(x, PRIMES, scales),
                    mxu32_cuda.inv_multi_plain(x, PRIMES, scales),
                    f"n={n} B={b} scaled={scales != (1,) * len(PRIMES)}")
            checks += 1
    print(f"parity: {checks} kernel-vs-plain checks exact at (n, B) in {PARITY_SHAPES} "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)

    # -- 4. main path -----------------------------------------------------------
    plan = native64.Plan32.try_new(N_MAIN)
    operands = [
        tuple(rng.integers(0, 1 << 64, (B_MAIN, N_MAIN), dtype=np.uint64) for _ in range(2))
        for _ in range(3)
    ]
    planar = lambda a: (
        torch.from_numpy((a & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
        torch.from_numpy((a >> np.uint64(32)).astype(np.uint32)),
    )
    on_card = [tuple(tuple(t.to(dev) for t in planar(a)) for a in pair) for pair in operands]
    torch.cuda.synchronize()
    mxu32_cuda.reset_launch_counts()
    outs = []
    for lhs, rhs in on_card:
        before = dict(mxu32_cuda.LAUNCHES)
        outs.append(plan.negacyclic_polymul(lhs, rhs))
        require(mxu32_cuda.LAUNCHES["fwd_wide_multi"] - before["fwd_wide_multi"] == 2
                and mxu32_cuda.LAUNCHES["inv_multi"] - before["inv_multi"] == 1,
                f"main: launch counts moved {before} -> {mxu32_cuda.LAUNCHES}")
    torch.cuda.synchronize()
    launches = dict(mxu32_cuda.LAUNCHES)
    for i, ((a, b), out) in enumerate(zip(operands, outs)):
        got = limbs_to_np_u64(torch.stack([o.cpu() for o in out], dim=-1).numpy())
        cpu = plan.negacyclic_polymul(planar(a), planar(b))
        want = limbs_to_np_u64(torch.stack(cpu, dim=-1).numpy())
        require(got.shape == (B_MAIN, N_MAIN) and np.array_equal(got, want),
                f"main: call {i} differs from the CPU plain path")
        require(np.array_equal(got[0], negacyclic_convolution_wrapping_np(a[0], b[0])),
                f"main: call {i} row 0 differs from the numpy wrapping oracle")
    print(f"main: 3 x Plan32({N_MAIN}).negacyclic_polymul B={B_MAIN} on {kind} == CPU plain "
          f"path == numpy oracle (row 0); launches {launches}", flush=True)

    # -- 5. times -----------------------------------------------------------------
    limbs = (u32((B_MAIN, N_MAIN)), u32((B_MAIN, N_MAIN)))
    x = u32((len(PRIMES), B_MAIN, N_MAIN))
    scaled = tuple(pow(N_MAIN, p - 2, p) * pow(2, 32, p) % p for p in PRIMES)
    ms = {
        "fwd_wide_multi": median_ms(lambda: mxu32_cuda.fwd_wide_multi(limbs, PRIMES)),
        "inv_multi": median_ms(lambda: mxu32_cuda.inv_multi(x, PRIMES, scaled)),
    }
    plain_ms = {
        "fwd_wide_multi": median_ms(lambda: mxu32_cuda.fwd_wide_multi_plain(limbs, PRIMES)),
        "inv_multi": median_ms(lambda: mxu32_cuda.inv_multi_plain(x, PRIMES, scaled)),
    }
    lhs, rhs = on_card[0]
    poly_ms = median_ms(lambda: plan.negacyclic_polymul(lhs, rhs))
    shape = {"fwd_wide_multi": "2 limbs", "inv_multi": "scaled"}
    for k in ms:
        print(f"times: {k} n={N_MAIN} B={B_MAIN} {shape[k]}: kernel {ms[k]:.4f} ms, "
              f"plain {plain_ms[k]:.4f} ms (median of {REPS}) | {smi}", flush=True)
    print(f"times: polymul n={N_MAIN} B={B_MAIN} planar: {poly_ms:.4f} ms (median of {REPS}) = "
          f"{B_MAIN / poly_ms * 1e3:.1f} products/s | {smi}", flush=True)

    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCE, "replaces": REPLACES[k],
         "launches": launches[k], "max_abs_err": max_err[k], "ms": ms[k],
         "plain_ms": plain_ms[k]}
        for k in ("fwd_wide_multi", "inv_multi")
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
