#!/usr/bin/env python3
"""Time the product plan's two channel-grid kernels, K1c (the Bounded
forward) and K1d (the fused pointwise product and inverse), the kernels
that share their GEMM pass, and the product plan's polymuls, of the port
checkout in the current directory on one GPU.

Rows:
  * K1c (`mxu32_cuda.fwd_multi_perchannel`, one and two operand limbs) and
    K1d (`pointwise_inv_multi`, scaled by n^-1 2^32) at (n, B, channels) in
    (2^11, 16, 2), (2^14, 16, 2), (2^14, 16, 3), (2^16, 8, 2), (2^16, 8, 3),
    (2^17, 16, 2): the wrapper's CUDA-event median of 20 calls, the device
    time of its `matmod_pass` launches a call, and `torch._int_mm` on int8
    matrices of the same two passes' shapes (the yardstick of the mainloop,
    which the port never calls);
  * the same three numbers for K1a / K1b at (2^14, 8) over five channels,
    K2 fwd / inv at (2^14, 16) lt30 and K3's A pass at (4096, 16): kernels
    whose instances K1c / K1d's tiles leave alone;
  * `product.Plan(2^14, f1·f2).negacyclic_polymul` at B = 16 in Replace and
    Bounded (b = 2^20) and the 16-term PBS loop (a Bounded fwd and a
    mul_accumulate a term against preloaded NTT-domain operands, one
    inv(ACCUMULATE)): min / median / max of 20 calls by CUDA events.

Device times come from one torch.profiler session
(`utils/profiling.device_times`; the other helpers from `chip_smoke.py` of
this script's own checkout; the package, kernels and wrappers from the
current directory), beside nvidia-smi's card name and
power limit. So an A/B of two checkouts on one card runs it from each in
turns, in one call:

    for d in parent change change parent; do (cd $d && python3 /abs/tools/ab_product.py); done

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

K1CD_SHAPES = ((1 << 11, 16, 2), (1 << 14, 16, 2), (1 << 14, 16, 3), (1 << 16, 8, 2),
               (1 << 16, 8, 3), (1 << 17, 16, 2))
LT30 = 1073479681
N_PROD, B_PROD, PBS_TERMS = 1 << 14, 16, 16


def stats(fn, reps: int = cs.REPS) -> tuple:
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
        print("ab_product: torch.cuda.is_available() is False; this run needs a CUDA GPU",
              file=sys.stderr)
        return 1
    from concrete_ntt_tpu_torch import product
    from concrete_ntt_tpu_torch.ops import cuda_build, mxu32, mxu32_cuda as m
    from concrete_ntt_tpu_torch.tables import NATIVE64_PRIMES as PRIMES
    from concrete_ntt_tpu_torch.tables import primes32_ext

    for name in ("mxu32_multi", "mxu32_pass"):
        cuda_build.load(name)
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip()
    rng = np.random.default_rng(2024)
    u32 = lambda shape: torch.from_numpy(  # noqa: E731
        rng.integers(0, 1 << 32, shape, dtype=np.uint32)).to(dev)
    scale32 = lambda n, p: pow(n, p - 2, p) * pow(2, 32, p) % p  # noqa: E731

    rows, tasks, labels = {}, [], {}

    def gemm_row(key, label, kernel, pairs):
        rows[key] = {"ms": cs.median_ms(kernel)}
        labels[key] = label
        tasks.append(((key, "device_ms"), lambda: (kernel, cs.is_pass), 2))

        def gemm():
            mats = pairs()
            return (lambda: [torch._int_mm(a, b) for a, b in mats]), cs.is_kernel

        tasks.append(((key, "gemm_ms"), gemm, None))

    for n, b, c in K1CD_SHAPES:
        n1, n2 = mxu32.four_step_factors(n)
        primes = tuple((PRIMES if n <= 1 << 15 else primes32_ext())[:c])
        scales = tuple(scale32(n, p) for p in primes)
        xs = (u32((c, b, n)), u32((c, b, n)))
        shape = f"n={n} B={b} C={c}"
        for key, label, kernel, direction, e1 in (
                ("K1c", "K1c fwd_multi_perchannel 1 limb",
                 lambda: m.fwd_multi_perchannel(xs[0], primes), "fwd", 4),
                ("K1c2", "K1c fwd_multi_perchannel 2 limbs",
                 lambda: m.fwd_wide_multi_perchannel(*xs, primes), "fwd", 8),
                ("K1d", "K1d pointwise_inv_multi scaled",
                 lambda: m.pointwise_inv_multi(*xs, primes, scales), "inv", 4)):
            gemm_row(f"{key}-{n}-{b}-{c}", f"{label} {shape}", cs.bind_now(kernel),
                     cs.bind_now(lambda direction=direction, e1=e1: cs.gemm_pairs(
                         dev, direction, n1, n2, b, c, e1)))

    n, b = 1 << 14, 8
    n1, n2 = mxu32.four_step_factors(n)
    limbs = (u32((b, n)), u32((b, n)))
    xm = u32((len(PRIMES), b, n))
    scaled = tuple(scale32(n, q) for q in PRIMES)
    gemm_row("K1a-16384", f"K1a fwd_wide_multi n={n} B={b} C=5 2 limbs",
             lambda: m.fwd_wide_multi(limbs, PRIMES),
             lambda: cs.gemm_pairs(dev, "fwd", n1, n2, b, len(PRIMES), 8))
    gemm_row("K1b-16384", f"K1b inv_multi n={n} B={b} C=5 scaled",
             lambda: m.inv_multi(xm, PRIMES, scaled),
             lambda: cs.gemm_pairs(dev, "inv", n1, n2, b, len(PRIMES), 4))
    x16 = u32((16, n))
    for d, fn in (("fwd", m.fwd), ("inv", m.inv)):
        gemm_row(f"K2-{d}-16384", f"K2 {d} n={n} B=16 p={LT30}",
                 cs.bind_now(lambda fn=fn: fn(x16, n=n, p=LT30)),
                 cs.bind_now(lambda d=d: cs.gemm_pairs(dev, d, n1, n2, 16, 1, 4)))
    tbl = mxu32._mxu_tables(4096, LT30)
    n1k, n2k = tbl["n1"], tbl["n2"]
    xa = u32((16, n2k, n1k))
    k3 = dict(n=4096, p=LT30, which="A",
              diag_slices=tuple(torch.from_numpy(a).to(dev) for a in tbl["d"]))
    rows["K3-A-4096"] = {"ms": cs.median_ms(lambda: m.pass_matmod(xa, **k3))}
    labels["K3-A-4096"] = f"K3 pass_matmod A scaled n=4096 B=16 p={LT30}"
    tasks.append((("K3-A-4096", "device_ms"), lambda: (lambda: m.pass_matmod(xa, **k3),
                                                       cs.is_pass), 1))

    def k3_gemm():
        mats = cs.gemm_pairs(dev, "fwd", n1k, n2k, 16, 1, 4, passes=1)
        return (lambda: [torch._int_mm(a, c) for a, c in mats]), cs.is_kernel

    tasks.append((("K3-A-4096", "gemm_ms"), k3_gemm, None))

    f1, f2 = PRIMES[0], PRIMES[1]
    plan = product.Plan.new(N_PROD, f1 * f2, (f1, f2))
    mod = plan.modulus
    card = lambda v: cs.u64_limbs(v).to(dev)  # noqa: E731
    pa, pb, pacc = (card(cs.rand_mod(rng, mod, (B_PROD, N_PROD))) for _ in range(3))
    px = card(cs.centred(rng, mod, (B_PROD, N_PROD)))
    keys = [plan.normalize(plan.fwd(card(cs.rand_mod(rng, mod, (B_PROD, N_PROD)))))
            for _ in range(PBS_TERMS)]
    digits = [card(cs.centred(rng, mod, (B_PROD, N_PROD))) for _ in range(PBS_TERMS)]
    bnd, acc = product.bounded(cs.BOUND), product.ACCUMULATE

    def pbs_loop():
        dom = product.NttDomain(torch.zeros((2, B_PROD, N_PROD), dtype=torch.uint32,
                                            device=dev))
        for d, key in zip(digits, keys):
            dom = plan.mul_accumulate(dom, plan.fwd(d, bnd), key)
        return plan.inv(dom, mode=acc, standard=pacc)

    for key, label, fn in (
            ("polymul-Replace", f"product polymul Replace n={N_PROD} B={B_PROD} ({f1}·{f2})",
             lambda: plan.negacyclic_polymul(pa, pb)),
            ("polymul-Bounded", f"product polymul Bounded b={cs.BOUND} n={N_PROD} B={B_PROD}",
             lambda: plan.negacyclic_polymul(px, pb, mode=acc, standard=pacc, lhs_fwd_mode=bnd)),
            ("PBS-loop", f"PBS loop of {PBS_TERMS} terms n={N_PROD} B={B_PROD}", pbs_loop)):
        lo, med, hi = stats(fn)
        rows[key] = {"min_ms": lo, "ms": med, "max_ms": hi}
        labels[key] = label

    prof = device_times(tasks)
    for (key, what), v in prof.items():
        rows[key][what] = v
    fmt = lambda v: "not measured" if v is None else f"{v:.4f} ms"  # noqa: E731
    for key, r in rows.items():
        extra = "".join(f", {k} {fmt(r[k])}" for k in ("device_ms", "gemm_ms") if k in r)
        if "min_ms" in r:
            extra = f", min {r['min_ms']:.4f} ms, max {r['max_ms']:.4f} ms"
        print(f"ab_product: {key} ({labels[key]}): wrapper {r['ms']:.4f} ms{extra} "
              f"(median of {cs.REPS}) | {smi}", flush=True)
    print(smi)
    print(json.dumps({"rows": rows, "port": os.getcwd()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
