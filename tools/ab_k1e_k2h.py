#!/usr/bin/env python3
"""Time K1e (the presplit inverse, `mxu32_cuda.inv_multi_presplit`) and K2
with block tables (K2h, `mxu32_cuda.fwd_hyb` / `inv_hyb`, the 32-bit
stage-split hybrid's blocks) of the port checkout in the current directory
on one GPU, beside the direct kernels their rows are compared with.

Rows (default, the A/B set):
  * K1e and K1b at (n, B, C) = (2^14, 8, 5) and (2^14, 16, 2), in turns
    (K1b, K1e, K1e, K1b): wrapper ms (CUDA-event median of 20), the device
    time of their `matmod_pass` launches a call, `torch._int_mm` on int8
    matrices of the same two passes' shapes;
  * K2h fwd / inv (scaled) at (2^16, 16), (2^16, 1), (2^17, 16), (2^17, 1),
    n_h = 2^14, lt30: the same three numbers;
  * the route kernels at their PERF.md section 6 shapes, device time (the
    check that they did not move): K1a (2^14, 8, 5 ch, 2 limbs), K1b (2^14,
    8, 5 ch), K1c / K1d (2^14, 16, 2 ch), K2 fwd / inv (2^14, 16) lt30 and
    K3's channel grid (the native64 rank-local F pass);
  * `stagesplit.engine32_fused` fwd / inv against the direct K2 at (2^16,
    16), (2^17, 16), (2^16, 1): dispatch-free ms (`utils/profiling.py`
    `chain_time`, CUDA graphs) and the eager CUDA-event median. A reading
    only: no route takes the 32-bit hybrid, as in the reference's 'auto'.

`--sweep` (this checkout: forces codes through `mxu32_cuda._k1e_tiles` and
`k2h_tiles`): every tile code of each pass of K1e at n = 2^14, B in (1, 8,
16), C in (2, 3, 5, 10), and of K2h at n in (2^16, 2^17), B in (1, 4, 16),
in the four regimes the hybrid takes (lt30, lt31, a generic prime with four
digit planes, one with five), each pass's code forced with the other pass
at the rule's. Each forced launch is held against the rule's result
(itself held against the plain version once a shape): exact, or the script
fails. Then each pass's device time (one torch.profiler session, median of
10) and, per pass, the fastest code beside the rule's.

Device times come from one torch.profiler session
(`utils/profiling.device_times`; the other helpers from `chip_smoke.py` of
this script's own checkout; the package, kernels and wrappers from the
current directory), beside nvidia-smi's card name and
power limit. An A/B of two checkouts on one card runs the default set from
each in turns, in one call:

    for d in parent change change parent; do (cd $d && python3 /abs/tools/ab_k1e_k2h.py); done

Prints one line a row, then the card line and a last JSON line. Exits
non-zero without a CUDA GPU or on a parity failure. Imports no JAX.
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

sys.path.insert(0, os.getcwd())  # the checkout under test: its package, kernels, wrappers
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(_ROOT, "chip_smoke.py"))
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)
from concrete_ntt_tpu_torch.utils.profiling import device_times  # noqa: E402

N14, N16, N17, N_H = 1 << 14, 1 << 16, 1 << 17, 1 << 14
LT30 = 1073479681  # 2^18 | p - 1: the hybrid's primes take n up to 2^17
K1E_AB = ((N14, 8, 5), (N14, 16, 2))
K2H_AB = ((N16, 16), (N16, 1), (N17, 16), (N17, 1))
K1E_SWEEP = tuple((N14, b, c) for b in (1, 8, 16) for c in (2, 3, 5, 10))
K2H_SWEEP = tuple((n, b) for n in (N16, N17) for b in (1, 4, 16))
SWEEP_REPS = 10


def regimes32() -> dict:
    """The four prime regimes the 32-bit hybrid takes, 2^18 | p - 1."""
    from concrete_ntt_tpu_torch.utils.prime import (
        largest_prime_in_arithmetic_progression64 as prime_in_ap)

    return {"lt30": prime_in_ap(1 << 18, 1, 1 << 29, 1 << 30),
            "lt31": prime_in_ap(1 << 18, 1, 1 << 30, 1 << 31),
            "generic4": prime_in_ap(1 << 18, 1, 1 << 31, 3 << 30),
            "generic5": prime_in_ap(1 << 18, 1, 1 << 31, 1 << 32)}


def scale32(n: int, p: int) -> int:
    return pow(n, p - 2, p) * pow(2, 32, p) % p


def k1e_primes(c: int) -> tuple:
    from concrete_ntt_tpu_torch.tables import NATIVE64_PRIMES, NATIVE128_PRIMES

    return tuple((NATIVE64_PRIMES if c <= 5 else NATIVE128_PRIMES)[:c])


def ab_rows(dev, u32, smi: str) -> dict:
    """The default set: K1e beside K1b, K2h, the route kernels, the hybrid
    engine beside direct K2."""
    from concrete_ntt_tpu_torch.ops import mxu32, mxu32_cuda as m, stagesplit
    from concrete_ntt_tpu_torch.tables import NATIVE64_PRIMES as PRIMES
    from concrete_ntt_tpu_torch.utils import profiling

    rows, labels, tasks = {}, {}, []

    def gemm_row(key, label, kernel, pairs, per_call=2, ms=True):
        kernel, pairs = cs.bind_now(kernel), cs.bind_now(pairs)
        rows[key] = {"ms": cs.median_ms(kernel)} if ms else {}
        labels[key] = label
        tasks.append(((key, "device_ms"), lambda: (kernel, cs.is_pass), per_call))

        def gemm():
            mats = pairs()
            return (lambda: [torch._int_mm(a, b) for a, b in mats]), cs.is_kernel

        tasks.append(((key, "gemm_ms"), gemm, None))

    for n, b, c in K1E_AB:
        n1, n2 = mxu32.four_step_factors(n)
        pr = k1e_primes(c)
        sc = tuple(scale32(n, p) for p in pr)
        x = u32((c, b, n))
        xd = m.digit_planes32(x)
        cs.require(torch.equal(m.inv_multi_presplit(xd, pr, sc), m.inv_multi(x, pr, sc)),
                   f"ab: K1e != K1b at n={n} B={b} C={c}")
        k1b = lambda x=x, pr=pr, sc=sc: m.inv_multi(x, pr, sc)  # noqa: E731
        k1e = lambda xd=xd, pr=pr, sc=sc: m.inv_multi_presplit(xd, pr, sc)  # noqa: E731
        turns = [cs.median_ms(fn) for fn in (k1b, k1e, k1e, k1b)]
        pairs = lambda b=b, c=c, n1=n1, n2=n2: cs.gemm_pairs(dev, "inv", n1, n2, b, c, 4)  # noqa
        for key, fn, t in ((f"K1b-{n}-{b}-{c}", k1b, turns[0::3]),
                           (f"K1e-{n}-{b}-{c}", k1e, turns[1:3])):
            gemm_row(key, f"{key[:3]} n={n} B={b} C={c} scaled", fn, pairs, ms=False)
            rows[key] = {"ms": min(t), "turns_ms": t}

    p = LT30
    for n, b in K2H_AB:
        n1, n2 = mxu32.four_step_factors(N_H)
        x = u32((b, n))
        s = scale32(n, p)
        cs.require(torch.equal(m.fwd_hyb(x, n=n, p=p, n_h=N_H),
                               m.fwd_hyb_plain(x, n=n, p=p, n_h=N_H)),
                   f"ab: K2h fwd != plain at n={n} B={b}")
        for d, fn in (("fwd", lambda x=x, n=n: m.fwd_hyb(x, n=n, p=p, n_h=N_H)),
                      ("inv", lambda x=x, n=n, s=s: m.inv_hyb(x, n=n, p=p, n_h=N_H, scale=s))):
            gemm_row(f"K2h-{d}-{n}-{b}", f"K2h {d} n={n} n_h={N_H} B={b} p={p} (lt30)", fn,
                     lambda d=d, b=b, n=n: cs.gemm_pairs(dev, d, n1, n2, b, 1, 4, nb=n // N_H))

    # the route kernels at their PERF.md section 6 shapes
    n1, n2 = mxu32.four_step_factors(N14)
    limbs = (u32((8, N14)), u32((8, N14)))
    x5 = u32((5, 8, N14))
    sc5 = tuple(scale32(N14, q) for q in PRIMES)
    x2 = (u32((2, 16, N14)), u32((2, 16, N14)))
    sc2 = sc5[:2]
    x16 = u32((16, N14))
    route = (
        ("K1a", lambda: m.fwd_wide_multi(limbs, PRIMES), ("fwd", 8, 5, 8)),
        ("K1b", lambda: m.inv_multi(x5, PRIMES, sc5), ("inv", 8, 5, 4)),
        ("K1c", lambda: m.fwd_multi_perchannel(x2[0], PRIMES[:2]), ("fwd", 16, 2, 4)),
        ("K1d", lambda: m.pointwise_inv_multi(*x2, PRIMES[:2], sc2), ("inv", 16, 2, 4)),
        ("K2-fwd", lambda: m.fwd(x16, n=N14, p=LT30), ("fwd", 16, 1, 4)),
        ("K2-inv", lambda: m.inv(x16, n=N14, p=LT30, scale=scale32(N14, LT30)),
         ("inv", 16, 1, 4)),
    )
    for key, fn, (d, b, c, e1) in route:
        gemm_row(f"route-{key}", f"{key} n={N14} B={b} C={c}", fn,
                 lambda d=d, b=b, c=c, e1=e1: cs.gemm_pairs(dev, d, n1, n2, b, c, e1))
    # K3's channel grid: an F pass over two channels, [C, B, n1, n2] contracting n2
    xf = u32((2, 4, n1, n2))
    gemm_row("route-K3", f"K3 pass_matmod_multi F n={N14} C=2 [4, {n1}, {n2}]",
             lambda: m.pass_matmod_multi(xf, n=N14, primes=PRIMES[:2], which="F"),
             lambda: [(torch.randint(-128, 128, (4 * n1, 4 * n2), dtype=torch.int8, device=dev),
                       torch.randint(-128, 128, (4 * n2, 4 * n2), dtype=torch.int8,
                                     device=dev).t()) for _ in range(2)], per_call=1)

    for key, v in device_times(tasks).items():
        rows[key[0]][key[1]] = v

    # the 32-bit hybrid beside the direct K2: dispatch-free and eager
    for n, b in ((N16, 16), (N17, 16), (N16, 1)):
        x = u32((b, n), LT30)
        s = scale32(n, LT30)
        for d, hyb, direct in (
                ("fwd", lambda t: (stagesplit.engine32_fused.fwd(t[0], n=n, p=LT30),),
                 lambda t: (m.fwd(t[0], n=n, p=LT30),)),
                ("inv", lambda t: (stagesplit.engine32_fused.inv(t[0], n=n, p=LT30, scale=s),),
                 lambda t: (m.inv(t[0], n=n, p=LT30, scale=s),))):
            cs.require(torch.equal(hyb((x,))[0], direct((x,))[0]),
                       f"ab: engine32_fused.{d} != direct K2 at n={n} B={b}")
            key = f"hybrid-{d}-{n}-{b}"
            r = {}
            for name, step in (("direct", direct), ("hybrid", hyb)):
                r[name + "_chain_ms"] = profiling.chain_time(step, (x,), length=32) * 1e3
                r[name + "_eager_ms"] = cs.median_ms(lambda step=step: step((x,)))
            rows[key] = r
            labels[key] = f"engine32_fused.{d} vs direct K2 n={n} B={b} p={LT30}"
    return {"rows": rows, "labels": labels}


def sweep(dev, u32) -> dict:
    """Every tile code of each pass of K1e and K2h, forced,
    checked exact, timed; the rule's choice beside the fastest."""
    from concrete_ntt_tpu_torch.ops import mxu32, mxu32_cuda as m

    rule_k1e, rule_tiles = m._k1e_tiles, m.k2h_tiles
    tasks, meta = [], {}

    def force(k1e=None, tiles=None):
        m._k1e_tiles = (lambda *a: k1e) if k1e else rule_k1e
        m.k2h_tiles = (lambda *a, **k: tiles) if tiles else rule_tiles

    def queue(key, fn, pass_i):
        tasks.append((key, lambda fn=fn: (fn, cs.is_pass), 2, pass_i))

    try:
        for n, b, c in K1E_SWEEP:
            pr = k1e_primes(c)
            sc = tuple(scale32(n, p) for p in pr)
            x = u32((c, b, n))
            xd = m.digit_planes32(x)
            force()
            rule = m._k1e_tiles(b, n, c)
            want = m.inv_multi_presplit(xd, pr, sc)
            cs.require(torch.equal(want, m.inv_multi_presplit_plain(xd, pr, sc)),
                       f"sweep: K1e (rule {rule}) != plain at n={n} B={b} C={c}")
            for pass_i, codes in ((0, (0, 1, 2)), (1, (0, 1, 2, 3))):
                for code in codes:
                    tiles = (code, rule[1]) if pass_i == 0 else (rule[0], code)
                    force(k1e=tiles)
                    cs.require(torch.equal(m.inv_multi_presplit(xd, pr, sc), want),
                               f"sweep: K1e tiles {tiles} wrong at n={n} B={b} C={c}")
                    key = ("K1e", n, b, c, pass_i, code)
                    meta[key] = rule[pass_i]
                    queue(key, cs.bind_now(lambda t=tiles, xd=xd, pr=pr, sc=sc: (
                        force(k1e=t), m.inv_multi_presplit(xd, pr, sc))), pass_i)
        for rname, p in regimes32().items():
            n_d = mxu32._n_dplanes32(p)
            for n, b in K2H_SWEEP:
                x = u32((b, n))
                s = scale32(n, p)
                for d in ("fwd", "inv"):
                    force()
                    call = cs.bind_now((lambda: m.fwd_hyb(x, n=n, p=p, n_h=N_H)) if d == "fwd"
                                       else (lambda: m.inv_hyb(x, n=n, p=p, n_h=N_H, scale=s)))
                    plain = (m.fwd_hyb_plain(x, n=n, p=p, n_h=N_H) if d == "fwd"
                             else m.inv_hyb_plain(x, n=n, p=p, n_h=N_H, scale=s))
                    rule = m.k2h_tiles(b, n, N_H, d, n_d)
                    want = call()
                    cs.require(torch.equal(want, plain),
                               f"sweep: K2h {d} (rule {rule}) != plain at {rname} n={n} B={b}")
                    for pass_i in (0, 1):
                        for code in range(4):
                            if code == 3 and (pass_i == 0 or n_d == 5):
                                continue  # no scaled 128 x 64, N = 320 past wgmma's 256
                            tiles = (code, rule[1]) if pass_i == 0 else (rule[0], code)
                            force(tiles=tiles)
                            cs.require(torch.equal(call(), want),
                                       f"sweep: K2h {d} tiles {tiles} wrong at {rname} n={n} "
                                       f"B={b}")
                            key = (f"K2h-{d}-{rname}", n, b, 1, pass_i, code)
                            meta[key] = rule[pass_i]
                            queue(key, cs.bind_now(lambda t=tiles, call=call: (
                                force(tiles=t), call())), pass_i)
        force()
        times = device_times(tasks, reps=SWEEP_REPS)
    finally:
        force()
    out = {}
    for key, rule in meta.items():
        what, n, b, c, pass_i, code = key
        group = out.setdefault(f"{what} n={n} B={b} C={c} pass {pass_i + 1}",
                               {"rule": rule, "ms": {}})
        group["ms"][f"{code}"] = times[key]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sweep", action="store_true",
                    help="force and time every tile code of K1e's and K2h's passes")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_k1e_k2h: torch.cuda.is_available() is False; this run needs a CUDA GPU",
              file=sys.stderr)
        return 1
    from concrete_ntt_tpu_torch.ops import cuda_build

    for name in ("mxu32_multi", "mxu32_pass"):
        cuda_build.load(name)
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip()
    rng = np.random.default_rng(2024)
    u32 = lambda shape, hi=1 << 32: torch.from_numpy(  # noqa: E731
        rng.integers(0, hi, shape, dtype=np.uint32)).to(dev)
    fmt = lambda v: "not measured" if v is None else f"{v:.4f} ms"  # noqa: E731
    try:
        if args.sweep:
            result = {"sweep": sweep(dev, u32)}
            for label, g in result["sweep"].items():
                best = min((v, k) for k, v in g["ms"].items() if v is not None)
                print(f"sweep: {label}: " + ", ".join(f"code {k} {fmt(v)}" for k, v in
                                                       g["ms"].items())
                      + f"; fastest {best[1]}, rule {g['rule']} (device, median of "
                      f"{SWEEP_REPS}) | {smi}", flush=True)
        else:
            result = ab_rows(dev, u32, smi)
            for key, r in result["rows"].items():
                vals = ", ".join(f"{k} {fmt(v) if not isinstance(v, list) else v}"
                                 for k, v in r.items())
                print(f"ab_k1e_k2h: {key} ({result['labels'][key]}): {vals} | {smi}", flush=True)
    except cs.PhaseError as e:
        print(f"ab_k1e_k2h: FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    print(smi)
    print(json.dumps({**{k: v for k, v in result.items() if k != "labels"},
                      "port": os.getcwd()}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
