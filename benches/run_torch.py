"""Criterion-parity benchmark grid of the PyTorch + CUDA port, on the card.

The twin of `benches/run.py` for `concrete_ntt_tpu_torch`: the same bench
ids (the reference's benches/ntt.rs:95-233 scheme), the same regime primes,
batches and seeds:

    fwd-32-{p}-{n}, inv-32-{p}-{n}         3 prime regimes
    fwd-64-{p}-{n}, inv-64-{p}-{n}         6 prime regimes
    native{32,64,128}-{32,52}-{n}          negacyclic_polymul per tier
    nativebinary{32,64,128}-{32,52}-{n}
    product-2xu32[-acc|-bounded]-{n}       the product plan (tfhe-rs hot path)

plus the single-polynomial `-b1` rows at 16384 and, with `--full` or
`--ids`, the sizes above 2^15. Each id is timed by
`concrete_ntt_tpu_torch.utils.profiling.chain_samples`: a chain of K
dependent steps (both operands fresh every step) and a chain of one, each
captured as a CUDA graph and replayed in turns, timed by CUDA events, so
host dispatch is removed. Reported per polynomial at batch B: the best
estimate (best t_K - best t_1) / (K - 1), and the median and maximum of the
per-rep estimates (criterion's mean and spread), beside the roofline floor
(the carry's bytes over the H100's HBM rate, `profiling.HBM_BYTES_PER_S`):
a row under it is measured once more and flagged `suspect`.

Usage, on the card:
    python benches/run_torch.py                 # QUICK_NS subset
    python benches/run_torch.py --full          # the reference's full n grid
    python benches/run_torch.py --ids native64-32-16384 fwd-32-1073479681-16384
One JSON line per id on stdout (with `nvidia-smi`'s name and power limit),
and to `--out FILE` when given; `benches/results*.jsonl` are the JAX
package's records and are never written. An id that fails prints an error
row, and the run then exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

BATCH = 16
K = 64
REPS = 5

FULL_NS = [256, 512, 1024, 2048, 4096, 8192, 16384, 32768]
QUICK_NS = [1024, 16384]
DEVICE = "cuda"


def _dev(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)


def _limbs(v: np.ndarray, width: int = 64) -> torch.Tensor:
    """uint64 values [..., n] -> uint32 limbs [..., n, width // 32] on the card."""
    lo = (v & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (v >> np.uint64(32)).astype(np.uint32)
    zero = np.zeros_like(lo)
    return _dev(np.stack([lo, hi] + [zero] * (width // 32 - 2), axis=-1))


def _roll(x: torch.Tensor) -> torch.Tensor:
    """x rotated by one along the transform axis (torch has no uint32 roll)."""
    return torch.roll(x.view(torch.int32), 1, dims=1).view(torch.uint32)


def _two_el(op):
    """Two-element carry: both slots change every step."""
    def step(carry):
        a, b = carry
        return op(b), a

    return step


def _prime_benches(ns, want):
    """fwd/inv-32 and fwd/inv-64 ids (benches/ntt.rs:84-132)."""
    from concrete_ntt_tpu_torch import prime32, prime64
    from concrete_ntt_tpu_torch.utils.prime import (
        largest_prime_in_arithmetic_progression64 as prime_in_ap,
    )

    rng = np.random.default_rng(0)
    for n in ns:
        ps32 = [
            prime_in_ap(1 << 16, 1, 1 << 29, 1 << 30),
            prime_in_ap(1 << 16, 1, 1 << 30, 1 << 31),
            prime_in_ap(1 << 16, 1, 1 << 31, (1 << 32) - 1),
        ]
        for p in ps32:
            ids = [f"{d}-32-{p}-{n}{s}" for d in ("fwd", "inv") for s in ("", "-b1")]
            if not any(map(want, ids)):
                continue
            plan = prime32.Plan.try_new(n, p, DEVICE)
            if plan is None:
                continue
            x = _dev(rng.integers(0, p, (BATCH, n), dtype=np.uint32))
            x2 = _dev(rng.integers(0, p, (BATCH, n), dtype=np.uint32))
            yield f"fwd-32-{p}-{n}", _two_el(plan.fwd), (x, x2), BATCH
            yield f"inv-32-{p}-{n}", _two_el(plan.inv), (x, x2), BATCH
            if n == 16384 and p == ps32[0]:
                yield f"fwd-32-{p}-{n}-b1", _two_el(plan.fwd), (x[:1], x2[:1]), 1
                yield f"inv-32-{p}-{n}-b1", _two_el(plan.inv), (x[:1], x2[:1]), 1
        ps64 = [
            prime_in_ap(1 << 16, 1, 1 << 49, 1 << 50),
            prime_in_ap(1 << 16, 1, 1 << 50, 1 << 51),
            prime_in_ap(1 << 16, 1, 1 << 61, 1 << 62),
            prime_in_ap(1 << 16, 1, 1 << 62, 1 << 63),
            prime64.Solinas,
            prime_in_ap(1 << 16, 1, 1 << 63, (1 << 64) - 1),
        ]
        for p in ps64:
            ids = [f"{d}-64-{p}-{n}{s}" for d in ("fwd", "inv") for s in ("", "-b1")]
            if not any(map(want, ids)):
                continue
            plan = prime64.Plan.try_new(n, p, DEVICE)
            if plan is None:
                continue
            x = _limbs(rng.integers(0, p, (BATCH, n), dtype=np.uint64))
            x2 = _limbs(rng.integers(0, p, (BATCH, n), dtype=np.uint64))
            yield f"fwd-64-{p}-{n}", _two_el(plan.fwd), (x, x2), BATCH
            yield f"inv-64-{p}-{n}", _two_el(plan.inv), (x, x2), BATCH
            if n == 16384 and p == prime64.Solinas:
                yield f"fwd-64-{p}-{n}-b1", _two_el(plan.fwd), (x[:1], x2[:1]), 1
                yield f"inv-64-{p}-{n}-b1", _two_el(plan.inv), (x[:1], x2[:1]), 1


def _native_step(plan, binary: bool):
    """Two-element carry, both operands fresh every step; a binary rhs stays
    {0, 1} by rotating instead of taking the product."""
    def step(carry):
        a, b = carry
        prod = plan.negacyclic_polymul(a, b, rhs_binary=binary)
        return (prod, _roll(b)) if binary else (prod, a)

    return step


def _native_benches(ns, want):
    """native*/nativebinary* polymul ids (benches/ntt.rs:134-233)."""
    from concrete_ntt_tpu_torch import (
        native32, native64, native128, native_binary32, native_binary64, native_binary128)

    rng = np.random.default_rng(1)
    fams = [
        ("native32", native32, 32, False),
        ("nativebinary32", native_binary32, 32, True),
        ("native64", native64, 64, False),
        ("nativebinary64", native_binary64, 64, True),
        ("native128", native128, 128, False),
        ("nativebinary128", native_binary128, 128, True),
    ]
    for n in ns:
        for name, mod, width, binary in fams:
            for tier, cls in (("32", "Plan32"), ("52", "Plan52")):
                b1 = name == "native64" and n == 16384
                if not (want(f"{name}-{tier}-{n}") or (b1 and want(f"{name}-{tier}-{n}-b1"))):
                    continue
                plan_cls = getattr(mod, cls, None)
                plan = plan_cls.try_new(n, DEVICE) if plan_cls is not None else None
                if plan is None:
                    continue
                hi = 1 << (62 if width == 128 else width)  # u128 below 2^62, as the JAX grid's
                lhs = rng.integers(0, hi, (BATCH, n), dtype=np.uint64)
                rhs = rng.integers(0, 2 if binary else hi, (BATCH, n), dtype=np.uint64)
                if width == 32:
                    lhs, rhs = _dev(lhs.astype(np.uint32)), _dev(rhs.astype(np.uint32))
                else:
                    lhs, rhs = _limbs(lhs, width), _limbs(rhs, width)
                yield f"{name}-{tier}-{n}", _native_step(plan, binary), (lhs, rhs), BATCH
                if b1:  # single-polynomial latency
                    yield (f"{name}-{tier}-{n}-b1", _native_step(plan, binary),
                           (lhs[:1], rhs[:1]), 1)


def _centred(rng, m: int, bound: int, shape) -> np.ndarray:
    """Signed values |v| < bound / 2 as residues mod m (uint64)."""
    v = rng.integers(-(bound // 2), bound // 2, shape)
    return np.where(v < 0, np.uint64(m) - np.abs(v).astype(np.uint64), v.astype(np.uint64))


def _product_steps(plan):
    from concrete_ntt_tpu_torch import product

    def rep(carry):
        x, y = carry
        return plan.negacyclic_polymul(x, y), x

    def acc(carry):
        x, y, a = carry
        return plan.negacyclic_polymul(x, y, mode=product.ACCUMULATE, standard=a), x, y

    def bnd(carry, bound=1 << 20):
        # the centred (PBS accumulator) operand rotates and stays centred;
        # the full-range product feeds the rhs slot
        y, x = carry
        return plan.negacyclic_polymul(x, y, lhs_fwd_mode=product.bounded(bound)), _roll(x)

    return rep, acc, bnd


def _product_benches(ns, want):
    """product-* ids (no reference bench analogue; the tfhe-rs hot path,
    product.rs:444-445): Replace, Accumulate, Bounded(2^20)."""
    from concrete_ntt_tpu_torch import product
    from concrete_ntt_tpu_torch.tables import PRIMES32

    rng = np.random.default_rng(2)
    f1, f2 = PRIMES32[0], PRIMES32[1]
    m = f1 * f2
    for n in ns:
        ids = [f"product-2xu32{s}-{n}" for s in ("", "-acc", "-bounded")]
        if not any(map(want, ids)):
            continue
        plan = product.Plan.try_new(n, m, (f1, f2), DEVICE)
        if plan is None:
            continue
        a, b, c = (_limbs(rng.integers(0, m, (BATCH, n), dtype=np.uint64)) for _ in range(3))
        ab = _limbs(_centred(rng, m, 1 << 20, (BATCH, n)))
        rep, acc, bnd = _product_steps(plan)
        yield f"product-2xu32-{n}", rep, (a, b), BATCH
        yield f"product-2xu32-acc-{n}", acc, (a, b, c), BATCH
        yield f"product-2xu32-bounded-{n}", bnd, (b, ab), BATCH


def _large_n_benches(want):
    """Beyond the reference's 2^15 cap (benches/run.py's large-n rows):
    prime32 / prime64 at 2^16 and 2^17, native64 and native128 Plan32 and
    the product plan at 2^16."""
    from concrete_ntt_tpu_torch import native64, native128, prime32, prime64, product
    from concrete_ntt_tpu_torch.tables import primes32_ext
    from concrete_ntt_tpu_torch.utils.prime import (
        largest_prime_in_arithmetic_progression64 as prime_in_ap,
    )

    rng = np.random.default_rng(2)
    p = primes32_ext()[0]
    for n in (1 << 16, 1 << 17):
        if want(f"fwd-32-{p}-{n}") or want(f"inv-32-{p}-{n}"):
            plan = prime32.Plan.try_new(n, p, DEVICE)
            x, x2 = (_dev(rng.integers(0, p, (BATCH, n), dtype=np.uint32)) for _ in range(2))
            yield f"fwd-32-{p}-{n}", _two_el(plan.fwd), (x, x2), BATCH
            yield f"inv-32-{p}-{n}", _two_el(plan.inv), (x, x2), BATCH
    for n in (1 << 16, 1 << 17):
        for p64 in (prime_in_ap(2 * n, 1, 0, 1 << 50), prime64.Solinas):
            if not (want(f"fwd-64-{p64}-{n}") or want(f"inv-64-{p64}-{n}")):
                continue
            plan = prime64.Plan.try_new(n, p64, DEVICE)
            x, x2 = (_limbs(rng.integers(0, p64, (BATCH, n), dtype=np.uint64)) for _ in range(2))
            yield f"fwd-64-{p64}-{n}", _two_el(plan.fwd), (x, x2), BATCH
            yield f"inv-64-{p64}-{n}", _two_el(plan.inv), (x, x2), BATCH
    n = 1 << 16
    for name, mod, width in (("native64", native64, 64), ("native128", native128, 128)):
        if want(f"{name}-32-{n}"):
            plan = mod.Plan32.try_new(n, DEVICE)
            hi = 1 << (62 if width == 128 else width)
            lhs, rhs = (_limbs(rng.integers(0, hi, (BATCH, n), dtype=np.uint64), width)
                        for _ in range(2))
            yield f"{name}-32-{n}", _native_step(plan, False), (lhs, rhs), BATCH
    if want(f"product-2xu32-{n}"):
        f1, f2 = primes32_ext()[:2]
        plan = product.Plan.try_new(n, f1 * f2, (f1, f2), DEVICE)
        a, b = (_limbs(rng.integers(0, f1 * f2, (BATCH, n), dtype=np.uint64)) for _ in range(2))
        yield f"product-2xu32-{n}", _product_steps(plan)[0], (a, b), BATCH


def _floor_ns(args, batch: int) -> float:
    """The carry's bytes a polynomial over the card's HBM rate: every step
    reads its operands and writes outputs of the same size, so no row can
    be faster."""
    from concrete_ntt_tpu_torch.utils.profiling import HBM_BYTES_PER_S

    nbytes = sum(a.numel() * a.element_size() for a in args)
    return nbytes / batch / HBM_BYTES_PER_S * 1e9


def _measure(step, args) -> tuple:
    """(best, median, max) seconds a step over REPS interleaved pairs of
    chains of K and 1 steps: best t_K - best t_1, and the per-pair
    estimates' median and maximum."""
    from concrete_ntt_tpu_torch.utils.profiling import chain_samples

    pairs = chain_samples(step, args, length=K, reps=REPS)
    best = (min(a for a, _ in pairs) - min(b for _, b in pairs)) / (K - 1)
    ests = sorted((a - b) / (K - 1) for a, b in pairs if a > b)
    if best <= 0 or not ests:
        raise RuntimeError(f"non-monotone chain at K={K}: pairs {pairs}")
    return best, ests[len(ests) // 2], ests[-1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true", help="the reference's full n grid")
    ap.add_argument("--ids", nargs="*", help="only run these bench ids")
    ap.add_argument("--out", default=None, help="also write the rows to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("run_torch: torch.cuda.is_available() is False; the grid runs on the card",
              file=sys.stderr)
        return 1
    if args.out and os.path.abspath(args.out).startswith(
            os.path.join(os.path.dirname(os.path.abspath(__file__)), "results")):
        print(f"run_torch: {args.out} is the JAX package's record; give another file",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", "0"], capture_output=True, text=True, check=True).stdout.strip()
    ns = FULL_NS if args.full else QUICK_NS

    def want(bid):
        return not args.ids or bid in args.ids

    benches = [_prime_benches(ns, want), _native_benches(ns, want), _product_benches(ns, want)]
    if args.full or args.ids:
        benches.append(_large_n_benches(want))
    out = open(args.out, "w") if args.out else None
    failed = 0
    try:
        for gen in benches:
            for bid, step, x, batch in gen:
                if not want(bid):
                    continue
                try:
                    t, t_med, t_max = _measure(step, x)
                    floor_ns = _floor_ns(x, batch)
                    suspect = t / batch * 1e9 < floor_ns
                    if suspect:  # below the HBM floor: once more
                        t, t_med, t_max = _measure(step, x)
                        suspect = t / batch * 1e9 < floor_ns
                    rec = {"id": bid, "batch": batch, "ns_per_poly": t / batch * 1e9,
                           "polys_per_sec": batch / t, "ns_per_poly_med": t_med / batch * 1e9,
                           "ns_per_poly_max": t_max / batch * 1e9, "reps": REPS,
                           "k": K, "floor_ns": floor_ns, "type": "latency",
                           **({"suspect": True} if suspect else {}), "device": smi}
                except Exception as exc:  # an error row, then the next id
                    failed += 1
                    rec = {"id": bid, "error": f"{type(exc).__name__}: {exc}"[:300],
                           "device": smi}
                finally:
                    torch.cuda.empty_cache()
                print(json.dumps(rec), flush=True)
                if out:
                    out.write(json.dumps(rec) + "\n")
    finally:
        if out:
            out.close()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
