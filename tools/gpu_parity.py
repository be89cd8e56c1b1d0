#!/usr/bin/env python3
"""On-card bit-exactness gate of the PyTorch + CUDA port, the twin of
tools/tpu_parity.py.

Rows are enumerated from the dispatcher, not hand-picked: n walks 2^11 ...
2^17 (the butterfly kernel K4 from 2 up, the prime32 stage engine at 2^18)
through `ops/ntt_dispatch.route32`, `tier32`, `tier64` and `route64` over
the regime primes of `regimes()`, and every value those functions return
appears at every n that returns it (`walk()`; tests/test_torch_gpu_parity.py
holds the row list to it), with the native64 and native128 Plan32 lift
kernels at every n.
Beside the routes, the ported entry points that no route takes: K1e, K2
with block tables (K2h) and `engine32_fused`, K5 with the four limbs of a
u128 operand (W4-64), K1c / K1d (the product plan's), K7b / K7c, and the
sharded routes' K3 / K6 channel grids at their rank-local shapes in this
process. Axes: B in {1, 3, 16} (8 for the native
plans), the 32-bit regimes lt30, lt31, gen4 and gen5 (four and five digit
planes), the 64-bit regimes p50, p62, p63, Goldilocks and p64, operand limbs
1 / 2 / 4, CRT channels 2 / 3 / 5 / 10.

Each row is one check, printed as one PASS / FAIL line:
  * a kernel row holds the wrapper against its plain torch twin on the card,
    bit for bit (a kernel that does not build or launch is a FAIL);
  * a plan row holds `negacyclic_polymul` of one of the ten public plans
    (native32 / 64 / 128 and native_binary32 / 64 / 128 in each tier a
    family has, prime32, prime64, product in Replace / Accumulate /
    Bounded) against an oracle that shares nothing with the port's host
    tables: the first row of the batch against an exact integer
    convolution (`exact_negacyclic`: the golden `fwd` / `inv` over primes
    >= 2^61 and the golden CRT), reduced by the plan's modulus or width;
    every row for the native u32 / u64 plans up to 2^14 against the numpy
    wrapping oracle; under --quick, sampled coefficients of the first row
    (`negacyclic_coefficients_wrapping`);
  * a route row drives the dispatcher's channel functions
    (`try_fwd*_wide_all`, `try_pointwise_inv*_all`) on prime sets no plan
    holds and checks each channel's residues against the same oracle;
  * a fixture row holds five native plans at N = 2048 against the SHA-256
    digests of tests/fixtures/dense_oracle_2048.json.

The header gives the HEAD commit (`--commit` where the checkout is no git
repository), a sha256 over the kernel sources (`csrc/*`, `ops/*_cuda.py`:
a log committed beside later kernel edits is visibly stale) and the card's
name and power limit from nvidia-smi; the footer the counts and seconds.
With --times every kernel row's line also gives its device ms (one
torch.profiler session for the whole run, `utils/profiling.device_times`) and
the tile code each pass took; the lines are then printed after the session.

Usage:
    python3 tools/gpu_parity.py [--quick] [--times] [--only REGEX]
    python3 tools/gpu_parity.py --device cpu --quick [--only REGEX]

Without a CUDA device it stops with an error unless given --device cpu,
which runs the plain path (plan, route and fixture rows) against the
oracle. Run after any kernel change and commit the log (GPU_PARITY_r{N}.txt).
Exits non-zero on any FAIL. Imports no JAX.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib
import json
import os
import re
import subprocess
import sys
import time
from collections import namedtuple
from functools import lru_cache

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

N_H = 1 << 14  # the stage-split hybrids' block size
N_FOURSTEP = tuple(1 << k for k in range(11, 18))  # the four-step kernels' range
N_SMALL = tuple(1 << k for k in range(1, 11))  # below it: K4, the per-channel routes
N_STAGE32 = 1 << 18  # tier32's "stage": above the kernels' range
QUICK_N = (2, 512, 1 << 11, 1 << 14, 1 << 16)
BATCHES = (1, 3, 16)
B_NATIVE = 8
REPS = 20
SEED = 2025  # the operands of every row are drawn from it and the row's name
BOUND = 1 << 20  # the product plan's Bounded fwd: |value| < 2^19
K1_RING = "(0, 0): K1's ring, the one tile of K1a / K1b"
ROWS128 = "(0, 0): 128 rows, the one tile of K5 / K7"
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "dense_oracle_2048.json")

# a channel-function argument: the dispatcher reads only `.p` of a plan
Chan = namedtuple("Chan", "p")


# ---------------------------------------------------------------------------
# primes
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def regimes() -> dict:
    """The regime primes, by the bounds of tools/tpu_parity.py:119-132 with
    2^18 | p - 1, so that one prime of each regime serves every n up to 2^17:
    "r32" lt30, lt31, gen4 (four digit planes), gen5 (five); "r64" p50,
    p62, p63, gl (Goldilocks), p64; "small" (< 2^26: K4 at every n);
    "stage32" (2^19 | p - 1, the prime32 stage engine at 2^18); "p34" (the
    product plan's u64 factor beside a 30-bit one); "p52x" (three 50-bit
    primes: the Plan52 channel grid up to 2^17, K7h above 2^15)."""
    from concrete_ntt_tpu_torch.tables import GOLDILOCKS
    from concrete_ntt_tpu_torch.utils.prime import (
        largest_prime_in_arithmetic_progression64 as ap)

    f = 1 << 18
    p52x = [ap(f, 1, 0, 1 << 50)]
    while len(p52x) < 3:
        p52x.append(ap(f, 1, 0, p52x[-1] - 1))
    return {
        "r32": {"lt30": ap(f, 1, 1 << 29, 1 << 30), "lt31": ap(f, 1, 1 << 30, 1 << 31),
                "gen4": ap(f, 1, 1 << 31, 4278124286), "gen5": ap(f, 1, 1 << 31, (1 << 32) - 1)},
        "r64": {"p50": p52x[0], "p62": ap(f, 1, 1 << 61, 1 << 62),
                "p63": ap(f, 1, 1 << 62, 1 << 63), "gl": GOLDILOCKS,
                "p64": ap(f, 1, 1 << 63, (1 << 64) - 1)},
        "small": ap(f, 1, 0, 1 << 26),
        "stage32": ap(1 << 19, 1, 1 << 29, 1 << 30),
        "p34": ap(f, 1, 1 << 33, 1 << 34),
        "p52x": tuple(p52x),
    }


def variant32(p: int) -> str:
    return ("lt30", "lt31", "generic")[0 if p < 1 << 30 else 1 if p < 1 << 31 else 2]


def channel_primes(c: int, n: int) -> tuple:
    """The first c 30-bit channel primes that serve n (the native plans')."""
    from concrete_ntt_tpu_torch.tables import native_channel_primes

    return native_channel_primes(c, max(n, 2))


def route32_sets(n: int) -> list:
    """The prime32 channel sets of the walk: the native plans' (2, 3, 5, 10
    channels), the product plan's (two 30-bit, lt31 + gen5, small + lt30) and
    the three generic regimes at once."""
    r = regimes()
    r32 = r["r32"]
    sets = [channel_primes(c, n) for c in (2, 3, 5, 10)]
    return sets + [(r32["lt31"], r32["gen5"]), (r["small"], r32["lt30"]),
                   (r32["lt31"], r32["gen4"], r32["gen5"])]


def route64_sets(n: int) -> list:
    """The prime64 channel sets of the walk: Plan52's (1-3 of PRIMES52, up to
    2^15), three 50-bit primes with 2^18 | p - 1, and a mixed pair (p50, p63)
    whose plane counts differ (the per-channel route)."""
    from concrete_ntt_tpu_torch.tables import PRIMES52

    r = regimes()
    sets = [tuple(PRIMES52[:c]) for c in (1, 2, 3)] if n <= 1 << 15 else []
    return sets + [r["p52x"], (r["r64"]["p50"], r["r64"]["p63"])]


def walk() -> set:
    """(function, n, value) for every value the four dispatcher functions
    return over the n range and the prime sets of the sweep."""
    from concrete_ntt_tpu_torch.ops import ntt_dispatch as nd

    r = regimes()
    out = set()
    for n in N_SMALL + N_FOURSTEP:
        for p in (*r["r32"].values(), r["small"]):
            out.add(("tier32", n, nd.tier32(n, p, variant32(p))))
        out.update(("route32", n, nd.route32(n, s)) for s in route32_sets(n))
        out.update(("tier64", n, nd.tier64(n, p)) for p in r["r64"].values())
        out.update(("route64", n, nd.route64(n, s)) for s in route64_sets(n))
    out.add(("tier32", N_STAGE32, nd.tier32(N_STAGE32, r["stage32"], "lt30")))
    return out


# ---------------------------------------------------------------------------
# the oracle (pure Python integers: the port's golden layer, no host tables)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def oracle_primes(count: int) -> tuple:
    """count primes >= 2^61 with 2^19 | q - 1: independent of every prime the
    port's plans use, each with a 2n-th root of unity up to n = 2^18."""
    from concrete_ntt_tpu_torch.utils.prime import (
        largest_prime_in_arithmetic_progression64 as ap)

    out = [ap(1 << 19, 1, 1 << 61, 1 << 62)]
    while len(out) < count:
        out.append(ap(1 << 19, 1, 1 << 61, out[-1] - 1))
    return tuple(out)


def exact_negacyclic(lhs, rhs) -> list:
    """The exact (signed integer) negacyclic product of two integer
    polynomials: the golden `negacyclic_polymul` (fwd, pointwise · n^-1,
    inv) modulo enough primes >= 2^61 that their product exceeds
    2 · n · max|a| · max|b|, lifted by the golden signed CRT."""
    from concrete_ntt_tpu_torch.golden import crt as gcrt
    from concrete_ntt_tpu_torch.golden import ntt as gntt

    n = len(lhs)
    bound = 2 * n * max(1, max(abs(int(v)) for v in lhs)) * max(1, max(abs(int(v)) for v in rhs))
    k, m = 0, 1
    while m <= bound:
        k += 1
        m *= oracle_primes(k)[-1]
    primes = oracle_primes(k)
    chans = [gntt.negacyclic_polymul([int(v) % q for v in lhs], [int(v) % q for v in rhs], q)
             for q in primes]
    bits = m.bit_length() + 1
    return [v - (1 << bits) if v >> (bits - 1) else v
            for v in gcrt.reconstruct_signed_wrapping(chans, primes, bits)]


def sampled_negacyclic(lhs, rhs, ks) -> list:
    """Coefficients ks of the exact signed product, each an O(n) sum."""
    from concrete_ntt_tpu_torch.golden.polymul import negacyclic_coefficients_wrapping

    top = max(1, max(abs(int(v)) for v in (*lhs, *rhs)))
    bits = 2 * top.bit_length() + len(lhs).bit_length() + 2
    return [v - (1 << bits) if v >> (bits - 1) else v
            for v in negacyclic_coefficients_wrapping(lhs, rhs, ks, bits)]


def _kind_row(n: int, kind: str, seed: int) -> list:
    """The first row of every plan's operand of this kind at n, shared by the
    rows at n so that each exact product is computed once: "u32", "u64",
    "u128" (uniform), "bin" (0 / 1), "small" (signed, |v| < 2^19)."""
    rng = np.random.default_rng([seed, n, *kind.encode()])
    if kind == "bin":
        return rng.integers(0, 2, n).tolist()
    if kind == "small":
        return rng.integers(-(BOUND // 2) + 1, BOUND // 2, n).tolist()
    words = {"u32": 1, "u64": 2, "u128": 4}[kind]
    limbs = rng.integers(0, 1 << 32, (words, n), dtype=np.uint64).tolist()
    return [sum(limbs[w][i] << (32 * w) for w in range(words)) for i in range(n)]


# ---------------------------------------------------------------------------
# rows
# ---------------------------------------------------------------------------


class Row:
    """One check. kind: "kernel" (make(ctx, name) -> (kernel call, plain
    call, kernel-name match)), "plan", "route" or "fixture" (run(ctx, name)
    raises Mismatch or returns a detail string); covers: the (dispatcher
    function, value) pairs the row exercises at n; tiles() names the tile a
    kernel's rule picks where the wrapper does not count it (or a fixed
    string)."""

    def __init__(self, name: str, kind: str, n: int, covers: tuple = (), make=None, run=None,
                 tiles=None):
        self.name, self.kind, self.n, self.covers = name, kind, n, covers
        self.make, self.run, self.tiles = make, run, tiles


class Mismatch(AssertionError):
    pass


class Ctx:
    def __init__(self, device: str, quick: bool, seed: int):
        self.dev = torch.device(device)
        self.quick = quick
        self.seed = seed
        self._exact = {}

    def rng(self, name: str):
        return np.random.default_rng([self.seed, *name.encode()])

    def u32(self, rng, shape, hi=1 << 32) -> torch.Tensor:
        return torch.from_numpy(rng.integers(0, hi, shape, dtype=np.uint32)).to(self.dev)

    def first_rows(self, n: int, lkind: str, rkind: str) -> tuple:
        return _kind_row(n, lkind, self.seed), _kind_row(n, rkind, self.seed)

    def ks(self, n: int) -> list:
        """The coefficients a --quick row checks: the ends, the middle and
        four more from the seed."""
        rng = np.random.default_rng([self.seed, n])
        return sorted({0, 1 % n, n // 2, n - 1, *rng.integers(0, n, 4).tolist()})

    def exact(self, n: int, lkind: str, rkind: str) -> dict:
        """{k: exact signed coefficient k} of the product of the shared first
        rows (all k, or the sampled ones under --quick), cached."""
        key = (n, lkind, rkind)
        if key not in self._exact:
            a, b = self.first_rows(n, lkind, rkind)
            if self.quick:
                ks = self.ks(n)
                self._exact[key] = dict(zip(ks, sampled_negacyclic(a, b, ks)))
            else:
                self._exact[key] = dict(enumerate(exact_negacyclic(a, b)))
        return self._exact[key]


def check_first_row(ctx, got: list, n: int, lkind: str, rkind: str, reduce) -> None:
    """got (the output's first row as ints) against reduce(k, exact[k])."""
    want = ctx.exact(n, lkind, rkind)
    bad = [k for k, v in want.items() if got[k] != reduce(k, v)]
    if bad:
        raise Mismatch(f"{len(bad)} of {len(want)} oracle coefficients differ (first at "
                       f"k={bad[0]}: {got[bad[0]]} != {reduce(bad[0], want[bad[0]])})")


def _flat(x) -> list:
    return [t for e in x for t in _flat(e)] if isinstance(x, (tuple, list)) else [x]


def same_bits(got, want) -> bool:
    """Equal tensors (nested tuples and lists of them), bit for bit (uint32
    compared through an int32 view)."""
    xs, ys = _flat(got), _flat(want)
    view = lambda t: t.view(torch.int32) if t.dtype == torch.uint32 else t
    return len(xs) == len(ys) and all(
        x.shape == y.shape and torch.equal(view(x), view(y)) for x, y in zip(xs, ys))


def scale32(n: int, p: int) -> int:
    return pow(n, p - 2, p) * pow(2, 32, p) % p


def scale64(n: int, p: int) -> int:
    return pow(n, p - 2, p) * pow(2, 64, p) % p


def _pair(ctx, rng, shape) -> tuple:
    return ctx.u32(rng, shape), ctx.u32(rng, shape)


def _batch(i: int) -> int:
    return BATCHES[i % len(BATCHES)]


# -- kernel rows ----------------------------------------------------------------


def _kernel(name: str, n: int, covers: tuple, make, tiles=None) -> Row:
    return Row(name=name, kind="kernel", n=n, covers=covers, make=make, tiles=tiles)


def k2_rows(n: int) -> list:
    from concrete_ntt_tpu_torch.ops import mxu32_cuda as m

    out = []
    for i, (rname, p) in enumerate(regimes()["r32"].items()):
        for b in (1, (3, 16)[i % 2]):
            def fwd(ctx, name, b=b, p=p):
                x = ctx.u32(ctx.rng(name), (b, n))
                return (lambda: m.fwd(x, n=n, p=p), lambda: m.fwd_plain(x, n=n, p=p),
                        "matmod_pass")

            def inv(ctx, name, b=b, p=p):
                x, s = ctx.u32(ctx.rng(name), (b, n)), scale32(n, p)
                return (lambda: m.inv(x, n=n, p=p, scale=s),
                        lambda: m.inv_plain(x, n=n, p=p, scale=s), "matmod_pass")

            for d, make in (("fwd", fwd), ("inv", inv)):
                out.append(_kernel(f"K2 {d} n={n} B={b} {rname}", n, (("tier32", "K2"),), make,
                                   tiles=lambda b=b, d=d: str(m._k2_tiles(b, n, d))))
    r32 = regimes()["r32"]
    for limbs, b, rname in ((2, 3, "gen5"), (4, 1, "lt30")):
        p = r32[rname]

        def wide(ctx, name, limbs=limbs, b=b, p=p):
            xs = tuple(ctx.u32(ctx.rng(name), (b, n)) for _ in range(limbs))
            return (lambda: m.fwd_wide(xs, n=n, p=p), lambda: m.fwd_wide_plain(xs, n=n, p=p),
                    "matmod_pass")

        out.append(_kernel(f"K2 fwd_wide n={n} B={b} limbs={limbs} {rname}", n,
                           (("tier32", "K2"), ("route32", "K2")), wide,
                           tiles=lambda b=b: str(m._k2_tiles(b, n, "fwd"))))
    return out


def k4_rows(n: int) -> list:
    from concrete_ntt_tpu_torch import prime32
    from concrete_ntt_tpu_torch.ops import butterfly32_cuda as bcu

    r = regimes()
    if n >= N_FOURSTEP[0]:
        cases = [("small", r["small"], b) for b in BATCHES]
    else:
        cases = [(rn, p, b) for i, (rn, p) in enumerate(r["r32"].items())
                 for b in (1, (3, 16)[i % 2])]
        if n < 1024:
            cases += [("lt30", r["r32"]["lt30"], 3), ("lt31", r["r32"]["lt31"], 16)]
    out = []
    for rname, p, b in cases:
        for d, kern, plain in (("fwd", bcu.try_fwd, bcu.fwd_plain),
                               ("inv", bcu.try_inv, bcu.inv_plain)):
            def make(ctx, name, p=p, b=b, kern=kern, plain=plain):
                plan = prime32.Plan.new(n, p, device=str(ctx.dev))
                kw = dict(p=p, variant=plan.variant, p_neginv=plan.p_neginv)
                x = ctx.u32(ctx.rng(name), (b, n), p)
                return (lambda: kern(x, plan._tbl, **kw), lambda: plain(x, plan._tbl, **kw),
                        "ntt_k4")

            out.append(_kernel(f"K4 {d} n={n} B={b} {rname}", n, (("tier32", "K4"),), make,
                               tiles=lambda b=b: f"cluster {bcu.cluster_size(n, b)}"))
    return out


def k1_rows(n: int) -> list:
    from concrete_ntt_tpu_torch.ops import mxu32_cuda as m

    cov = (("route32", "K1"),)
    out = []
    for limbs, c, b in ((1, 2, 1), (1, 3, 3), (2, 5, 16), (2, 3, 1), (4, 10, 3), (4, 5, 1)):
        def k1a(ctx, name, limbs=limbs, c=c, b=b):
            rng, pr = ctx.rng(name), channel_primes(c, n)
            xs = tuple(ctx.u32(rng, (b, n)) for _ in range(limbs))
            return (lambda: m.fwd_wide_multi(xs, pr), lambda: m.fwd_wide_multi_plain(xs, pr),
                    "matmod_pass")

        out.append(_kernel(f"K1a fwd_wide_multi n={n} B={b} C={c} limbs={limbs}", n, cov, k1a,
                           tiles=K1_RING))
    for c, b in ((2, 16), (3, 1), (5, 3), (10, 1)):
        def k1b(ctx, name, c=c, b=b):
            pr = channel_primes(c, n)
            x, s = ctx.u32(ctx.rng(name), (c, b, n)), tuple(scale32(n, p) for p in pr)
            return (lambda: m.inv_multi(x, pr, s), lambda: m.inv_multi_plain(x, pr, s),
                    "matmod_pass")

        out.append(_kernel(f"K1b inv_multi n={n} B={b} C={c} scaled", n, cov, k1b, tiles=K1_RING))
    for limbs, c, b in ((1, 2, 1), (1, 3, 16), (2, 2, 3)):
        def k1c(ctx, name, limbs=limbs, c=c, b=b):
            pr = channel_primes(c, n)
            xs = tuple(ctx.u32(ctx.rng(name), (c, b, n)) for _ in range(limbs))
            kern = ((lambda: m.fwd_multi_perchannel(xs[0], pr)) if limbs == 1 else
                    (lambda: m.fwd_wide_multi_perchannel(*xs, pr)))
            return kern, lambda: m.fwd_multi_perchannel_plain(xs, pr), "matmod_pass"

        out.append(_kernel(f"K1c fwd_multi_perchannel n={n} B={b} C={c} limbs={limbs}", n, cov,
                           k1c))
    for c, b in ((2, 1), (3, 3), (2, 16)):
        def k1d(ctx, name, c=c, b=b):
            pr, rng = channel_primes(c, n), ctx.rng(name)
            fl, fr = ctx.u32(rng, (c, b, n)), ctx.u32(rng, (c, b, n))
            s = tuple(scale32(n, p) for p in pr)
            return (lambda: m.pointwise_inv_multi(fl, fr, pr, s),
                    lambda: m.pointwise_inv_multi_plain(fl, fr, pr, s), "matmod_pass")

        out.append(_kernel(f"K1d pointwise_inv_multi n={n} B={b} C={c}", n, cov, k1d))
    for c, b in ((5, 1), (2, 3)):
        def k1e(ctx, name, c=c, b=b):
            pr = channel_primes(c, n)
            xd = m.digit_planes32(ctx.u32(ctx.rng(name), (c, b, n)))
            s = tuple(scale32(n, p) for p in pr)
            return (lambda: m.inv_multi_presplit(xd, pr, s),
                    lambda: m.inv_multi_presplit_plain(xd, pr, s), "matmod_pass")

        out.append(_kernel(f"K1e inv_multi_presplit n={n} B={b} C={c}", n, (), k1e))
    return out


def lift_rows(n: int) -> list:
    """The native Plan32 lift kernels (`ops/crt_cuda.py`): native64's over
    five channels and native128's pair (digits, limbs) over ten, on
    canonical residues [C, B, n] over the primes the plans take at n; at 2^11
    also one word past an aligned base, and at n = 2 a count of 6 (their
    scalar instances)."""
    from concrete_ntt_tpu_torch.ops import crt_cuda

    cases = [(_batch(n.bit_length()), 0)]
    cases += [(3, 1)] if n == 1 << 11 else [(3, 0)] if n == 2 else []
    out = []
    for c, wrapper, match in ((5, "rec_u64_from5", "lift_u64_from5"),
                              (10, "rec_u128_from10", "lift_u128_")):
        primes = channel_primes(c, n)
        lift, plain = getattr(crt_cuda, wrapper), getattr(crt_cuda, wrapper + "_plain")
        for b, off in cases:
            def make(ctx, name, b=b, off=off, c=c, primes=primes, lift=lift, plain=plain,
                     match=match):
                rng = ctx.rng(name)
                words = np.concatenate([np.zeros(off, dtype=np.uint32)] + [
                    rng.integers(0, p, b * n, dtype=np.uint32) for p in primes])
                res = torch.from_numpy(words).to(ctx.dev)[off:].view(c, b, n)
                return lambda: lift(res, primes), lambda: plain(res, primes), match

            vec = (b * n) % 4 == 0 and off == 0
            out.append(_kernel(f"lift {wrapper} n={n} B={b}" + (f" offset={off}" if off else ""),
                               n, (), make, tiles="vector" if vec else "scalar"))
    return out


def route_passes(u32, n: int, b: int, s: int, c: int, limbs: int, pair: bool = False) -> tuple:
    """The four passes of a rank's transform pair over c channels as the
    sharded routes make them, on random operands from u32(shape, hi):
    (which, operand limb views, (first row, rows) of the rank's diagonal or
    None): A reads the value shard [b, n1, n2 / s] transposed in place (one
    operand for every channel), F the exchange's [c, b, n2, n1 / s], G
    [c, b, n1 / s, n2], A_inv the exchange's [c, b, n1, n2 / s] (written
    transposed); the rank is the last one of s. `pair`: limb pairs, F and
    A_inv's hi limb below 2^18 (mid-pass values)."""
    from concrete_ntt_tpu_torch.ops import mxu32

    n1, n2 = mxu32.four_step_factors(n)
    cs, c1 = n2 // s, n1 // s
    one = 2 if pair else 1

    def limbs_of(shape, k, mid=False):
        return tuple(u32(shape, 1 << 18 if mid and i else 1 << 32) for i in range(k))

    return (("A", tuple(t.transpose(1, 2) for t in limbs_of((b, n1, cs), one * limbs)),
             (n2 - cs, cs)),
            ("F", tuple(t.transpose(2, 3) for t in limbs_of((c, b, n2, c1), one, pair)), None),
            ("G", limbs_of((c, b, c1, n2), one), (n1 - c1, c1)),
            ("Ainv", tuple(t.transpose(2, 3) for t in limbs_of((c, b, n1, cs), one, pair)),
             None))


def _route_passes(ctx, rng, n, b, s, c, limbs, pair=False):
    """route_passes on this row's random operands."""
    return route_passes(lambda shape, hi=1 << 32: ctx.u32(rng, shape, hi), n, b, s, c, limbs, pair)


def k3_rows(n: int, shapes: tuple) -> list:
    """K3's channel grid (the sharded four-step's rank-local passes): the four
    passes of a rank's transform pair at (n, B, s, C, A-pass limbs)."""
    from concrete_ntt_tpu_torch.ops import mxu32_cuda as m

    out = []
    for b, s, c, limbs in shapes:
        def make(ctx, name, b=b, s=s, c=c, limbs=limbs):
            pr = channel_primes(c, n)
            calls = []
            for which, x, rows in _route_passes(ctx, ctx.rng(name), n, b, s, c, limbs):
                kw = dict(n=n, primes=pr, which=which, transposed_out=which == "Ainv",
                          diag=m.multi_diag(n, pr, which, *rows, str(ctx.dev)) if rows else None,
                          scales=tuple(scale32(n, q) for q in pr) if which == "Ainv" else None)
                calls.append((x if len(x) > 1 else x[0], kw))
            return (lambda: [m.pass_matmod_multi(x, **kw) for x, kw in calls],
                    lambda: [m.pass_matmod_multi_plain(x, **kw) for x, kw in calls],
                    "matmod_pass")

        out.append(_kernel(f"K3 pass_matmod_multi n={n} B={b} s={s} C={c} limbs={limbs} "
                           "(A, F, G, Ainv)", n, (), make))
    return out


def k5_rows(n: int) -> list:
    from concrete_ntt_tpu_torch.ops import mxu64_cuda as m

    cov = (("tier64", "K5"),)
    out = []
    for i, (rname, p) in enumerate(regimes()["r64"].items()):
        for b in (1, (3, 16)[i % 2]):
            def fwd(ctx, name, b=b, p=p):
                x = _pair(ctx, ctx.rng(name), (b, n))
                return (lambda: m.fwd(x, n=n, p=p), lambda: m.fwd_plain(x, n=n, p=p),
                        "matmod64_pass")

            def inv(ctx, name, b=b, p=p):
                x, s = _pair(ctx, ctx.rng(name), (b, n)), scale64(n, p)
                return (lambda: m.inv(x, n=n, p=p, scale=s),
                        lambda: m.inv_plain(x, n=n, p=p, scale=s), "matmod64_pass")

            out += [_kernel(f"K5 fwd64 n={n} B={b} {rname}", n, cov, fwd, tiles=ROWS128),
                    _kernel(f"K5 inv64 n={n} B={b} {rname} scaled", n, cov, inv, tiles=ROWS128)]
    gl = regimes()["r64"]["gl"]

    def w4(ctx, name):
        xs = tuple(ctx.u32(ctx.rng(name), (1, n)) for _ in range(4))
        return (lambda: m.fwd(xs, n=n, p=gl), lambda: m.fwd_plain(xs, n=n, p=gl),
                "matmod64_pass")

    out.append(_kernel(f"W4-64 fwd64_u128 n={n} B=1 gl", n, (), w4, tiles=ROWS128))
    return out


def k5h_rows(n: int) -> list:
    from concrete_ntt_tpu_torch.ops import mxu64_cuda as m

    cov = (("tier64", "K5h"),)
    out = []
    for i, (rname, p) in enumerate(regimes()["r64"].items()):
        for b in (1, (3, 16)[i % 2]):
            def fwd(ctx, name, b=b, p=p):
                x, kw = _pair(ctx, ctx.rng(name), (b, n)), dict(n=n, p=p, n_h=N_H)
                return (lambda: m.fwd_hyb(x, **kw), lambda: m.fwd_hyb_plain(x, **kw),
                        "matmod64_pass")

            def inv(ctx, name, b=b, p=p):
                x, kw = _pair(ctx, ctx.rng(name), (b, n)), dict(n=n, p=p, n_h=N_H,
                                                                  scale=scale64(n, p))
                return (lambda: m.inv_hyb(x, **kw), lambda: m.inv_hyb_plain(x, **kw),
                        "matmod64_pass")

            out += [_kernel(f"K5h fwd64_hyb n={n} B={b} {rname}", n, cov, fwd, tiles=ROWS128),
                    _kernel(f"K5h inv64_hyb n={n} B={b} {rname} scaled", n, cov, inv,
                            tiles=ROWS128)]
    return out


def k7_rows(n: int) -> list:
    from concrete_ntt_tpu_torch.ops import mxu64_cuda as m
    from concrete_ntt_tpu_torch.tables import PRIMES52

    cov = (("route64", "K7"),)
    out = []
    for c, b in ((3, 1), (3, 8), (1, 16), (2, 3)):
        pr = tuple(PRIMES52[:c])

        def k7a(ctx, name, b=b, pr=pr):
            x = _pair(ctx, ctx.rng(name), (b, n))
            return lambda: m.fwd_multi(x, pr), lambda: m.fwd_multi_plain(x, pr), "matmod64_pass"

        def k7d(ctx, name, b=b, c=c, pr=pr):
            rng, s = ctx.rng(name), tuple(scale64(n, p) for p in pr)
            fl, fr = _pair(ctx, rng, (c, b, n)), _pair(ctx, rng, (c, b, n))
            return (lambda: m.pointwise_inv_multi(fl, fr, pr, s),
                    lambda: m.pointwise_inv_multi_plain(fl, fr, pr, s), "matmod64_pass")

        out += [_kernel(f"K7a fwd_multi64 n={n} B={b} C={c}", n, cov, k7a, tiles=ROWS128),
                _kernel(f"K7d pointwise_inv_multi64 n={n} B={b} C={c}", n, cov, k7d,
                        tiles=ROWS128)]
    pr = tuple(PRIMES52[:3])

    def k7c(ctx, name):
        x = _pair(ctx, ctx.rng(name), (3, 1, n))
        return (lambda: m.fwd_multi_perchannel64(*x, pr),
                lambda: m.fwd_multi_perchannel64_plain(x, pr), "matmod64_pass")

    def k7b(ctx, name):
        x, s = _pair(ctx, ctx.rng(name), (3, 3, n)), tuple(scale64(n, p) for p in pr)
        return (lambda: m.inv_multi(*x, pr, s), lambda: m.inv_multi_plain(x, pr, s),
                "matmod64_pass")

    return out + [_kernel(f"K7c fwd_multi_perchannel64 n={n} B=1 C=3", n, (), k7c,
                          tiles=ROWS128),
                  _kernel(f"K7b inv_multi64 n={n} B=3 C=3 scaled", n, (), k7b, tiles=ROWS128)]


def k7h_rows(n: int) -> list:
    """The channel-grid hybrid's kernels (K7c / K7b / K7d with block tables)
    over three 50-bit primes with 2^18 | p - 1: route64's "K7h"."""
    from concrete_ntt_tpu_torch.ops import mxu64_cuda as m

    pr, cov = regimes()["p52x"], (("route64", "K7h"),)
    out = []
    for b in (1, 3):
        def k7c(ctx, name, b=b):
            x = _pair(ctx, ctx.rng(name), (3, b, n))
            return (lambda: m.fwd_multi_perchannel64(*x, pr, n_h=N_H),
                    lambda: m.fwd_multi_perchannel64_plain(x, pr, N_H), "matmod64_pass")

        def k7b(ctx, name, b=b):
            x, s = _pair(ctx, ctx.rng(name), (3, b, n)), tuple(scale64(n, p) for p in pr)
            return (lambda: m.inv_multi(*x, pr, s, n_h=N_H),
                    lambda: m.inv_multi_plain(x, pr, s, N_H), "matmod64_pass")

        def k7d(ctx, name, b=b):
            rng, s = ctx.rng(name), tuple(scale64(n, p) for p in pr)
            fl, fr = _pair(ctx, rng, (3, b, n)), _pair(ctx, rng, (3, b, n))
            return (lambda: m.pointwise_inv_multi(fl, fr, pr, s, n_h=N_H),
                    lambda: m.pointwise_inv_multi_plain(fl, fr, pr, s, N_H), "matmod64_pass")

        out += [_kernel(f"K7c-hyb fwd_multi_perchannel64 n={n} n_h={N_H} B={b} C=3", n, cov, k7c,
                        tiles=ROWS128),
                _kernel(f"K7b-hyb inv_multi64 n={n} n_h={N_H} B={b} C=3 scaled", n, cov, k7b,
                        tiles=ROWS128),
                _kernel(f"K7d-hyb pointwise_inv_multi64 n={n} n_h={N_H} B={b} C=3", n, cov, k7d,
                        tiles=ROWS128)]
    return out


def k6_rows(n: int, shapes: tuple) -> list:
    """K6's channel grid over Plan52's primes at (n, B, s, C)."""
    from concrete_ntt_tpu_torch.ops import mxu64_cuda as m
    from concrete_ntt_tpu_torch.tables import PRIMES52

    out = []
    for b, s, c in shapes:
        def make(ctx, name, b=b, s=s, c=c):
            pr = tuple(PRIMES52[:c])
            calls = []
            for which, x, rows in _route_passes(ctx, ctx.rng(name), n, b, s, c, 1, pair=True):
                kw = dict(n=n, primes=pr, which=which, transposed_out=which == "Ainv",
                          diag=m.multi_diag(n, pr, which, *rows, str(ctx.dev)) if rows else None,
                          scales=tuple(scale64(n, q) for q in pr) if which == "Ainv" else None)
                calls.append((x, kw))
            return (lambda: [m.pass_matmod64_multi(x, **kw) for x, kw in calls],
                    lambda: [m.pass_matmod64_multi_plain(x, **kw) for x, kw in calls],
                    "matmod64_pass")

        out.append(_kernel(f"K6 pass_matmod64_multi n={n} B={b} s={s} C={c} (A, F, G, Ainv)",
                           n, (), make))
    return out


def k2h_rows(n: int) -> list:
    """K2 with block tables and the whole 32-bit hybrid (`engine32_fused`),
    which no route takes."""
    from concrete_ntt_tpu_torch.ops import mxu32_cuda as m
    from concrete_ntt_tpu_torch.ops import stagesplit

    r32 = regimes()["r32"]
    out = []
    for rname in ("lt30", "gen5"):
        p = r32[rname]
        for b in (1, 3):
            def fwd(ctx, name, b=b, p=p):
                x, kw = ctx.u32(ctx.rng(name), (b, n)), dict(n=n, p=p, n_h=N_H)
                return lambda: m.fwd_hyb(x, **kw), lambda: m.fwd_hyb_plain(x, **kw), "matmod_pass"

            def inv(ctx, name, b=b, p=p):
                x = ctx.u32(ctx.rng(name), (b, n))
                kw = dict(n=n, p=p, n_h=N_H, scale=scale32(n, p))
                return lambda: m.inv_hyb(x, **kw), lambda: m.inv_hyb_plain(x, **kw), "matmod_pass"

            out += [_kernel(f"K2h fwd_hyb n={n} n_h={N_H} B={b} {rname}", n, (), fwd),
                    _kernel(f"K2h inv_hyb n={n} n_h={N_H} B={b} {rname} scaled", n, (), inv)]
    p = r32["lt30"]

    def eng_fwd(ctx, name):
        x = ctx.u32(ctx.rng(name), (3, n), p)
        return (lambda: stagesplit.engine32_fused.fwd(x, n=n, p=p),
                lambda: stagesplit.fwd32(x, n=n, p=p), "matmod_pass")

    def eng_inv(ctx, name):
        x, s = ctx.u32(ctx.rng(name), (3, n), p), scale32(n, p)
        return (lambda: stagesplit.engine32_fused.inv(x, n=n, p=p, scale=s),
                lambda: stagesplit.inv32(x, n=n, p=p, scale=s), "matmod_pass")

    return out + [_kernel(f"engine32_fused fwd n={n} B=3 lt30", n, (), eng_fwd),
                  _kernel(f"engine32_fused inv n={n} B=3 lt30 scaled", n, (), eng_inv)]


# -- plan rows --------------------------------------------------------------------

# (module, tier, width, channels) of the native plans
NATIVE = (("native32", "Plan32", 32, 3), ("native32", "Plan52", 32, 2),
          ("native64", "Plan32", 64, 5), ("native64", "Plan52", 64, 3),
          ("native128", "Plan32", 128, 10), ("native_binary32", "Plan32", 32, 2),
          ("native_binary32", "Plan52", 32, 1), ("native_binary64", "Plan32", 64, 3),
          ("native_binary64", "Plan52", 64, 2), ("native_binary128", "Plan32", 128, 5))


def _ints(limbs: np.ndarray) -> list:
    """[n, k] uint32 limbs (little-endian) -> n Python ints."""
    cols = [limbs[:, i].tolist() for i in range(limbs.shape[1])]
    return [sum(c[j] << (32 * i) for i, c in enumerate(cols)) for j in range(limbs.shape[0])]


def _uniform(rng, b: int, n: int, hi: int) -> list:
    """b rows of n ints uniform below hi (hi <= 2^128)."""
    if hi <= 1 << 64:
        return rng.integers(0, hi, (b, n), dtype=np.uint64).tolist()
    lo, top = (rng.integers(0, 1 << 64, (b, n), dtype=np.uint64).astype(object) for _ in range(2))
    return ((top << 64 | lo) % hi).tolist()


def _operand(rng, first: list, b: int, hi: int) -> list:
    """b rows of ints: `first`, then uniform below hi."""
    return [list(first)] + _uniform(rng, b - 1, len(first), hi)


def _native_arg(rows: list, width: int, device):
    """The plan's input: uint32 numpy [B, n], uint64 numpy, or a [B, n, 4]
    uint32 limb tensor on the plan's device."""
    if width == 32:
        return np.array(rows, dtype=np.uint32)
    if width == 64:
        return np.array(rows, dtype=np.uint64)
    limbs = np.array([[[(v >> (32 * k)) & 0xFFFFFFFF for k in range(4)] for v in r] for r in rows],
                     dtype=np.uint32)
    return torch.from_numpy(limbs).to(device)


def _native_out(out) -> np.ndarray:
    """A plan's output as numpy: [B, n] (width 32 / 64) or [B, n, 4]."""
    return out.cpu().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)


def native_row(n: int, module: str, tier: str, width: int, c: int) -> Row | None:
    """A native plan's polymul at n, where the plan exists (its primes have a
    2n-th root of unity)."""
    from concrete_ntt_tpu_torch.ops import ntt_dispatch as nd
    from concrete_ntt_tpu_torch.tables import PRIMES52

    primes = channel_primes(c, n) if tier == "Plan32" else tuple(PRIMES52[:c])
    if primes is None or any((p - 1) % (2 * n) for p in primes):
        return None
    cls = getattr(importlib.import_module(f"concrete_ntt_tpu_torch.{module}"), tier)
    binary = module.startswith("native_binary")
    fn = "route32" if tier == "Plan32" else "route64"
    value = (nd.route32 if tier == "Plan32" else nd.route64)(n, primes)
    lk, rk = f"u{width}", ("bin" if binary else f"u{width}")

    def run(ctx, name):
        plan = cls.try_new(n, device=str(ctx.dev))
        rng = ctx.rng(name)
        a1, b1 = ctx.first_rows(n, lk, rk)
        lhs = _operand(rng, a1, B_NATIVE, 1 << width)
        rhs = _operand(rng, b1, B_NATIVE, 2 if binary else 1 << width)
        out = _native_out(plan.negacyclic_polymul(_native_arg(lhs, width, ctx.dev),
                                                  _native_arg(rhs, width, ctx.dev)))
        mask = (1 << width) - 1
        got0 = _ints(out[0]) if width == 128 else out[0].tolist()
        check_first_row(ctx, got0, n, lk, rk, lambda k, v: v & mask)
        detail = "first row vs the exact product"
        if not ctx.quick and width < 128 and n <= 1 << 14:
            from concrete_ntt_tpu_torch.golden.polymul import negacyclic_convolution_wrapping_np

            dt = np.uint32 if width == 32 else np.uint64
            la, ra = np.array(lhs, dtype=dt), np.array(rhs, dtype=dt)
            bad = [i for i in range(B_NATIVE)
                   if not np.array_equal(out[i], negacyclic_convolution_wrapping_np(la[i], ra[i]))]
            if bad:
                raise Mismatch(f"rows {bad} differ from the numpy wrapping oracle")
            detail += f", all {B_NATIVE} rows vs the numpy wrapping oracle"
        return detail

    return Row(name=f"plan {module}.{tier} polymul n={n} B={B_NATIVE} route {value}", kind="plan",
               n=n, covers=((fn, value),), run=run)


def prime32_row(n: int, rname: str, p: int, b: int) -> Row:
    from concrete_ntt_tpu_torch import prime32
    from concrete_ntt_tpu_torch.ops import ntt_dispatch as nd

    tier = nd.tier32(n, p, variant32(p))

    def run(ctx, name):
        plan = prime32.Plan.new(n, p, device=str(ctx.dev))
        rng = ctx.rng(name)
        a1, b1 = ctx.first_rows(n, "u32", "u32")
        lhs = _operand(rng, [v % p for v in a1], b, p)
        rhs = _operand(rng, [v % p for v in b1], b, p)
        out = plan.negacyclic_polymul(np.array(lhs, dtype=np.uint32),
                                      np.array(rhs, dtype=np.uint32))
        check_first_row(ctx, out[0].cpu().numpy().tolist(), n, "u32", "u32", lambda k, v: v % p)
        return "first row vs the exact product"

    return Row(name=f"plan prime32 polymul n={n} B={b} {rname} tier {tier}", kind="plan", n=n,
               covers=(("tier32", tier),), run=run)


def prime64_row(n: int, rname: str, p: int, b: int) -> Row:
    from concrete_ntt_tpu_torch import prime64
    from concrete_ntt_tpu_torch.ops import ntt_dispatch as nd

    tier = nd.tier64(n, p)

    def run(ctx, name):
        plan = prime64.Plan.new(n, p, device=str(ctx.dev))
        rng = ctx.rng(name)
        a1, b1 = ctx.first_rows(n, "u64", "u64")
        lhs = _operand(rng, [v % p for v in a1], b, p)
        rhs = _operand(rng, [v % p for v in b1], b, p)
        out = plan.negacyclic_polymul(np.array(lhs, dtype=np.uint64),
                                      np.array(rhs, dtype=np.uint64))
        check_first_row(ctx, np.asarray(out)[0].tolist(), n, "u64", "u64", lambda k, v: v % p)
        return "first row vs the exact product"

    return Row(name=f"plan prime64 polymul n={n} B={b} {rname} tier {tier}", kind="plan", n=n,
               covers=(("tier64", tier),), run=run)


def product_rows(n: int) -> list:
    from concrete_ntt_tpu_torch import product
    from concrete_ntt_tpu_torch.ops import ntt_dispatch as nd

    r = regimes()
    r32 = r["r32"]
    sets = {"2x30": channel_primes(2, n), "lt31+gen5": (r32["lt31"], r32["gen5"]),
            "small+lt30": (r["small"], r32["lt30"]), "lt30+p34": (r32["lt30"], r["p34"])}
    out = []
    for i, (sname, factors) in enumerate(sets.items()):
        modulus = factors[0] * factors[1]
        value = nd.route32(n, tuple(f for f in factors if f < 1 << 32))
        covers = (("route32", value),) + ((("tier64", nd.tier64(n, factors[1])),)
                                          if factors[1] >= 1 << 32 else ())
        for j, mode in enumerate(("replace", "accumulate", "bounded")):
            if mode == "bounded" and factors[1] >= 1 << 32:
                continue  # Bounded takes two u32 channels (product.rs:303-322)
            b = _batch(i + j)

            def run(ctx, name, factors=factors, modulus=modulus, mode=mode, b=b):
                plan = product.Plan.new(n, modulus, factors, device=str(ctx.dev))
                rng = ctx.rng(name)
                lk = "small" if mode == "bounded" else "u64"
                a1, b1 = ctx.first_rows(n, lk, "u64")
                if mode == "bounded":
                    small = rng.integers(-(BOUND // 2) + 1, BOUND // 2, (b - 1, n)).tolist()
                    lhs = [[v % modulus for v in row] for row in [a1] + small]
                else:
                    lhs = _operand(rng, a1, b, 1 << 64)
                rhs = _operand(rng, b1, b, 1 << 64)
                std = _uniform(rng, b, n, modulus)
                kw = {}
                if mode == "accumulate":
                    kw = dict(mode=product.ACCUMULATE, standard=np.array(std, dtype=np.uint64))
                elif mode == "bounded":
                    kw = dict(lhs_fwd_mode=product.bounded(BOUND))
                got = np.asarray(plan.negacyclic_polymul(np.array(lhs, dtype=np.uint64),
                                                         np.array(rhs, dtype=np.uint64), **kw))
                add = std[0] if mode == "accumulate" else [0] * n
                check_first_row(ctx, got[0].tolist(), n, lk, "u64",
                                lambda k, v: (add[k] + v) % modulus)
                return "first row vs the exact product"

            out.append(Row(name=f"plan product {mode} polymul n={n} B={b} {sname} route {value}",
                           kind="plan", n=n, covers=covers, run=run))
    return out


def route_rows(n: int) -> list:
    """The dispatcher's channel functions on prime sets that no public plan
    holds: each channel's residues of the product of the shared u64 rows."""
    from concrete_ntt_tpu_torch.ops import ntt_dispatch as nd

    r = regimes()
    r32 = r["r32"]
    out = []
    cases = [("route32", (r32["lt31"], r32["gen4"], r32["gen5"]), 3)]
    if n <= 1 << 15:
        cases.append(("route64", r["p52x"], 1))
    cases += [("route64", r["p52x"][:2] if n <= 1 << 15 else r["p52x"], 16),
              ("route64", (r["r64"]["p50"], r["r64"]["p63"]), 1)]
    for fn, primes, b in cases:
        value = (nd.route32 if fn == "route32" else nd.route64)(n, primes)
        if value is None:
            continue

        def run(ctx, name, fn=fn, primes=primes, b=b):
            rng = ctx.rng(name)
            a1, b1 = ctx.first_rows(n, "u64", "u64")
            lhs, rhs = _operand(rng, a1, b, 1 << 64), _operand(rng, b1, b, 1 << 64)
            parts = [tuple(torch.from_numpy(np.array([[(v >> s) & 0xFFFFFFFF for v in row]
                                                       for row in x], dtype=np.uint32)).to(ctx.dev)
                           for s in (0, 32)) for x in (lhs, rhs)]
            chans = tuple(Chan(p) for p in primes)
            if fn == "route32":
                fl, fr = (nd.try_fwd32_wide_all(x, chans) for x in parts)
                res = nd.try_pointwise_inv32_all(fl, fr, chans).cpu().numpy().astype(np.uint64)
            else:
                fl, fr = (nd.try_fwd64_wide_all(x, chans) for x in parts)
                lo, hi = (t.cpu().numpy().astype(np.uint64)
                          for t in nd.try_pointwise_inv64_all(fl, fr, chans))
                res = lo | (hi << np.uint64(32))
            for c, p in enumerate(primes):
                check_first_row(ctx, res[c, 0].tolist(), n, "u64", "u64", lambda k, v, p=p: v % p)
            return f"{len(primes)} channels' first rows vs the exact product"

        out.append(Row(name=f"route {fn} -> {value} n={n} B={b} primes {primes}", kind="route",
                       n=n, covers=((fn, value),), run=run))
    return out


def fixture_rows() -> list:
    """The dense fixture (tests/fixtures/dense_oracle_2048.json): five native
    plans at N = 2048, the K1 route at 2^11, against SHA-256 digests of the
    exact wrapping products."""
    out = []
    for key, module, tier in (("native32", "native32", "Plan32"),
                              ("native64", "native64", "Plan32"),
                              ("native64", "native64", "Plan52"),
                              ("native128", "native128", "Plan32"),
                              ("native_binary64", "native_binary64", "Plan32")):
        def run(ctx, name, key=key, module=module, tier=tier):
            fix = dense_fixture()
            plan = getattr(importlib.import_module(f"concrete_ntt_tpu_torch.{module}"),
                           tier).try_new(fix["n"], device=str(ctx.dev))
            a, b, nbytes = dense_inputs(fix)[key]
            width = nbytes * 8
            out = _native_out(plan.negacyclic_polymul(_native_arg([a], width, ctx.dev),
                                                      _native_arg([b], width, ctx.dev)))[0]
            got = digest(_ints(out) if width == 128 else out.tolist(), nbytes)
            if got != fix["digests"][key]:
                raise Mismatch(f"digest {got[:16]}... != the fixture's "
                               f"{fix['digests'][key][:16]}...")
            return "SHA-256 digest equal"

        out.append(Row(name=f"fixture {module}.{tier} polymul n=2048 B=1 (dense oracle digest)",
                       kind="fixture", n=2048, covers=(), run=run))
    return out


def dense_fixture() -> dict:
    with open(FIXTURE) as f:
        return json.load(f)


def dense_inputs(fix: dict) -> dict:
    """{digest key: (lhs ints, rhs ints, bytes a coefficient)} drawn as
    tools/make_dense_fixture.py draws them."""
    rng = np.random.default_rng(fix["seed"])
    n = fix["n"]
    a64 = rng.integers(0, 1 << 64, n, dtype=np.uint64).tolist()
    b64 = rng.integers(0, 1 << 64, n, dtype=np.uint64).tolist()
    a32 = rng.integers(0, 1 << 32, n, dtype=np.uint64).tolist()
    b32 = rng.integers(0, 1 << 32, n, dtype=np.uint64).tolist()
    a128, b128 = ([int(lo) | (int(hi) << 64) for lo, hi in zip(
        rng.integers(0, 1 << 64, n, dtype=np.uint64), rng.integers(0, 1 << 64, n, dtype=np.uint64))]
        for _ in range(2))
    bbin = rng.integers(0, 2, n, dtype=np.uint64).tolist()
    return {"native32": (a32, b32, 4), "native64": (a64, b64, 8), "native128": (a128, b128, 16),
            "native_binary64": (a64, bbin, 8)}


def digest(vals, nbytes: int) -> str:
    h = hashlib.sha256()
    for v in vals:
        h.update(int(v).to_bytes(nbytes, "little"))
    return h.hexdigest()


def rows(quick: bool = False) -> list:
    """Every row of the sweep in the order they run (by n, so that each
    size's tables are built once), or the --quick subset: n in QUICK_N."""
    r = regimes()
    ns = [n for n in N_SMALL + N_FOURSTEP if not quick or n in QUICK_N]
    out = fixture_rows()
    for n in ns:
        if n in N_FOURSTEP:
            out += k2_rows(n) + k1_rows(n)
            out += k3_rows(n, ((1, 2, (1, 2, 3, 5)[n.bit_length() % 4],
                                (1, 2, 4)[n.bit_length() % 3]),))
            if n <= 1 << 15:
                out += k5_rows(n) + k7_rows(n) + k6_rows(n, ((1, 2, 3),))
            else:
                out += k5h_rows(n) + k7h_rows(n)
            if n > N_H:
                out += k2h_rows(n)
            if n == 1 << 14:  # the sharded routes' rank-local shapes (chip_smoke phase `sharded`)
                out += k3_rows(n, ((4, 2, 1, 1), (1, 2, 1, 1))) + k6_rows(n, ((4, 2, 3),))
            if n == 1 << 16:
                out += k3_rows(n, ((8, 2, 5, 4), (1, 2, 5, 4)))
            out += route_rows(n)
        out += k4_rows(n) + lift_rows(n)
        out += [row for spec in NATIVE if (row := native_row(n, *spec)) is not None]
        for i, (rname, p) in enumerate((*r["r32"].items(), ("small", r["small"]))):
            out.append(prime32_row(n, rname, p, _batch(i)))
        for i, (rname, p) in enumerate(r["r64"].items()):
            out.append(prime64_row(n, rname, p, _batch(i)))
        out += product_rows(n)
    if not quick:
        out.append(prime32_row(N_STAGE32, "stage32", r["stage32"], 1))
    return out


# ---------------------------------------------------------------------------
# running
# ---------------------------------------------------------------------------


def _tile_counts() -> dict:
    from concrete_ntt_tpu_torch.ops import mxu32_cuda, mxu64_cuda

    return {**dict(mxu32_cuda.TILE_LAUNCHES), **dict(mxu64_cuda.TILE_LAUNCHES)}


def check_row(ctx: Ctx, row: Row) -> str:
    """Run one row; its detail string, or raise."""
    if row.kind != "kernel":
        return row.run(ctx, row.name)
    kern, plain, _ = row.make(ctx, row.name)
    before = _tile_counts()
    got = kern()
    after = _tile_counts()
    want = plain()
    if ctx.dev.type == "cuda":
        torch.cuda.synchronize()
    if not same_bits(got, want):
        raise Mismatch("differs from its plain twin")
    ran = sorted(k[1:] for k in after if after[k] != before.get(k, 0))
    if row.tiles is not None:
        tiles = row.tiles() if callable(row.tiles) else row.tiles
    else:
        tiles = ", ".join(map(str, ran)) if ran else "not counted"
    return f"tiles {tiles}"


def run_rows(ctx: Ctx, selected: list, times: bool = False, out=print) -> tuple:
    """Check every row (kernel rows only on the card), print one PASS / FAIL
    line a row (after the profiler session with `times`); (passed, failed
    names)."""
    lines, failed = [], []
    for row in selected:
        try:
            detail = check_row(ctx, row)
            lines.append([row, "PASS", detail])
        except Exception as e:  # a failed build or launch is a FAIL of its row
            failed.append(row.name)
            lines.append([row, "FAIL", f"{type(e).__name__}: {e}"])
        if not times:
            out(_line(*lines[-1]))
    if times:
        kernels = [(i, ln[0]) for i, ln in enumerate(lines) if ln[0].kind == "kernel"
                   and ln[1] == "PASS"]
        tasks = [(i, (lambda row=row: _timed(ctx, row)), None) for i, row in kernels]
        from concrete_ntt_tpu_torch.utils.profiling import device_times

        dev_ms = device_times(tasks, REPS)
        for i, _ in kernels:
            ms = dev_ms.get(i)
            lines[i][2] += f" | device {ms:.4f} ms" if ms is not None else " | device not measured"
        for ln in lines:
            out(_line(*ln))
    return len(selected) - len(failed), failed


def _timed(ctx: Ctx, row: Row):
    kern, _, match = row.make(ctx, row.name)
    return kern, lambda name: match in name


def _line(row: Row, status: str, detail: str) -> str:
    return f"{status} {row.name} | {detail}"


def build_all(out=print) -> list:
    """Build the five CUDA sources with nvcc in parallel, one PASS / FAIL
    line each; the names of the sources that failed."""
    from concurrent.futures import ThreadPoolExecutor

    from concrete_ntt_tpu_torch.ops import cuda_build

    def one(name):
        t0 = time.perf_counter()
        try:
            cuda_build.load(name)
        except (RuntimeError, OSError) as e:
            return name, f"FAIL build csrc/{name}.cu | {type(e).__name__}: {str(e)[-2000:]}"
        return name, f"PASS build csrc/{name}.cu | {time.perf_counter() - t0:.1f} s"

    with ThreadPoolExecutor(len(cuda_build.SOURCES)) as pool:
        results = list(pool.map(one, cuda_build.SOURCES))
    for _, line in results:
        out(line)
    return [name for name, line in results if line.startswith("FAIL")]


def kernel_hash() -> str:
    """sha256 over the kernel sources: csrc/* and ops/*_cuda.py."""
    pkg = os.path.join(ROOT, "concrete_ntt_tpu_torch")
    files = sorted([os.path.join("csrc", f) for f in os.listdir(os.path.join(pkg, "csrc"))] +
                   [os.path.join("ops", f) for f in os.listdir(os.path.join(pkg, "ops"))
                    if f.endswith("_cuda.py")])
    h = hashlib.sha256()
    for rel in files:
        h.update(rel.encode())
        with open(os.path.join(pkg, rel), "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def head_commit() -> str:
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT, capture_output=True,
                             text=True, timeout=30)
    except OSError:
        return "unknown"
    return out.stdout.strip() or "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help=f"only n in {QUICK_N}, sampled oracle")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--times", action="store_true",
                    help="device ms of each kernel row (one torch.profiler session)")
    ap.add_argument("--only", help="run only the rows whose name matches this regex")
    ap.add_argument("--commit", help="the commit to name where the checkout is no git repository")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("gpu_parity: torch.cuda.is_available() is False; this gate needs a CUDA GPU "
              "(--device cpu runs the plain path against the oracle)", file=sys.stderr)
        return 2
    if args.device == "cpu" and args.times:
        print("gpu_parity: --times needs the card", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    selected = [row for row in rows(args.quick)
                if (args.device == "cuda" or row.kind != "kernel")
                and (args.only is None or re.search(args.only, row.name))]
    if args.device == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                              "-i", "0"], capture_output=True, text=True, check=True).stdout.strip()
        card = f"{torch.cuda.get_device_name(0)} | nvidia-smi: {smi}"
    else:
        card = "cpu (plain path against the oracle; no kernel row)"
    print(f"# gpu_parity HEAD={args.commit or head_commit()} kernels sha256={kernel_hash()}",
          flush=True)
    print(f"# device: {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
          f"{'quick' if args.quick else 'full'} | {len(selected)} rows | seed {SEED}",
          flush=True)
    from concrete_ntt_tpu_torch.ops import cuda_build

    emit = lambda s: print(s, flush=True)
    bad_builds = build_all(emit) if args.device == "cuda" else []
    n_builds = len(cuda_build.SOURCES) if args.device == "cuda" else 0
    passed, failed = run_rows(Ctx(args.device, args.quick, SEED), selected, args.times, emit)
    passed += n_builds - len(bad_builds)
    failed += bad_builds
    print(f"# {passed} PASS, {len(failed)} FAIL of {len(selected) + n_builds} checks in "
          f"{time.perf_counter() - t0:.0f} s", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
