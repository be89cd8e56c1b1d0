#!/usr/bin/env python3
"""On-card bit-exactness gate of the PyTorch + CUDA port, the twin of
tools/tpu_parity.py.

Rows are enumerated from the dispatcher, not hand-picked: n walks 2^11 ...
2^17 (the butterfly kernel K4 from 2 up, the prime32 stage engine at 2^18)
through `ops/ntt_dispatch.route32`, `tier32`, `tier64` and `route64` over
the regime primes of `regimes()`, and every value those functions return
appears at every n that returns it (`walk()`; tests/test_torch_gpu_parity.py
holds the row list to it), with the native64 and native128 Plan32 lift
kernels and the Plan32 polymul's pointwise product at every n.
Beside the routes, the ported entry points that no route takes: K1e, K2
with block tables (K2h) and `engine32_fused`, the 32-bit channel grid with
block tables and its four hybrids, K5 with the four limbs of a u128 operand
(W4-64), K1c / K1d (the product plan's), K7b / K7c, the 64-bit hybrids where
K5 and K7 also serve n = 2^15, K3 `pass_matmod` and K6 `pass_matmod64` (the
JAX twins), and the sharded routes' K3 / K6 channel grids at their
rank-local shapes in this process. Axes: B in {1, 3, 16} (8 for the native
plans; 2 at 2^12 and 5 at 2^13 for ragged row tiles), the 32-bit regimes
lt30, lt31, gen4 and gen5 (four and five digit planes), the 64-bit regimes
p50, p62, p63, Goldilocks and p64 and the eight (digit planes, epilogue)
instances of the 64-bit pass, operand limbs 1 / 2 / 4, CRT channels 2 / 3 /
5 / 10; the tile codes every rule picks (K1c / K1d's eight instances, K3's
codes 0-3 and K6's 0-1 launched) and, forced, every code pair of K2h and
K1e.

Each row is one check, printed as one PASS / FAIL line:
  * a kernel row holds the wrapper against its plain torch twin on the card,
    bit for bit (a kernel that does not build or launch is a FAIL), and
    where it is there for tile instances, each of them launched (`ran`);
  * a plan row holds `negacyclic_polymul` of one of the ten public plans
    (native32 / 64 / 128 and native_binary32 / 64 / 128 in each tier a
    family has, prime32, prime64, product in Replace / Accumulate /
    Bounded) against an oracle that shares nothing with the port's host
    tables: the first row of the batch against an exact integer
    convolution (`exact_negacyclic`: the golden `fwd` / `inv` over primes
    >= 2^61 and the golden CRT), reduced by the plan's modulus or width;
    every row for the native u32 / u64 plans up to 2^14 against the numpy
    wrapping oracle; under --quick, sampled coefficients of the first row
    (`negacyclic_coefficients_wrapping`) and, on the card, every row
    against the same plan on the CPU (`on_cpu`); a round-trip row a plan's
    inv(fwd(x)) against n·x, and the PBS-loop row (16 terms) the product
    plan's Bounded forwards, `mul_accumulate` and Accumulate inverse
    against the exact sum (sampled coefficients; under --quick on the card
    also every row against the CPU);
  * native64 Plan52 also at the shape of the benchmark cell
    native64-plan52-n16384-b256 (n = 2^14, B = 256, planar operands): the
    first row against the exact product, every row against native64
    Plan32 on the same operands;
  * a route row drives the dispatcher's channel functions
    (`try_fwd*_wide_all`, `try_pointwise_inv*_all`) on prime sets no plan
    holds and checks each channel's residues against the same oracle;
  * a fixture row holds five native plans at N = 2048 against the SHA-256
    digests of tests/fixtures/dense_oracle_2048.json.
Every plan, route and fixture row first holds the dispatcher to the routes
the gate writes out for its primes and n (`ROUTES`, `Row.routes`), on every
device. On the card it also holds its call's launches, read through
`utils/profiling.launch_counts`, to those of these routes (`Row.launches`,
from `native_launches`, `product_launches`, `route_launches` and
`tier_launches`) and nothing else.

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
# the main paths' n and channels (native64 Plan32 at 2^14 over 5 primes, its
# u64 operand in 2 limbs, a binary one in 1; native128 at 2^16 over 10, 4
# limbs): K1a, K1b and the lift kernels also run there at B_NATIVE
MAIN_PATHS = {1 << 14: (5, (1, 2)), 1 << 16: (10, (4,))}
K4_PAIR_B = 80  # K4 at 2^14 takes clusters of two blocks a polynomial at this batch
B_ROUND = 3  # rows of a plan's round trip inv(fwd(x))
PBS_TERMS = 16  # digits a PBS-loop row accumulates
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
    string). `routes`: (dispatcher function, prime or primes, value) that
    the dispatcher must return at n (`ROUTES`), on every device. On the card,
    `launches` ({name: launches}, the keys of `utils/profiling.launch_counts`)
    is what the row's call must launch and nothing else: those routes'
    kernels; `ran` the (name, tile codes...) launches it must make
    (`utils/profiling.tile_counts`): every tile instance the row is there
    for."""

    def __init__(self, name: str, kind: str, n: int, covers: tuple = (), make=None, run=None,
                 tiles=None, launches=None, ran=frozenset(), routes=()):
        self.name, self.kind, self.n, self.covers = name, kind, n, covers
        self.make, self.run, self.tiles = make, run, tiles
        self.launches, self.ran, self.routes = launches, ran, routes


class Mismatch(AssertionError):
    pass


class Ctx:
    def __init__(self, device: str, quick: bool, seed: int):
        self.dev = torch.device(device)
        self.quick = quick
        self.seed = seed
        self._exact = {}
        self.max_err = {}  # launch-counter key -> largest kernel-row error (card only)

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


# -- the routes and their launches ------------------------------------------------

#: the value each dispatcher function is to return for a kind of prime or prime
#: set, at n below 2^11, from 2^11 to 2^15, at 2^16 and 2^17, and at 2^18. Written
#: out, not asked of the dispatcher: every plan, route and fixture row holds
#: the dispatcher to these values (`Row.routes`) and its launches to theirs
ROUTES = {
    "tier32": ("K4", "K2", "K2", "stage"),              # a prime >= 2^26
    "tier32 small": ("K4", "K4", "K4", "stage"),        # a prime < 2^26
    "tier64": ("stage", "K5", "K5h", "K5h"),
    "route32 30-bit": (None, "K1", "K1", None),         # every prime 2^29 < p < 2^30
    "route32": (None, "K2", "K2", None),                # primes >= 2^26, one above 2^30
    "route32 small": (None, None, None, None),          # a prime < 2^26 among them
    "route64 50-bit": (None, "K7", "K7h", "K7h"),       # the 50-bit channel-grid primes
    "route64": (None, "K5", "K5h", "K5h"),              # primes whose digit planes differ
}

# the launch-counter keys (`utils/profiling.launch_counts`) of a single-prime
# tier's forward and inverse; the stage engines launch nothing
TIER_KEYS = {"K2": ("fwd", "inv"), "K4": ("butterfly32_fwd", "butterfly32_inv"),
             "K5": ("fwd64", "inv64"), "K5h": ("fwd64_hyb", "inv64_hyb")}


def route_of(kind: str, n: int):
    return ROUTES[kind][0 if n < 1 << 11 else 1 if n <= 1 << 15 else 2 if n <= 1 << 17 else 3]


def held(n: int, *specs) -> tuple:
    """`Row.routes` of (kind, prime or primes) specs: (dispatcher function,
    prime or primes, the value ROUTES gives at n)."""
    return tuple((kind.split()[0], arg, route_of(kind, n)) for kind, arg in specs)


def dispatched(fn: str, n: int, arg):
    """What the dispatcher function `fn` returns at n for a prime or primes."""
    from concrete_ntt_tpu_torch.ops import ntt_dispatch as nd

    if fn == "tier32":
        return nd.tier32(n, arg, variant32(arg))
    return nd.tier64(n, arg) if fn == "tier64" else getattr(nd, fn)(n, arg)


def _sum(*parts) -> dict:
    """The launch dicts added key by key, without zeros."""
    out = {}
    for part in parts:
        for k, v in part.items():
            out[k] = out.get(k, 0) + v
    return {k: v for k, v in out.items() if v}


def tier_launches(tier: str, fwd: int, inv: int) -> dict:
    keys = TIER_KEYS.get(tier)
    return _sum({keys[0]: fwd, keys[1]: inv}) if keys else {}


def _tiers(routes: tuple, fwd: int, inv: int) -> dict:
    """Each channel on its own plan: the launches of the tiers among routes."""
    return _sum(*(tier_launches(v, fwd, inv) for fn, _, v in routes if fn.startswith("tier")))


def route_launches(route: str, k: int) -> dict:
    """One polymul through the dispatcher's channel functions (two wide
    forwards, the pointwise product and inverse) over k channels on `route`."""
    return {"K1": {"fwd_wide_multi": 2, "pointwise_inv_multi": 1},
            "K2": {"fwd": 2 * k, "inv": k},
            "K7": {"fwd_multi64": 2, "pointwise_inv_multi64": 1},
            "K7h": {"fwd_multi_perchannel64_hyb": 2, "pointwise_inv_multi64_hyb": 1},
            "K5": {"fwd64": 2 * k, "inv64": k},
            "K5h": {"fwd64_hyb": 2 * k, "inv64_hyb": k}}[route]


def native_launches(module: str, tier: str, width: int, n: int, primes: tuple) -> tuple:
    """(polymul, fwd, inv) launches of a native plan at n and its routes: the
    channel grid (K1 / K7 / K7h; a Plan32 polymul on K1 launches the pointwise
    product between the forwards and K1b), else each channel's plan; native64
    and native128 Plan32 lift through their lift kernels, every other plan in
    plain torch."""
    if tier == "Plan52":
        chans = held(n, *(("tier64", p) for p in primes))
        routes = held(n, ("route64 50-bit", primes)) + chans
        inv = _tiers(chans, 0, 1)  # Plan52's inverse: each channel's plan
        route = routes[0][2]
        if route in ("K7", "K7h"):
            fwd = {"fwd_multi64" if route == "K7" else "fwd_multi_perchannel64_hyb": 1}
            pw = {"pointwise_inv_multi64" if route == "K7" else "pointwise_inv_multi64_hyb": 1}
            return _sum(fwd, fwd, pw), fwd, inv, routes
        fwd = _tiers(chans, 1, 0)
        return _sum(fwd, fwd, inv), fwd, inv, routes
    lift = {"native64": {"lift_u64_from5": 1},
            "native128": {"lift_u128_digits": 1, "lift_u128_limbs": 1}}.get(module, {})
    routes = held(n, ("route32 30-bit", primes))
    if routes[0][2] == "K1":
        wide = "fwd_wide_multi_u128" if width == 128 else "fwd_wide_multi"
        rhs = "fwd_wide_multi" if module.startswith("native_binary") else wide
        return (_sum({wide: 1}, {rhs: 1}, {"pointwise_mont32": 1}, {"inv_multi": 1}, lift),
                {wide: 1}, _sum({"inv_multi": 1}, lift), routes)
    chans = held(n, *(("tier32", p) for p in primes))
    fwd, inv = _tiers(chans, 1, 0), _tiers(chans, 0, 1)
    return _sum(fwd, fwd, inv, lift), fwd, _sum(inv, lift), routes + chans


def product_launches(n: int, factors: tuple, kinds: tuple, op: str) -> tuple:
    """(launches, routes) of a product plan's `op`: "polymul", "bounded" (the
    polymul with a Bounded lhs forward), "fwd", "fwd bounded" or "inv".
    kinds: the ROUTES kind of the u32 factors as a set, then of each factor.
    The u32 channels take their route or each its own plan; the u64 channels
    each their prime64 plan; a u32-only plan on a route fuses the polymul's
    pointwise product into its inverse."""
    set_kind, *kind_of = kinds
    p32 = tuple(f for f, k in zip(factors, kind_of) if k.startswith("tier32"))
    chans = held(n, *zip(kind_of, factors))
    routes = held(n, (set_kind, p32)) + chans
    route = routes[0][2]
    c32 = tuple(r for r in chans if r[0] == "tier32")
    c64 = tuple(r for r in chans if r[0] == "tier64")

    def fwd32(bounded):
        if route == "K1":
            return {"fwd_multi_perchannel" if bounded else "fwd_wide_multi": 1}
        return {"fwd": len(p32)} if route == "K2" else _tiers(c32, 1, 0)

    inv32 = ({"inv_multi": 1} if route == "K1" else {"inv": len(p32)} if route == "K2"
             else _tiers(c32, 0, 1))
    if op in ("fwd", "fwd bounded"):
        return _sum(fwd32(op == "fwd bounded"), _tiers(c64, 1, 0)), routes
    if op == "inv":
        return _sum(inv32, _tiers(c64, 0, 1)), routes
    if route is not None and not c64:  # fused: the pointwise product rides the inverse
        pw = {"pointwise_inv_multi": 1} if route == "K1" else inv32
        return _sum(fwd32(op == "bounded"), fwd32(False), pw), routes
    return _sum(fwd32(op == "bounded"), fwd32(False), inv32, _tiers(c64, 2, 1)), routes


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
    for rname, p in r32.items():  # the plans' inverse: unnormalized
        def inv1(ctx, name, p=p):
            x = ctx.u32(ctx.rng(name), (1, n))
            return lambda: m.inv(x, n=n, p=p), lambda: m.inv_plain(x, n=n, p=p), "matmod_pass"

        out.append(_kernel(f"K2 inv n={n} B=1 {rname} unscaled", n, (("tier32", "K2"),), inv1,
                           tiles=lambda: str(m._k2_tiles(1, n, "inv"))))
    return out


def k4_rows(n: int) -> list:
    from concrete_ntt_tpu_torch import prime32
    from concrete_ntt_tpu_torch.ops import butterfly32_cuda as bcu

    r = regimes()
    if n >= N_FOURSTEP[0]:
        cases = [("small", r["small"], b) for b in BATCHES]
        if n == 1 << 14:
            cases.append(("small", r["small"], K4_PAIR_B))  # clusters of two blocks
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
    main_c, main_limbs = MAIN_PATHS.get(n, (None, ()))
    out = []
    for limbs, c, b in ((1, 2, 1), (1, 3, 3), (2, 5, 16), (2, 3, 1), (4, 10, 3), (4, 5, 1),
                        *((limbs, main_c, B_NATIVE) for limbs in main_limbs)):
        def k1a(ctx, name, limbs=limbs, c=c, b=b):
            rng, pr = ctx.rng(name), channel_primes(c, n)
            xs = tuple(ctx.u32(rng, (b, n)) for _ in range(limbs))
            return (lambda: m.fwd_wide_multi(xs, pr), lambda: m.fwd_wide_multi_plain(xs, pr),
                    "matmod_pass")

        out.append(_kernel(f"K1a fwd_wide_multi n={n} B={b} C={c} limbs={limbs}", n, cov, k1a,
                           tiles=K1_RING))
    for c, b in ((2, 16), (3, 1), (5, 3), (10, 1), *(((main_c, B_NATIVE),) if main_c else ())):
        def k1b(ctx, name, c=c, b=b):
            pr = channel_primes(c, n)
            x, s = ctx.u32(ctx.rng(name), (c, b, n)), tuple(scale32(n, p) for p in pr)
            return (lambda: m.inv_multi(x, pr, s), lambda: m.inv_multi_plain(x, pr, s),
                    "matmod_pass")

        out.append(_kernel(f"K1b inv_multi n={n} B={b} C={c} scaled", n, cov, k1b, tiles=K1_RING))

    def k1b_unscaled(ctx, name):
        pr = channel_primes(3, n)
        x = ctx.u32(ctx.rng(name), (3, 3, n))
        return (lambda: m.inv_multi(x, pr, (1,) * 3), lambda: m.inv_multi_plain(x, pr, (1,) * 3),
                "matmod_pass")

    out.append(_kernel(f"K1b inv_multi n={n} B=3 C=3 unscaled", n, cov, k1b_unscaled,
                       tiles=K1_RING))
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
    also one word past an aligned base, at n = 2 a count of 6 (their scalar
    instances), and at the main paths' n (`MAIN_PATHS`) the plans' batch."""
    from concrete_ntt_tpu_torch.ops import crt_cuda

    cases = [(_batch(n.bit_length()), 0)]
    cases += [(3, 1)] if n == 1 << 11 else [(3, 0)] if n == 2 else []
    cases += [(B_NATIVE, 0)] if n in MAIN_PATHS else []
    out = []
    for c, wrapper, match in ((5, "rec_u64_from5", "lift_u64_from5"),
                              (10, "rec_u128_from10", "lift_u128_")):
        primes = channel_primes(c, n)
        lift, plain = getattr(crt_cuda, wrapper), getattr(crt_cuda, wrapper + "_plain")
        # native128's at the shape of the cell native128-n65536-b64
        for b, off in cases + ([(64, 0)] if c == 10 and n == 1 << 16 else []):
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


#: the cells' pointwise shapes (C, B) at their n: native64-n16384-b256 and
#: native128-n65536-b64
POINTWISE_CELLS = {1 << 14: (5, 256), 1 << 16: (10, 64)}


def pointwise_rows(n: int) -> list:
    """The native Plan32 polymul's pointwise product (`ops/pointwise_cuda.py`)
    on full-range uint32 operands [C, B, n] over the primes the plans take at
    n: C = 5 and 10 at every n; at 2^11 every other C up to 10 and one word
    past an aligned base, at n = 2 a count of 6 (the scalar instance); at the
    main paths' n the plans' batch and the cells' shapes."""
    from concrete_ntt_tpu_torch.ops import pointwise_cuda

    cases = [(c, _batch(n.bit_length()), 0) for c in (5, 10)]
    if n == 1 << 11:
        cases += [(c, 3, 0) for c in (1, 2, 3, 4, 6, 7, 8, 9)] + [(5, 3, 1)]
    if n == 2:
        cases += [(5, 3, 0)]
    if n in MAIN_PATHS:
        cases += [(MAIN_PATHS[n][0], B_NATIVE, 0), (*POINTWISE_CELLS[n], 0)]
    out = []
    for c, b, off in cases:
        def make(ctx, name, c=c, b=b, off=off):
            primes = channel_primes(c, n)
            rng = ctx.rng(name)
            fl, fr = (torch.from_numpy(rng.integers(0, 1 << 32, off + c * b * n, dtype=np.uint32))
                      .to(ctx.dev)[off:].view(c, b, n) for _ in range(2))
            return (lambda: pointwise_cuda.mont_mul32(fl, fr, primes),
                    lambda: pointwise_cuda.mont_mul32_plain(fl, fr, primes), "mont32_pointwise")

        vec = (b * n) % 4 == 0 and off == 0
        out.append(_kernel(f"pointwise mont_mul32 n={n} B={b} C={c}"
                           + (f" offset={off}" if off else ""), n, (), make,
                           tiles="vector" if vec else "scalar"))
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

    cov = (("tier64", "K5h"),) if n > 1 << 15 else ()
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


def k7h_rows(n: int, pr: tuple) -> list:
    """The channel-grid hybrid's kernels (K7c / K7b / K7d with block tables)
    over three 50-bit primes: route64's "K7h" above 2^15; at 2^15 (Plan52's
    primes, where the plan keeps the direct route) no route's."""
    from concrete_ntt_tpu_torch.ops import mxu64_cuda as m

    cov = (("route64", "K7h"),) if n > 1 << 15 else ()
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
        return (lambda: [stagesplit.engine32_fused.fwd(x, n=n, p=p)] * 2,
                lambda: [stagesplit.fwd32(x, n=n, p=p), m.fwd(x, n=n, p=p)], "matmod_pass")

    def eng_inv(ctx, name):
        x, s = ctx.u32(ctx.rng(name), (3, n), p), scale32(n, p)
        return (lambda: [stagesplit.engine32_fused.inv(x, n=n, p=p, scale=s)] * 2,
                lambda: [stagesplit.inv32(x, n=n, p=p, scale=s), m.inv(x, n=n, p=p, scale=s)],
                "matmod_pass")

    return out + [_kernel(f"engine32_fused fwd n={n} B=3 lt30", n, (), eng_fwd),
                  _kernel(f"engine32_fused inv n={n} B=3 lt30 scaled", n, (), eng_inv)]


def k3_single_rows(n: int) -> list:
    """K3 `pass_matmod`, the JAX pass_matmod's one-to-one twin (no route
    takes it), per 32-bit regime: A scaled with 1, 2 and 4 operand limbs,
    F, G scaled, A_inv plain and scaled, and A on a rank's slice of the rows
    with its diagonal rows."""
    from concrete_ntt_tpu_torch.ops import mxu32, mxu32_cuda as m

    out = []
    for i, (rname, p) in enumerate(regimes()["r32"].items()):
        def make(ctx, name, b=_batch(i), p=p):
            rng, tbl = ctx.rng(name), mxu32._mxu_tables(n, p)
            n1, n2 = tbl["n1"], tbl["n2"]
            d, e = (tuple(torch.from_numpy(a).to(ctx.dev) for a in tbl[k]) for k in ("d", "e"))
            u = lambda shape, k=1: tuple(ctx.u32(rng, shape) for _ in range(k))
            cases = [("A", u((b, n2, n1), k), d, k, 1) for k in (1, 2, 4)]
            cases += [("F", u((b, n1, n2)), (), 1, 1), ("G", u((b, n1, n2)), e, 1, 1),
                      ("Ainv", u((b, n2, n1)), (), 1, 1),
                      ("Ainv", u((b, n2, n1)), (), 1, scale32(n, p)),
                      ("A", u((b, n2 // 2, n1)), tuple(t[n2 // 4: n2 // 4 + n2 // 2] for t in d),
                       1, 1)]
            calls = [(x if k > 1 else x[0], dict(n=n, p=p, which=w, diag_slices=dg, n_limbs=k,
                                                 scale=sc)) for w, x, dg, k, sc in cases]
            return (lambda: [m.pass_matmod(x, **kw) for x, kw in calls],
                    lambda: [m.pass_matmod_plain(x, **kw) for x, kw in calls], "matmod_pass")

        out.append(_kernel(f"K3 pass_matmod n={n} B={_batch(i)} {rname} (A x1 / x2 / x4 limbs, "
                           "F, G, Ainv, Ainv scaled, A on a row slice)", n, (), make))
    return out


def _mid_pair(ctx, rng, shape, p: int) -> tuple:
    """A 64-bit pass's mid-pass operand: any u64, or below 4p where the pass
    takes 7 operand planes (the 50-bit primes)."""
    from concrete_ntt_tpu_torch.ops import mxu64

    if mxu64._n_eplanes_lazy(p) == 8:
        return _pair(ctx, rng, shape)
    v = rng.integers(0, 4 * p, shape, dtype=np.uint64)
    lo, hi = (v & np.uint64(0xFFFFFFFF)).astype(np.uint32), (v >> np.uint64(32)).astype(np.uint32)
    return torch.from_numpy(lo).to(ctx.dev), torch.from_numpy(hi).to(ctx.dev)


def _k6_single(ctx, rng, n: int, p: int, b: int, whiches: tuple) -> list:
    """(operand, kwargs) of K6 `pass_matmod64` passes at (n, B): "A" scaled,
    "F", "G" scaled, "Ainv" plain and "Ainv*" scaled, "A/" on a rank's slice
    of the rows with its diagonal rows."""
    from concrete_ntt_tpu_torch.ops import mxu64

    tbl = mxu64._tables(n, p)
    n1, n2 = tbl["n1"], tbl["n2"]
    d, e = (tuple(torch.from_numpy(a).to(ctx.dev) for a in tbl[k]) for k in ("d", "e"))
    cases = {"A": lambda: (_pair(ctx, rng, (b, n2, n1)), d, 1),
             "F": lambda: (_mid_pair(ctx, rng, (b, n1, n2), p), (), 1),
             "G": lambda: (_pair(ctx, rng, (b, n1, n2)), e, 1),
             "Ainv": lambda: (_mid_pair(ctx, rng, (b, n2, n1), p), (), 1),
             "Ainv*": lambda: (_mid_pair(ctx, rng, (b, n2, n1), p), (), scale64(n, p)),
             "A/": lambda: (_pair(ctx, rng, (b, n2 // 4, n1)),
                            tuple(t[n2 // 4: n2 // 2] for t in d), 1)}
    calls = []
    for w in whiches:
        x, dg, sc = cases[w]()
        calls.append((x, dict(n=n, p=p, which=w.rstrip("*/"), diag_slices=dg, scale=sc)))
    return calls


def k6_single_rows(n: int) -> list:
    """K6 `pass_matmod64`, the JAX pass_matmod64's twin (no route takes it),
    per 64-bit regime: A scaled, F, G scaled, A_inv plain and scaled, A on a
    rank's slice of the rows."""
    from concrete_ntt_tpu_torch.ops import mxu64_cuda as m

    out = []
    for i, (rname, p) in enumerate(regimes()["r64"].items()):
        def make(ctx, name, b=_batch(i), p=p):
            calls = _k6_single(ctx, ctx.rng(name), n, p, b, ("A", "F", "G", "Ainv", "Ainv*", "A/"))
            return (lambda: [m.pass_matmod64(x, **kw) for x, kw in calls],
                    lambda: [m.pass_matmod64_plain(x, **kw) for x, kw in calls], "matmod64_pass")

        out.append(_kernel(f"K6 pass_matmod64 n={n} B={_batch(i)} {rname} (A, F, G, Ainv, "
                           "Ainv scaled, A on a row slice)", n, (), make, tiles=ROWS128))
    return out


@lru_cache(maxsize=None)
def instances64() -> dict:
    """One prime for each (digit planes, epilogue regime) instance of the
    64-bit GEMM pass (csrc/mxu64_pass.cu launch_any; K7 runs the four shoup
    ones), each with 2^16 | p - 1."""
    from concrete_ntt_tpu_torch.tables import GOLDILOCKS, PRIMES52
    from concrete_ntt_tpu_torch.utils.prime import (
        largest_prime_in_arithmetic_progression64 as ap)

    f = 1 << 16
    return {(5, "shoup"): ap(f, 1, 1 << 33, 1 << 39), (6, "shoup"): ap(f, 1, 1 << 40, 1 << 47),
            (7, "shoup"): PRIMES52[0], (8, "shoup"): ap(f, 1, 1 << 61, 1 << 62),
            (8, "montshoup"): ap(f, 1, 1 << 62, 1 << 63),
            (8, "montmont"): ap(f, 1, 1 << 63, 3 << 62),
            (9, "montmont"): ap(f, 1, 1 << 63, (1 << 64) - 1), (9, "gl"): GOLDILOCKS}


INST64_N = (1 << 11, 1 << 14)  # 2^11 at B = 3 leaves ragged row tiles (96 and 192 rows)
# K6's channel grid on one instance's prime: (B, s) of the tile each n reaches
# (`mxu64_cuda.k6_tile`: 64 rows at 2^11, 128 rows at 2^14)
INST64_GRID = {1 << 11: (3, 2), 1 << 14: (32, 1)}


def inst64_rows(n: int) -> list:
    """Each of the eight instances of the 64-bit pass at n, B = 3: K5 fwd and
    inv (plain, scaled), K6 A on a row slice and F, and K6's channel grid
    on one channel (the four passes of a rank's transform pair)."""
    from concrete_ntt_tpu_torch.ops import mxu64_cuda as m

    out = []
    for (n_d, regime), p in instances64().items():
        def make(ctx, name, p=p):
            rng = ctx.rng(name)
            x = _pair(ctx, rng, (3, n))
            calls = [(m.fwd, m.fwd_plain, x, dict(n=n, p=p))]
            calls += [(m.inv, m.inv_plain, x, dict(n=n, p=p, scale=sc))
                      for sc in (1, scale64(n, p))]
            calls += [(m.pass_matmod64, m.pass_matmod64_plain, x6, kw)
                      for x6, kw in _k6_single(ctx, rng, n, p, 3, ("A/", "F"))]
            b, s = INST64_GRID[n]
            for which, xg, rows in _route_passes(ctx, rng, n, b, s, 1, 1, pair=True):
                kw = dict(n=n, primes=(p,), which=which, transposed_out=which == "Ainv",
                          diag=m.multi_diag(n, (p,), which, *rows, str(ctx.dev)) if rows else None,
                          scales=(scale64(n, p),) if which == "Ainv" else None)
                calls.append((m.pass_matmod64_multi, m.pass_matmod64_multi_plain, xg, kw))
            return (lambda: [k(v, **kw) for k, _, v, kw in calls],
                    lambda: [pl(v, **kw) for _, pl, v, kw in calls], "matmod64_pass")

        out.append(_kernel(f"K5/K6 instance ({n_d}, {regime}) n={n} B=3 p={p} (K5 fwd, inv, inv "
                           "scaled; K6 A on a row slice, F; K6's grid A, F, G, Ainv)", n, (), make))
    return out


def _forced(module, rule: str, codes: list, calls) -> list:
    """calls() under each tile-code pair of `codes` in turn, `module.rule`
    replaced for them: the outputs, in order."""
    picked, out = getattr(module, rule), []
    try:
        for pair in codes:
            setattr(module, rule, lambda *a, pair=pair, **k: pair)
            out += calls()
    finally:
        setattr(module, rule, picked)
    return out


def k2h_forced_rows(n: int) -> list:
    """K2 with block tables, fwd and inv scaled, on every pair of tile codes
    (forced in place of `mxu32_cuda.k2h_tiles`; code 3, 128 x 64, only with
    four digit planes) in each 32-bit regime at B = 1 and 16: each output
    against the plain twin, and every pair launched."""
    from concrete_ntt_tpu_torch.ops import mxu32, mxu32_cuda as m

    out = []
    for rname, p in regimes()["r32"].items():
        codes = [(t1, t2) for t1 in range(3) for t2 in range(4)
                 if t2 < 3 or mxu32._n_dplanes32(p) == 4]
        for b in (1, 16):
            def make(ctx, name, b=b, p=p, codes=codes):
                x, kw, s = ctx.u32(ctx.rng(name), (b, n)), dict(n=n, p=p, n_h=N_H), scale32(n, p)
                pair = lambda: [m.fwd_hyb(x, **kw), m.inv_hyb(x, scale=s, **kw)]
                return (lambda: _forced(m, "k2h_tiles", codes, pair),
                        lambda: [m.fwd_hyb_plain(x, **kw), m.inv_hyb_plain(x, scale=s, **kw)]
                        * len(codes), "matmod_pass")

            out.append(Row(name=f"K2h forced tiles n={n} n_h={N_H} B={b} {rname} (every code "
                                "pair, fwd and inv scaled)", kind="kernel", n=n, make=make,
                           tiles=f"{len(codes)} code pairs forced",
                           ran=frozenset((d, *c) for c in codes for d in ("fwd_hyb", "inv_hyb"))))
    return out


K1E_FORCED = ((8, 5), (1, 2))  # (B, C) at 2^14 where K1e runs every pair of tile codes


def k1e_forced_rows(n: int) -> list:
    """K1e on every pair of tile codes (forced in place of
    `mxu32_cuda._k1e_tiles`), against the plain twin; every pair launched."""
    from concrete_ntt_tpu_torch.ops import mxu32_cuda as m

    codes = [(t1, t2) for t1 in range(3) for t2 in range(4)]
    out = []
    for b, c in K1E_FORCED:
        def make(ctx, name, b=b, c=c):
            pr = channel_primes(c, n)
            xd = m.digit_planes32(ctx.u32(ctx.rng(name), (c, b, n)))
            sc = tuple(scale32(n, p) for p in pr)
            return (lambda: _forced(m, "_k1e_tiles", codes,
                                    lambda: [m.inv_multi_presplit(xd, pr, sc)]),
                    lambda: [m.inv_multi_presplit_plain(xd, pr, sc)] * len(codes), "matmod_pass")

        out.append(Row(name=f"K1e forced tiles inv_multi_presplit n={n} B={b} C={c} (every code "
                            "pair)", kind="kernel", n=n, make=make,
                       tiles=f"{len(codes)} code pairs forced",
                       ran=frozenset(("inv_multi_presplit", *t) for t in codes)))
    return out


K1CD_TILE_SHAPES = ((1, 2), (3, 10), (5, 10))  # (B, C) at 2^14: every K1c / K1d instance


def k1cd_tiles_row(n: int) -> Row:
    """K1c (one limb) and K1d at K1CD_TILE_SHAPES, which between them take
    every one of the eight tile instances of their passes (`k1_tile`),
    each against its plain twin; each (kernel, codes) the rule picks
    launched."""
    from concrete_ntt_tpu_torch.ops import mxu32_cuda as m

    def make(ctx, name):
        rng, calls = ctx.rng(name), []
        for b, c in K1CD_TILE_SHAPES:
            pr = channel_primes(c, n)
            x, y = ctx.u32(rng, (c, b, n)), ctx.u32(rng, (c, b, n))
            sc = tuple(scale32(n, p) for p in pr)
            calls += [(lambda x=x, pr=pr: m.fwd_multi_perchannel(x, pr),
                       lambda x=x, pr=pr: m.fwd_multi_perchannel_plain((x,), pr)),
                      (lambda x=x, y=y, pr=pr, sc=sc: m.pointwise_inv_multi(x, y, pr, sc),
                       lambda x=x, y=y, pr=pr, sc=sc: m.pointwise_inv_multi_plain(x, y, pr, sc))]
        return (lambda: [k() for k, _ in calls], lambda: [pl() for _, pl in calls], "matmod_pass")

    ran = frozenset(key for b, c in K1CD_TILE_SHAPES for key in (
        ("fwd_multi_perchannel", *m._k1_tiles(b, n, c, 1, "fwd")),
        ("pointwise_inv_multi", *m._k1_tiles(b, n, c, 1, "inv"))))
    return Row(name=f"K1c / K1d tile instances n={n} (B, C) in {K1CD_TILE_SHAPES}", kind="kernel",
               n=n, make=make, tiles=", ".join(map(str, sorted(ran))), ran=ran)


# (B, s, C) of K3's channel grid at 2^14 that between them take every tile code
# (`k3_multi_tile`: 64 x 16; K1's tile holding four stages whole; K1's ring and
# 128 x 64 for the canonical passes), and of K6's (`k6_tile`: 128 rows, 64 rows)
K3_TILE_SHAPES = ((4, 2, 1), (16, 1, 2), (8, 1, 5))
K6_TILE_SHAPES = ((32, 1, 1), (4, 2, 3))


def grid_tiles_rows(n: int) -> list:
    """K3's and K6's channel grids at the shapes whose passes take every tile
    code of their rules, each pass against its plain twin; every code
    launched."""
    out = []
    for name, shapes, codes in (("K3 pass_matmod_multi", K3_TILE_SHAPES, range(4)),
                                ("K6 pass_matmod64_multi", K6_TILE_SHAPES, range(2))):
        rows = (k3_rows(n, tuple((b, s, c, 1) for b, s, c in shapes)) if name.startswith("K3")
                else k6_rows(n, shapes))

        def make(ctx, row_name, rows=rows):
            parts = [r.make(ctx, r.name) for r in rows]
            return (lambda: [k() for k, _, _ in parts], lambda: [pl() for _, pl, _ in parts],
                    parts[0][2])

        key = name.split()[1]
        out.append(Row(name=f"{name} tile codes n={n} (B, s, C) in {shapes}", kind="kernel", n=n,
                       make=make, ran=frozenset((key, t) for t in codes)))
    return out


# the tensor-core pass at shapes the batches of BATCHES do not reach: ragged
# row tiles at 2^12 and 2^13
RAGGED = {1 << 12: 2, 1 << 13: 5}


def ragged_rows(n: int) -> list:
    """K1a with 1, 2 and 4 limbs, K1b, K2 fwd / fwd_wide / inv scaled in lt30
    and with five digit planes, at (n, RAGGED[n])."""
    from concrete_ntt_tpu_torch.ops import mxu32_cuda as m

    b, r32 = RAGGED[n], regimes()["r32"]
    out = []
    for limbs, c in ((1, 5), (2, 5), (4, 10)):
        def k1a(ctx, name, limbs=limbs, c=c):
            pr, rng = channel_primes(c, n), ctx.rng(name)
            xs = tuple(ctx.u32(rng, (b, n)) for _ in range(limbs))
            return (lambda: m.fwd_wide_multi(xs, pr), lambda: m.fwd_wide_multi_plain(xs, pr),
                    "matmod_pass")

        out.append(_kernel(f"K1a fwd_wide_multi n={n} B={b} C={c} limbs={limbs} (ragged)", n, (),
                           k1a, tiles=K1_RING))

    def k1b(ctx, name):
        pr = channel_primes(5, n)
        x, sc = ctx.u32(ctx.rng(name), (5, b, n)), tuple(scale32(n, p) for p in pr)
        return lambda: m.inv_multi(x, pr, sc), lambda: m.inv_multi_plain(x, pr, sc), "matmod_pass"

    out.append(_kernel(f"K1b inv_multi n={n} B={b} C=5 scaled (ragged)", n, (), k1b, tiles=K1_RING))
    for rname in ("lt30", "gen5"):
        p = r32[rname]

        def k2(ctx, name, p=p):
            rng = ctx.rng(name)
            x, w, s = ctx.u32(rng, (b, n)), _pair(ctx, rng, (b, n)), scale32(n, p)
            return (lambda: [m.fwd(x, n=n, p=p), m.fwd_wide(w, n=n, p=p),
                             m.inv(x, n=n, p=p, scale=s)],
                    lambda: [m.fwd_plain(x, n=n, p=p), m.fwd_wide_plain(w, n=n, p=p),
                             m.inv_plain(x, n=n, p=p, scale=s)], "matmod_pass")

        out.append(_kernel(f"K2 fwd, fwd_wide, inv scaled n={n} B={b} {rname} (ragged)", n, (), k2,
                           tiles=lambda: str(m._k2_tiles(b, n, "fwd"))))
    return out


def w4_rows(n: int) -> list:
    """K5's forward with the four limbs of a u128 operand in the 64-bit
    regimes beside Goldilocks' (k5_rows), at B = 3."""
    from concrete_ntt_tpu_torch.ops import mxu64_cuda as m

    out = []
    for rname, p in regimes()["r64"].items():
        if rname == "gl":
            continue

        def w4(ctx, name, p=p):
            xs = tuple(ctx.u32(ctx.rng(name), (3, n)) for _ in range(4))
            return (lambda: m.fwd(xs, n=n, p=p), lambda: m.fwd_plain(xs, n=n, p=p),
                    "matmod64_pass")

        out.append(_kernel(f"W4-64 fwd64_u128 n={n} B=3 {rname}", n, (), w4, tiles=ROWS128))
    return out


def engine64_rows(n: int) -> list:
    """The whole 64-bit hybrid (`stagesplit.engine64_fused`: plain prefix /
    suffix stages around K5 with block tables) where K5 also serves n
    directly, per regime at B = 16: against the plain hybrid and the direct
    K5, bit for bit."""
    from concrete_ntt_tpu_torch.ops import mxu64_cuda as m
    from concrete_ntt_tpu_torch.ops import stagesplit

    out = []
    for rname, p in regimes()["r64"].items():
        def make(ctx, name, p=p):
            x, sc = _pair(ctx, ctx.rng(name), (16, n)), scale64(n, p)
            return (lambda: [stagesplit.fwd64_fused(x, n=n, p=p)] * 2
                    + [stagesplit.inv64_fused(x, n=n, p=p, scale=sc)] * 2,
                    lambda: [stagesplit.fwd64(x, n=n, p=p), m.fwd(x, n=n, p=p),
                             stagesplit.inv64(x, n=n, p=p, scale=sc),
                             m.inv(x, n=n, p=p, scale=sc)], "matmod64_pass")

        out.append(_kernel(f"engine64_fused fwd, inv scaled n={n} n_h={N_H} B=16 {rname} (== plain "
                           "hybrid == direct K5)", n, (), make, tiles=ROWS128))
    return out


def k7_hybrid_row(n: int, primes: tuple) -> Row:
    """The channel-grid hybrid's three functions (K7c, K7d and K7b with block
    tables inside) against the direct route at the same n: K7a, K7d, and K5
    once per channel."""
    from concrete_ntt_tpu_torch.ops import mxu64_cuda as m
    from concrete_ntt_tpu_torch.ops import stagesplit

    def make(ctx, name):
        rng = ctx.rng(name)
        one = _pair(ctx, rng, (8, n))
        x3, y3 = _pair(ctx, rng, (3, 8, n)), _pair(ctx, rng, (3, 8, n))
        sc = tuple(scale64(n, p) for p in primes)
        inv_direct = lambda: tuple(torch.stack(t) for t in zip(*(
            m.inv((x3[0][c].contiguous(), x3[1][c].contiguous()), n=n, p=p, scale=sc[c])
            for c, p in enumerate(primes))))
        return (lambda: [stagesplit.fwd_multi_hybrid64(one, primes, n=n),
                         stagesplit.inv_multi_hybrid64(*x3, primes, sc, n=n),
                         stagesplit.pointwise_inv_multi_hybrid64(x3, y3, primes, sc, n=n)],
                lambda: [m.fwd_multi(one, primes), inv_direct(),
                         m.pointwise_inv_multi(x3, y3, primes, sc)], "matmod64_pass")

    return _kernel(f"K7 hybrids vs direct n={n} n_h={N_H} B=8 C={len(primes)} (fwd, inv, "
                   "pointwise_inv)", n, (), make, tiles=ROWS128)


def k1h_rows(n: int) -> list:
    """The 32-bit channel grid with block tables: K1c (1 and 2 limbs), K1b and
    K1d over three channel primes against their plain twins, and the four
    channel-grid hybrids of `ops/stagesplit.py` against K1a / K1c / K1b /
    K1d direct."""
    from concrete_ntt_tpu_torch.ops import mxu32_cuda as m
    from concrete_ntt_tpu_torch.ops import stagesplit

    pr, b = channel_primes(3, n), (8 if n == 1 << 16 else 3)
    sc = tuple(scale32(n, p) for p in pr)
    calls = {
        "K1c-hyb fwd_multi_perchannel limbs=1": (
            lambda x, y: m.fwd_multi_perchannel(x, pr, n_h=N_H),
            lambda x, y: m.fwd_multi_perchannel_plain((x,), pr, N_H)),
        "K1c-hyb fwd_multi_perchannel limbs=2": (
            lambda x, y: m.fwd_wide_multi_perchannel(x, y, pr, n_h=N_H),
            lambda x, y: m.fwd_multi_perchannel_plain((x, y), pr, N_H)),
        "K1b-hyb inv_multi scaled": (lambda x, y: m.inv_multi(x, pr, sc, n_h=N_H),
                                     lambda x, y: m.inv_multi_plain(x, pr, sc, N_H)),
        "K1d-hyb pointwise_inv_multi": (
            lambda x, y: m.pointwise_inv_multi(x, y, pr, sc, n_h=N_H),
            lambda x, y: m.pointwise_inv_multi_plain(x, y, pr, sc, N_H)),
        "hybrid32 channel grids vs direct (fwd_wide x1 / x2 limbs, fwd_perchannel, inv, "
        "pointwise_inv)": (
            lambda x, y: [stagesplit.fwd_wide_multi_hybrid32((x[0],), pr, n=n),
                          stagesplit.fwd_wide_multi_hybrid32((x[0], y[0]), pr, n=n),
                          stagesplit.fwd_perchannel_multi_hybrid32(x, pr, n=n),
                          stagesplit.inv_multi_hybrid32(x, pr, sc, n=n),
                          stagesplit.pointwise_inv_multi_hybrid32(x, y, pr, sc, n=n)],
            lambda x, y: [m.fwd_wide_multi((x[0],), pr), m.fwd_wide_multi((x[0], y[0]), pr),
                          m.fwd_multi_perchannel(x, pr), m.inv_multi(x, pr, sc),
                          m.pointwise_inv_multi(x, y, pr, sc)]),
    }
    out = []
    for label, (kern, want) in calls.items():
        def make(ctx, name, kern=kern, want=want):
            rng = ctx.rng(name)
            x, y = ctx.u32(rng, (3, b, n)), ctx.u32(rng, (3, b, n))
            return lambda: kern(x, y), lambda: want(x, y), "matmod_pass"

        out.append(_kernel(f"{label} n={n} n_h={N_H} B={b} C=3", n, (), make))
    return out


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


def on_cpu(ctx, call, got: np.ndarray) -> str:
    """Under --quick on the card: call("cpu"), the same plan's plain path on
    the same operands, against `got`, every word of every row; the suffix of
    the row's detail."""
    if not (ctx.quick and ctx.dev.type == "cuda"):
        return ""
    want = call("cpu")
    if got.shape != want.shape or not np.array_equal(got, want):
        bad = sorted({i for i in range(len(got)) if not np.array_equal(got[i], want[i])})
        raise Mismatch(f"rows {bad[:8]} differ from the same plan on the CPU")
    return f"; all {len(got)} rows == the plan on the CPU"


def _native_out(out) -> np.ndarray:
    """A plan's output as numpy: [B, n] (width 32 / 64, the prime plans) or [B, n, 4]."""
    return out.cpu().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)


def native_row(n: int, module: str, tier: str, width: int, c: int) -> Row | None:
    """A native plan's polymul at n, where the plan exists (its primes have a
    2n-th root of unity)."""
    from concrete_ntt_tpu_torch.tables import PRIMES52

    primes = channel_primes(c, n) if tier == "Plan32" else tuple(PRIMES52[:c])
    if primes is None or any((p - 1) % (2 * n) for p in primes):
        return None
    cls = getattr(importlib.import_module(f"concrete_ntt_tpu_torch.{module}"), tier)
    binary = module.startswith("native_binary")
    launches, _, _, routes = native_launches(module, tier, width, n, primes)
    fn, _, value = routes[0]
    lk, rk = f"u{width}", ("bin" if binary else f"u{width}")

    def run(ctx, name):
        rng = ctx.rng(name)
        a1, b1 = ctx.first_rows(n, lk, rk)
        lhs = _operand(rng, a1, B_NATIVE, 1 << width)
        rhs = _operand(rng, b1, B_NATIVE, 2 if binary else 1 << width)

        def polymul(device):
            plan = cls.try_new(n, device=device)
            return _native_out(plan.negacyclic_polymul(_native_arg(lhs, width, device),
                                                       _native_arg(rhs, width, device)))

        out = polymul(str(ctx.dev))
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
        return detail + on_cpu(ctx, polymul, out)

    return Row(name=f"plan {module}.{tier} polymul n={n} B={B_NATIVE} route {value}", kind="plan",
               n=n, covers=((fn, value),), run=run, launches=launches, routes=routes)


#: (n, B) of the cell native64-plan52-n16384-b256's polymul
PLAN52_CELL = (1 << 14, 256)


def _planar64(x: np.ndarray, device) -> tuple:
    """uint64 numpy [B, n] -> the (lo, hi) uint32 planes on `device`."""
    return tuple(torch.from_numpy(np.ascontiguousarray((x >> s).astype(np.uint32))).to(device)
                 for s in (np.uint64(0), np.uint64(32)))


def plan52_cell_row(n: int, b: int) -> Row:
    """native64 Plan52's polymul at the benchmark cell's shape, on planar
    full-range operands on the plan's device: the first row against the
    exact product, every row against native64 Plan32 on the same operands
    (another route, other primes, another lift; its own rows hold it to the
    oracle)."""
    from concrete_ntt_tpu_torch import native64
    from concrete_ntt_tpu_torch.tables import PRIMES52

    launches52, _, _, routes52 = native_launches("native64", "Plan52", 64, n, tuple(PRIMES52[:3]))
    launches32, _, _, routes32 = native_launches("native64", "Plan32", 64, n, channel_primes(5, n))
    fn, _, value = routes52[0]

    def run(ctx, name):
        rng = ctx.rng(name)
        a1, b1 = ctx.first_rows(n, "u64", "u64")
        lhs, rhs = (_planar64(np.array(_operand(rng, first, b, 1 << 64), dtype=np.uint64), ctx.dev)
                    for first in (a1, b1))
        dev = str(ctx.dev)
        got = native64.Plan52.try_new(n, device=dev).negacyclic_polymul(lhs, rhs)
        want = native64.Plan32.try_new(n, device=dev).negacyclic_polymul(lhs, rhs)
        lo, hi = (t[0].cpu().numpy().astype(np.uint64) for t in got)
        check_first_row(ctx, (hi << np.uint64(32) | lo).tolist(), n, "u64", "u64",
                        lambda k, v: v & ((1 << 64) - 1))
        if not same_bits(got, want):
            bad = sorted({int(i) for g, w in zip(got, want)
                          for i in (g.view(torch.int32) != w.view(torch.int32)).any(1).nonzero()})
            raise Mismatch(f"rows {bad[:8]} differ from native64.Plan32's")
        return f"first row vs the exact product, all {b} rows == native64.Plan32"

    return Row(name=f"plan native64.Plan52 polymul n={n} B={b} route {value} (the cell's shape)",
               kind="plan", n=n, covers=((fn, value),), run=run,
               launches=_sum(launches52, launches32), routes=routes52 + routes32)


def native_round_row(n: int, module: str, tier: str, width: int, c: int) -> Row | None:
    """inv(fwd(x)) of a native plan at n against n·x, wrapping (the plans'
    unnormalized inverse), where the plan exists."""
    from concrete_ntt_tpu_torch.tables import PRIMES52

    primes = channel_primes(c, n) if tier == "Plan32" else tuple(PRIMES52[:c])
    if primes is None or any((p - 1) % (2 * n) for p in primes):
        return None
    cls = getattr(importlib.import_module(f"concrete_ntt_tpu_torch.{module}"), tier)

    def run(ctx, name):
        plan = cls.try_new(n, device=str(ctx.dev))
        x = _uniform(ctx.rng(name), B_ROUND, n, 1 << width)
        out = _native_out(plan.inv(plan.fwd(_native_arg(x, width, ctx.dev))))
        mask = (1 << width) - 1
        bad = [i for i in range(B_ROUND)
               if (_ints(out[i]) if out.ndim == 3 else out[i].tolist())
               != [v * n & mask for v in x[i]]]
        if bad:
            raise Mismatch(f"rows {bad} of inv(fwd(x)) differ from n·x")
        return f"inv(fwd(x)) == n·x, all {B_ROUND} rows"

    _, fwd, inv, routes = native_launches(module, tier, width, n, primes)
    return Row(name=f"plan {module}.{tier} round trip n={n} B={B_ROUND}", kind="plan", n=n,
               run=run, launches=_sum(fwd, inv), routes=routes)


def prime32_row(n: int, rname: str, p: int, b: int) -> Row:
    from concrete_ntt_tpu_torch import prime32

    routes = held(n, ("tier32 small" if rname == "small" else "tier32", p))
    tier = routes[0][2]

    def run(ctx, name):
        rng = ctx.rng(name)
        a1, b1 = ctx.first_rows(n, "u32", "u32")
        lhs = np.array(_operand(rng, [v % p for v in a1], b, p), dtype=np.uint32)
        rhs = np.array(_operand(rng, [v % p for v in b1], b, p), dtype=np.uint32)

        def polymul(device):
            return prime32.Plan.new(n, p, device=device).negacyclic_polymul(lhs, rhs).cpu().numpy()

        out = polymul(str(ctx.dev))
        check_first_row(ctx, out[0].tolist(), n, "u32", "u32", lambda k, v: v % p)
        return "first row vs the exact product" + on_cpu(ctx, polymul, out)

    return Row(name=f"plan prime32 polymul n={n} B={b} {rname} tier {tier}", kind="plan", n=n,
               covers=(("tier32", tier),), run=run, launches=tier_launches(tier, 2, 1),
               routes=routes)


def prime_round_row(n: int, width: int, rname: str, p: int) -> Row:
    """inv(fwd(x)) of a prime32 or prime64 plan against n·x mod p."""
    from concrete_ntt_tpu_torch import prime32, prime64

    mod = prime32 if width == 32 else prime64
    routes = held(n, ("tier64" if width == 64 else "tier32 small" if rname == "small"
                      else "tier32", p))
    tier = routes[0][2]

    def run(ctx, name):
        plan = mod.Plan.new(n, p, device=str(ctx.dev))
        x = np.array(_uniform(ctx.rng(name), B_ROUND, n, p),
                     dtype=np.uint32 if width == 32 else np.uint64)
        out = _native_out(plan.inv(plan.fwd(x))).tolist()
        bad = [i for i in range(B_ROUND) if out[i] != [int(v) * n % p for v in x[i]]]
        if bad:
            raise Mismatch(f"rows {bad} of inv(fwd(x)) differ from n·x mod p")
        return f"inv(fwd(x)) == n·x mod p, all {B_ROUND} rows"

    return Row(name=f"plan prime{width} round trip n={n} B={B_ROUND} {rname} tier {tier}",
               kind="plan", n=n, run=run, launches=tier_launches(tier, 1, 1), routes=routes)


def prime64_row(n: int, rname: str, p: int, b: int) -> Row:
    from concrete_ntt_tpu_torch import prime64

    routes = held(n, ("tier64", p))
    tier = routes[0][2]

    def run(ctx, name):
        rng = ctx.rng(name)
        a1, b1 = ctx.first_rows(n, "u64", "u64")
        lhs = np.array(_operand(rng, [v % p for v in a1], b, p), dtype=np.uint64)
        rhs = np.array(_operand(rng, [v % p for v in b1], b, p), dtype=np.uint64)

        def polymul(device):
            return np.asarray(prime64.Plan.new(n, p, device=device).negacyclic_polymul(lhs, rhs))

        out = polymul(str(ctx.dev))
        check_first_row(ctx, out[0].tolist(), n, "u64", "u64", lambda k, v: v % p)
        return "first row vs the exact product" + on_cpu(ctx, polymul, out)

    return Row(name=f"plan prime64 polymul n={n} B={b} {rname} tier {tier}", kind="plan", n=n,
               covers=(("tier64", tier),), run=run, launches=tier_launches(tier, 2, 1),
               routes=routes)


def product_sets(n: int) -> dict:
    """The product plans' factor pairs: {name: (factors, the ROUTES kind of
    the u32 factors as a set, then of each factor)}."""
    r = regimes()
    r32 = r["r32"]
    return {"2x30": (channel_primes(2, n), ("route32 30-bit", "tier32", "tier32")),
            "lt31+gen5": ((r32["lt31"], r32["gen5"]), ("route32", "tier32", "tier32")),
            "small+lt30": ((r["small"], r32["lt30"]),
                           ("route32 small", "tier32 small", "tier32")),
            "lt30+p34": ((r32["lt30"], r["p34"]), ("route32 30-bit", "tier32", "tier64"))}


def product_rows(n: int) -> list:
    from concrete_ntt_tpu_torch import product

    out = []
    for i, (sname, (factors, kinds)) in enumerate(product_sets(n).items()):
        modulus = factors[0] * factors[1]
        routes = product_launches(n, factors, kinds, "polymul")[1]
        value = routes[0][2]
        covers = (("route32", value),) + tuple((fn, v) for fn, _, v in routes[1:]
                                               if fn == "tier64")
        for j, mode in enumerate(("replace", "accumulate", "bounded")):
            if mode == "bounded" and factors[1] >= 1 << 32:
                continue  # Bounded takes two u32 channels (product.rs:303-322)
            b = _batch(i + j)

            def run(ctx, name, factors=factors, modulus=modulus, mode=mode, b=b):
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
                lhs, rhs = np.array(lhs, dtype=np.uint64), np.array(rhs, dtype=np.uint64)

                def polymul(device):
                    plan = product.Plan.new(n, modulus, factors, device=device)
                    return np.asarray(plan.negacyclic_polymul(lhs, rhs, **kw))

                got = polymul(str(ctx.dev))
                add = std[0] if mode == "accumulate" else [0] * n
                check_first_row(ctx, got[0].tolist(), n, lk, "u64",
                                lambda k, v: (add[k] + v) % modulus)
                return "first row vs the exact product" + on_cpu(ctx, polymul, got)

            op = "bounded" if mode == "bounded" else "polymul"
            out.append(Row(name=f"plan product {mode} polymul n={n} B={b} {sname} route {value}",
                           kind="plan", n=n, covers=covers, run=run,
                           launches=product_launches(n, factors, kinds, op)[0], routes=routes))
        for mode in ("generic", "bounded"):
            if mode == "bounded" and factors[1] >= 1 << 32:
                continue
            out.append(product_round_row(n, sname, factors, kinds, mode))
    return out


def product_round_row(n: int, sname: str, factors: tuple, kinds: tuple, mode: str) -> Row:
    """inv(fwd(x, mode)) of a product plan against n·x mod the modulus; the
    Bounded forward on signed values |v| < 2^19."""
    from concrete_ntt_tpu_torch import product

    modulus = factors[0] * factors[1]

    def run(ctx, name):
        plan = product.Plan.new(n, modulus, factors, device=str(ctx.dev))
        rng = ctx.rng(name)
        if mode == "bounded":
            x = [[v % modulus for v in row]
                 for row in rng.integers(-(BOUND // 2) + 1, BOUND // 2, (B_ROUND, n)).tolist()]
            dom = plan.fwd(np.array(x, dtype=np.uint64), product.bounded(BOUND))
        else:
            x = _uniform(rng, B_ROUND, n, 1 << 64)
            dom = plan.fwd(np.array(x, dtype=np.uint64))
        out = np.asarray(plan.inv(dom)).tolist()
        bad = [i for i in range(B_ROUND) if out[i] != [v * n % modulus for v in x[i]]]
        if bad:
            raise Mismatch(f"rows {bad} of inv(fwd(x)) differ from n·x mod the modulus")
        return f"inv(fwd(x)) == n·x mod the modulus, all {B_ROUND} rows"

    fwd, routes = product_launches(n, factors, kinds, "fwd bounded" if mode == "bounded" else "fwd")
    return Row(name=f"plan product {mode} round trip n={n} B={B_ROUND} {sname}", kind="plan", n=n,
               run=run, launches=_sum(fwd, product_launches(n, factors, kinds, "inv")[0]),
               routes=routes)


def pbs_row(n: int) -> Row:
    """The tfhe-rs external product's loop on a product plan over two 30-bit
    primes: a Bounded forward of each digit, `mul_accumulate` against its
    normalized key, one inverse into Accumulate; sampled coefficients of the
    first row against the sum of the exact products and the standard
    buffer."""
    from concrete_ntt_tpu_torch import product

    factors, b = channel_primes(2, n), 16
    kinds = product_sets(n)["2x30"][1]
    modulus = factors[0] * factors[1]

    def run(ctx, name):
        rng = ctx.rng(name)
        digits = [rng.integers(-(BOUND // 2) + 1, BOUND // 2, (b, n)) for _ in range(PBS_TERMS)]
        keys = [np.array(_uniform(rng, b, n, modulus), dtype=np.uint64)
                for _ in range(PBS_TERMS)]
        std = np.array(_uniform(rng, b, n, modulus), dtype=np.uint64)
        # a digit's residue modulo the modulus, as u64
        lhs = [np.where(d < 0, d + modulus, d).astype(np.uint64) for d in digits]

        def loop(device):
            plan = product.Plan.new(n, modulus, factors, device=device)
            acc = product.NttDomain(torch.zeros((2, b, n), dtype=torch.uint32, device=device))
            for d, key in zip(lhs, keys):
                acc = plan.mul_accumulate(acc, plan.fwd(d, product.bounded(BOUND)),
                                          plan.normalize(plan.fwd(key)))
            return np.asarray(plan.inv(acc, mode=product.ACCUMULATE, standard=std))

        got = loop(str(ctx.dev))
        ks = ctx.ks(n)
        want = [int(std[0][k]) for k in ks]
        for d, key in zip(digits, keys):
            want = [w + v for w, v in zip(want, sampled_negacyclic(d[0].tolist(), key[0].tolist(),
                                                                   ks))]
        bad = [k for k, w in zip(ks, want) if int(got[0][k]) != w % modulus]
        if bad:
            raise Mismatch(f"coefficients {bad} of row 0 differ from the exact sum")
        return (f"{len(ks)} sampled coefficients of row 0 vs the exact sum of {PBS_TERMS} "
                "products" + on_cpu(ctx, loop, got))

    fwd, routes = product_launches(n, factors, kinds, "fwd bounded")
    return Row(name=f"plan product pbs loop n={n} B={b} 2x30 terms={PBS_TERMS}", kind="plan", n=n,
               run=run, launches=_sum(*[fwd, product_launches(n, factors, kinds, "fwd")[0]]
                                      * PBS_TERMS, product_launches(n, factors, kinds, "inv")[0]),
               routes=routes)


def route_rows(n: int) -> list:
    """The dispatcher's channel functions on prime sets that no public plan
    holds: each channel's residues of the product of the shared u64 rows."""
    from concrete_ntt_tpu_torch.ops import ntt_dispatch as nd

    r = regimes()
    r32 = r["r32"]
    out = []
    cases = [("route32", (r32["lt31"], r32["gen4"], r32["gen5"]), 3)]
    if n <= 1 << 15:
        cases.append(("route64 50-bit", r["p52x"], 1))
    cases += [("route64 50-bit", r["p52x"][:2] if n <= 1 << 15 else r["p52x"], 16),
              ("route64", (r["r64"]["p50"], r["r64"]["p63"]), 1)]
    for kind, primes, b in cases:
        routes = held(n, (kind, primes))
        fn, _, value = routes[0]
        if value is None:
            continue

        def run(ctx, name, fn=fn, primes=primes, b=b):
            rng = ctx.rng(name)
            a1, b1 = ctx.first_rows(n, "u64", "u64")
            lhs, rhs = _operand(rng, a1, b, 1 << 64), _operand(rng, b1, b, 1 << 64)
            words = [tuple(np.array([[(v >> s) & 0xFFFFFFFF for v in row] for row in x],
                                    dtype=np.uint32) for s in (0, 32)) for x in (lhs, rhs)]
            chans = tuple(Chan(p) for p in primes)

            def polymul(device):
                parts = [tuple(torch.from_numpy(w).to(device) for w in x) for x in words]
                if fn == "route32":
                    fl, fr = (nd.try_fwd32_wide_all(x, chans) for x in parts)
                    return nd.try_pointwise_inv32_all(fl, fr, chans).cpu().numpy().astype(
                        np.uint64)
                fl, fr = (nd.try_fwd64_wide_all(x, chans) for x in parts)
                lo, hi = (t.cpu().numpy().astype(np.uint64)
                          for t in nd.try_pointwise_inv64_all(fl, fr, chans))
                return lo | (hi << np.uint64(32))

            res = polymul(str(ctx.dev))
            for c, p in enumerate(primes):
                check_first_row(ctx, res[c, 0].tolist(), n, "u64", "u64", lambda k, v, p=p: v % p)
            return (f"{len(primes)} channels' first rows vs the exact product"
                    + on_cpu(ctx, polymul, res))

        out.append(Row(name=f"route {fn} -> {value} n={n} B={b} primes {primes}", kind="route",
                       n=n, covers=((fn, value),), run=run,
                       launches=route_launches(value, len(primes)), routes=routes))
    return out


def fixture_rows() -> list:
    """The dense fixture (tests/fixtures/dense_oracle_2048.json): five native
    plans at N = 2048, the K1 route at 2^11, against SHA-256 digests of the
    exact wrapping products."""
    from concrete_ntt_tpu_torch.tables import PRIMES52

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

        spec = next(s for s in NATIVE if s[:2] == (module, tier))
        primes = channel_primes(spec[3], 2048) if tier == "Plan32" else PRIMES52[:spec[3]]
        launches, _, _, routes = native_launches(module, tier, spec[2], 2048, tuple(primes))
        out.append(Row(name=f"fixture {module}.{tier} polymul n=2048 B=1 (dense oracle digest)",
                       kind="fixture", n=2048, covers=(), run=run, launches=launches,
                       routes=routes))
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
    from concrete_ntt_tpu_torch.tables import PRIMES52

    r = regimes()
    ns = [n for n in N_SMALL + N_FOURSTEP if not quick or n in QUICK_N]
    out = fixture_rows()
    for n in ns:
        if n in N_FOURSTEP:
            out += k2_rows(n) + k1_rows(n) + k3_single_rows(n)
            out += k3_rows(n, ((1, 2, (1, 2, 3, 5)[n.bit_length() % 4],
                                (1, 2, 4)[n.bit_length() % 3]),))
            if n <= 1 << 15:
                out += k5_rows(n) + k7_rows(n) + k6_rows(n, ((1, 2, 3),)) + k6_single_rows(n)
            else:
                out += k5h_rows(n) + k7h_rows(n, r["p52x"])
            if n > N_H:
                out += k2h_rows(n) + k1h_rows(n)
            if n == 1 << 15:  # the 64-bit hybrids where K5 and K7 also serve n directly
                out += k5h_rows(n) + engine64_rows(n) + k7h_rows(n, tuple(PRIMES52[:3]))
                out.append(k7_hybrid_row(n, tuple(PRIMES52[:3])))
            if n in INST64_N:
                out += inst64_rows(n) + w4_rows(n)
            if n in RAGGED:
                out += ragged_rows(n)
            if n == 1 << 14:  # the sharded routes' rank-local shapes (chip_smoke phase `sharded`)
                out += k3_rows(n, ((4, 2, 1, 1), (1, 2, 1, 1))) + k6_rows(n, ((4, 2, 3),))
                out += k1e_forced_rows(n) + grid_tiles_rows(n) + [k1cd_tiles_row(n)]
            if n == 1 << 16:
                out += k3_rows(n, ((8, 2, 5, 4), (1, 2, 5, 4))) + k2h_forced_rows(n)
            out += route_rows(n)
        out += k4_rows(n) + lift_rows(n) + pointwise_rows(n)
        for spec in NATIVE:
            out += [row for row in (native_row(n, *spec), native_round_row(n, *spec)) if row]
        if n == PLAN52_CELL[0]:
            out.append(plan52_cell_row(*PLAN52_CELL))
        for i, (rname, p) in enumerate((*r["r32"].items(), ("small", r["small"]))):
            out += [prime32_row(n, rname, p, _batch(i)), prime_round_row(n, 32, rname, p)]
        for i, (rname, p) in enumerate(r["r64"].items()):
            out += [prime64_row(n, rname, p, _batch(i)), prime_round_row(n, 64, rname, p)]
        out += product_rows(n)
        if n in (1 << 11, 1 << 14):
            out.append(pbs_row(n))
    if not quick:
        out.append(prime32_row(N_STAGE32, "stage32", r["stage32"], 1))
    return out


# ---------------------------------------------------------------------------
# running
# ---------------------------------------------------------------------------


def max_abs_err(got, want) -> int | None:
    """The largest |got - want| over the words of two outputs (nested
    tuples and lists of tensors, uint32 words as unsigned), None where their
    shapes differ."""
    xs, ys = _flat(got), _flat(want)
    if len(xs) != len(ys) or any(x.shape != y.shape for x, y in zip(xs, ys)):
        return None
    wide = lambda t: (t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
                      if t.dtype == torch.uint32 else t.to(torch.int64))
    return max((int((wide(x) - wide(y)).abs().max()) for x, y in zip(xs, ys) if x.numel()),
               default=0)


def check_row(ctx: Ctx, row: Row) -> str:
    """Run one row; its detail string, or raise. First the dispatcher's
    value of each of `row.routes`; on the card also the row's launches:
    exactly `row.launches` where given, every key of `row.ran`; a kernel
    row's largest error goes into `ctx.max_err` under each counter it
    launched."""
    from concrete_ntt_tpu_torch.utils import profiling

    for fn, arg, want in row.routes:
        got = dispatched(fn, row.n, arg)
        if got != want:
            raise Mismatch(f"{fn}(n={row.n}, {arg}) = {got}, not the {want} of ROUTES")
    card = ctx.dev.type == "cuda"
    before, tiles = (profiling.launch_counts(), profiling.tile_counts()) if card else ({}, {})
    err = None
    if row.kind != "kernel":
        detail = row.run(ctx, row.name)
    else:
        kern, plain, _ = row.make(ctx, row.name)
        got, want = kern(), plain()
        if card:
            torch.cuda.synchronize()
        err = max_abs_err(got, want)
        detail = None
    moved = {k: v - before.get(k, 0) for k, v in profiling.launch_counts().items()
             if v != before.get(k, 0)} if card else {}
    if row.kind == "kernel":
        for k in moved:
            ctx.max_err[k] = max(ctx.max_err.get(k, 0), 1 << 64 if err is None else err)
        if err != 0 or not same_bits(got, want):
            raise Mismatch("differs from its plain twin" + (f" (max |err| {err})" if err else ""))
    if not card:
        return detail or "tiles not counted"
    ran = sorted(k for k, v in profiling.tile_counts().items() if v != tiles.get(k, 0))
    if row.launches is not None and moved != row.launches:
        raise Mismatch(f"launched {moved}, not its route's {row.launches}")
    if row.ran - set(ran):
        raise Mismatch(f"tile instances {sorted(row.ran - set(ran))} never launched")
    if detail is not None:
        return detail + ("" if row.launches is None else f"; launches {moved}")
    if row.tiles is not None:
        return f"tiles {row.tiles() if callable(row.tiles) else row.tiles}"
    return f"tiles {', '.join(str(k[1:]) for k in ran) if ran else 'not counted'}"


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
    """Build every CUDA source with nvcc in parallel, one PASS / FAIL
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
