"""Golden scalar model of the negacyclic NTT (exact bigint arithmetic).

The port's oracle layer, from `concrete_ntt_tpu/golden/ntt.py`: a bit-exact
executable specification of the reference's transform semantics in pure
Python ints (no torch), so that it runs where the JAX package does not.

Conventions (reference: src/prime32.rs, src/prime64.rs):
  * `fwd` takes standard-order coefficients and returns the negacyclic NTT in
    bit-reversed order, fully reduced to [0, p)  (prime32.rs:704-708).
  * `inv` takes bit-reversed NTT values and returns standard-order
    coefficients, WITHOUT the 1/N normalization: inv(fwd(x)) == N * x mod p
    (prime32.rs:757-761; README.md:43-50).
  * Twiddle tables store powers of the primitive 2N-th root ψ in bit-reversed
    order — twid[bit_rev(k)] = ψ^k, inv_twid[bit_rev(k)] = ψ^(-k) — so the
    negacyclic twist is folded into the transform and the bit-reversal
    permutation is never materialized (prime32.rs:223-246).
"""

from __future__ import annotations

from functools import lru_cache

from ..utils.bitrev import bit_rev
from ..utils.roots import find_primitive_root64


@lru_cache(maxsize=None)
def negacyclic_twiddles(p: int, n: int) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """(twid, inv_twid) tables: twid[bit_rev(k)] = ψ^k, inv_twid[bit_rev(k)] = ψ^(-k).

    Reference: init_negacyclic_twiddles, prime32.rs:223-246.
    """
    psi = find_primitive_root64(p, 2 * n)
    if psi is None:
        raise ValueError(f"no primitive {2 * n}-th root of unity mod {p}")
    nbits = n.bit_length() - 1
    twid = [0] * n
    inv_twid = [0] * n
    wk = 1
    for k in range(n):
        twid[bit_rev(nbits, k)] = wk
        inv_twid[bit_rev(nbits, (n - k) % n)] = wk if k == 0 else p - wk
        wk = wk * psi % p
    return tuple(twid), tuple(inv_twid)


def fwd(x: list[int] | tuple[int, ...], p: int, n: int | None = None) -> list[int]:
    """Forward negacyclic NTT: standard order in, bit-reversed order out, [0,p).

    Iteration structure mirrors the reference engine
    (fwd_breadth_first_scalar, prime32/shoup.rs:582-636): m blocks double each
    stage, block width 2t halves, block i at stage with m blocks uses twiddle
    twid[m + i].
    """
    if n is None:
        n = len(x)
    assert len(x) == n and n & (n - 1) == 0
    twid, _ = negacyclic_twiddles(p, n)
    data = [v % p for v in x]
    t = n
    m = 1
    while m < n:
        t //= 2
        for i in range(m):
            w = twid[m + i]
            base = i * 2 * t
            for j in range(base, base + t):
                z0 = data[j]
                z1 = data[j + t]
                wz1 = z1 * w % p
                data[j] = (z0 + wz1) % p
                data[j + t] = (z0 - wz1) % p
        m *= 2
    return data


def inv(x: list[int] | tuple[int, ...], p: int, n: int | None = None) -> list[int]:
    """Inverse negacyclic NTT: bit-reversed in, standard order out, UNnormalized.

    inv(fwd(x)) == N*x mod p. Mirrors inv_breadth_first_scalar
    (prime32/shoup.rs:1355-1408): m halves from n, t doubles from 1, block i
    at stage with m blocks uses inv_twid[m + i] on the GS butterfly
    (z0, z1) -> (z0 + z1, (z0 - z1) * w).
    """
    if n is None:
        n = len(x)
    assert len(x) == n and n & (n - 1) == 0
    _, inv_twid = negacyclic_twiddles(p, n)
    data = [v % p for v in x]
    t = 1
    m = n
    while m > 1:
        m //= 2
        for i in range(m):
            w = inv_twid[m + i]
            base = i * 2 * t
            for j in range(base, base + t):
                z0 = data[j]
                z1 = data[j + t]
                data[j] = (z0 + z1) % p
                data[j + t] = (z0 - z1) * w % p
        t *= 2
    return data


def mul_assign_normalize(lhs: list[int], rhs: list[int], p: int, n: int) -> list[int]:
    """lhs[i] * rhs[i] * n^{-1} mod p (reference: prime32.rs:812-864)."""
    n_inv = pow(n, p - 2, p)
    return [a * b % p * n_inv % p for a, b in zip(lhs, rhs)]


def normalize(values: list[int], p: int, n: int) -> list[int]:
    """values[i] * n^{-1} mod p (reference: prime32.rs:868-902)."""
    n_inv = pow(n, p - 2, p)
    return [v * n_inv % p for v in values]


def mul_accumulate(acc: list[int], lhs: list[int], rhs: list[int], p: int) -> list[int]:
    """acc[i] + lhs[i]*rhs[i] mod p (reference: prime32.rs:905-927)."""
    return [(a + l * r) % p for a, l, r in zip(acc, lhs, rhs)]


def negacyclic_polymul(lhs: list[int], rhs: list[int], p: int) -> list[int]:
    """End-to-end negacyclic product via fwd → pointwise·n^{-1} → inv."""
    n = len(lhs)
    fl = fwd(lhs, p, n)
    fr = fwd(rhs, p, n)
    prod = mul_assign_normalize(fl, fr, p, n)
    return inv(prod, p, n)
