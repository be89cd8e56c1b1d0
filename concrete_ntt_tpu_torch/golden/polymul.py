"""Schoolbook negacyclic convolution oracle (exact, O(n^2)), numpy.

Parity with the reference's shared test helpers `negacyclic_convolution` /
`random_lhs_rhs_with_negacyclic_convolution` (prime32.rs:966-1005,
prime64.rs:1170-1205, native128.rs:359-…): full O(n^2) convolution followed by
c[i] - c[i+n], with modulus 0 meaning *wrapping machine arithmetic* — the
semantics the native (CRT) plans must reproduce (native64.rs:1208-1213).
"""

from __future__ import annotations

import numpy as np


def negacyclic_convolution_mod(lhs, rhs, p: int) -> list[int]:
    """Exact schoolbook negacyclic convolution mod p (p > 0) with bigints."""
    n = len(lhs)
    assert len(rhs) == n
    full = [0] * (2 * n)
    for i, a in enumerate(lhs):
        ai = int(a)
        for j, b in enumerate(rhs):
            full[i + j] += ai * int(b)
    return [(full[i] - full[i + n]) % p for i in range(n)]


def negacyclic_convolution_wrapping(lhs, rhs, bits: int) -> list[int]:
    """Schoolbook negacyclic convolution in wrapping arithmetic mod 2^bits.

    This is the exactness contract of the native plans: the reference's test
    oracle with p == 0 runs in wrapping u32/u64/u128 machine arithmetic
    (prime32.rs:957-963 treats p == 0 as wrapping).
    """
    return negacyclic_coefficients_wrapping(lhs, rhs, range(len(lhs)), bits)


def negacyclic_coefficients_wrapping(lhs, rhs, ks, bits: int) -> list[int]:
    """Coefficients `ks` of the wrapping negacyclic product mod 2^bits, each
    an O(n) bigint sum: c[k] = Σ_{i<=k} a[i]·b[k-i] - Σ_{i>k} a[i]·b[n+k-i].
    Sampling a few coefficients holds a large transform to the contract
    where the whole O(n^2) product would take too long."""
    mask = (1 << bits) - 1
    a = [int(v) for v in lhs]
    b = [int(v) for v in rhs]
    n = len(a)
    assert len(b) == n
    out = []
    for k in ks:
        pos = sum(a[i] * b[k - i] for i in range(k + 1))
        neg = sum(a[i] * b[n + k - i] for i in range(k + 1, n))
        out.append((pos - neg) & mask)
    return out


def negacyclic_convolution_wrapping_np(lhs: np.ndarray, rhs: np.ndarray) -> np.ndarray:
    """Vectorized wrapping oracle for u32/u64 NumPy inputs (faster, same result).

    Relies on NumPy's well-defined unsigned wraparound. Chunked outer-product
    accumulation keeps memory bounded for large n.
    """
    n = lhs.shape[-1]
    assert rhs.shape[-1] == n
    dt = lhs.dtype
    full = np.zeros(2 * n, dtype=dt)
    chunk = max(1, (1 << 22) // n)
    with np.errstate(over="ignore"):
        for start in range(0, n, chunk):
            stop = min(start + chunk, n)
            outer = lhs[start:stop, None] * rhs[None, :]
            for k, i in enumerate(range(start, stop)):
                full[i : i + n] += outer[k]
    return full[:n] - full[n:]
