"""Schoolbook negacyclic convolution oracle (exact, O(n^2)), numpy.

Parity with the reference's shared test helpers `negacyclic_convolution` /
`random_lhs_rhs_with_negacyclic_convolution` (prime32.rs:966-1005,
prime64.rs:1170-1205, native128.rs:359-…): full O(n^2) convolution followed by
c[i] - c[i+n], with modulus 0 meaning *wrapping machine arithmetic* — the
semantics the native (CRT) plans must reproduce (native64.rs:1208-1213).
"""

from __future__ import annotations

import numpy as np


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
