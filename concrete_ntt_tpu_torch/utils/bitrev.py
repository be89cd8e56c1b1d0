"""Bit-reversal helpers (reference: bit_rev, lib.rs:118-121).

The reference never materializes a bit-reversal permutation of the data; the
bit-reversed ordering lives in the *twiddle table storage order*
(prime32.rs:223-246). We keep that property: these helpers are used only at
plan-build time to lay out twiddle tables, never in device hot paths.
"""

from __future__ import annotations

import numpy as np


def bit_rev(nbits: int, i: int) -> int:
    """Reverse the low `nbits` bits of i."""
    r = 0
    for _ in range(nbits):
        r = (r << 1) | (i & 1)
        i >>= 1
    return r


def bit_rev_indices(n: int) -> np.ndarray:
    """Vector of bit_rev(log2(n), i) for i in range(n) (uint64)."""
    assert n & (n - 1) == 0 and n >= 1
    nbits = n.bit_length() - 1
    idx = np.arange(n, dtype=np.uint64)
    out = np.zeros(n, dtype=np.uint64)
    for _ in range(nbits):
        out = (out << np.uint64(1)) | (idx & np.uint64(1))
        idx >>= np.uint64(1)
    return out
