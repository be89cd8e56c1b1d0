"""Negacyclic twiddle tables of the golden model (exact bigint arithmetic).

From `concrete_ntt_tpu/golden/ntt.py`, the part the port's table builders
need; its oracle transforms come across with the slices that test against
them. Twiddle tables store powers of the primitive 2N-th root ψ in
bit-reversed order — twid[bit_rev(k)] = ψ^k, inv_twid[bit_rev(k)] = ψ^(-k) —
so the negacyclic twist is folded into the transform and the bit-reversal
permutation is never materialized (reference prime32.rs:223-246).
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

