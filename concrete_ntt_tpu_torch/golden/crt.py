"""Golden CRT residue split + signed reconstruction (exact bigints).

Executable specification of the native plans' CRT layer
(reference: src/native32.rs, native64.rs, native128.rs):

  * fwd residue split: residue_i = value % p_i on the *unsigned* input value
    (native64.rs:980-993);
  * inverse reconstruction with signed truncation: combine residues to
    v ∈ [0, M) with M = Π p_i, re-center to (-M/2, M/2], and reduce wrapping
    mod 2^bits (the mixed-radix/Garner lift of native64.rs:91-141 computes the
    same mathematical value; we use the explicit-CRT form since exactness, not
    instruction scheduling, is what defines parity).
"""

from __future__ import annotations

from ..tables import crt_constants


def residues(values, primes) -> list[list[int]]:
    """Per-channel residue split: [len(primes)][n]."""
    return [[int(v) % p for v in values] for p in primes]


def reconstruct_signed_wrapping(channel_values: list[list[int]], primes, bits: int) -> list[int]:
    """Signed CRT lift of per-channel residues, truncated wrapping mod 2^bits.

    channel_values[i][j] = j-th coefficient's residue mod primes[i].
    Returns coefficients in [0, 2^bits).
    """
    consts = crt_constants(tuple(primes))
    m = consts["product"]
    half = consts["half"]
    y = consts["y"]
    big_m = consts["big_m"]
    n = len(channel_values[0])
    mask = (1 << bits) - 1
    out = []
    for j in range(n):
        v = 0
        for i, p in enumerate(primes):
            v += (channel_values[i][j] * y[i] % p) * big_m[i]
        v %= m
        if v > half:
            v -= m
        out.append(v & mask)
    return out
