"""NTT-friendly 30-bit prime tables (host-side, plain Python).

Counterpart of `concrete_ntt_tpu/tables.py`, copied so that the port never
imports the JAX package. The reference library hardcodes ten 30-bit primes
P0..P9, each ≡ 1 (mod 2^16), which support negacyclic transforms up to
N = 2^15 (reference src/lib.rs:447-462). The native64 Plan32 uses the first
five. An extended family ≡ 1 (mod 2^18) reaches N = 2^17.

Only what the native64 Plan32 path needs comes across; the 52-bit table,
the Goldilocks constant, the other native prime selections and
`crt_constants` wait for the slices that use them (ROADMAP.md).
"""

from __future__ import annotations

from functools import lru_cache

from .utils.fastdiv import magic_u64
from .utils.prime import is_prime64

# reference src/lib.rs:453-462 (primes32)
PRIMES32: tuple[int, ...] = (
    0x3F5A0001,
    0x3F5D0001,
    0x3F760001,
    0x3F820001,
    0x3FAC0001,
    0x3FAF0001,
    0x3FB10001,
    0x3FBB0001,
    0x3FDE0001,
    0x3FFC0001,
)


def generate_ntt_primes(
    count: int, bits: int, two_n_divides: int, below: int | None = None
) -> tuple[int, ...]:
    """Regenerate a prime table: the `count` largest primes p < 2^bits with
    p ≡ 1 (mod two_n_divides) whose round-up division magic constant is exact
    for all u64 numerators (the reference's selection procedure,
    lib.rs:424-445). Returned in ascending order, like the reference tables.
    """
    out: list[int] = []
    step = two_n_divides
    x = ((below if below is not None else (1 << bits)) - 2) // step
    while len(out) < count and x > 0:
        p = step * x + 1
        if is_prime64(p) and magic_u64(p).exact_for_u64:
            out.append(p)
        x -= 1
    if len(out) < count:
        raise RuntimeError("prime search exhausted")
    return tuple(sorted(out))


@lru_cache(maxsize=None)
def primes32_ext() -> tuple[int, ...]:
    """Extended family: ten 30-bit primes ≡ 1 (mod 2^18) → N up to 2^17."""
    return generate_ntt_primes(10, 30, 1 << 18)


# native64 Plan32 → P0..P4 (reference native64.rs:16-22)
NATIVE64_PRIMES = PRIMES32[:5]


def native_channel_primes(k: int, n: int) -> tuple[int, ...] | None:
    """First k 30-bit CRT channel primes supporting transform size n.

    n <= 2^15 uses the reference's table (≡ 1 mod 2^16); n in (2^15, 2^17]
    uses the extended ≡ 1 (mod 2^18) family. Returns None when n is out of
    range."""
    if n <= (1 << 15):
        return PRIMES32[:k]
    if n <= (1 << 17):
        return primes32_ext()[:k]
    return None
