"""Primality testing and prime search (host-side, plan-build time).

Capability parity with the reference's const-eval number-theory layer
(reference: src/prime.rs — `is_prime64` at prime.rs:76,
`largest_prime_in_arithmetic_progression64` at prime.rs:130). The reference
implements these as Rust `const fn`s over precomputed-reciprocal division so
they can run at compile time; here they run at plan-build/import time on the
host, so plain Python arbitrary-precision integers are the idiomatic (and
simpler) choice. Nothing in this module touches the accelerator.
"""

from __future__ import annotations

# Deterministic Miller–Rabin witness set for all n < 2^64
# (the standard 12-base set; the reference uses the same set, prime.rs:85-100).
_MR_BASES_U64 = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def exp_mod(base: int, exponent: int, modulus: int) -> int:
    """Modular exponentiation (reference: exp_mod32/exp_mod64, prime.rs:12-48)."""
    return pow(base, exponent, modulus)


def _is_strong_probable_prime(n: int, base: int) -> bool:
    if base % n == 0:
        return True
    d = n - 1
    s = 0
    while d % 2 == 0:
        d //= 2
        s += 1
    x = pow(base, d, n)
    if x == 1 or x == n - 1:
        return True
    for _ in range(s - 1):
        x = (x * x) % n
        if x == n - 1:
            return True
    return False


def is_prime64(n: int) -> bool:
    """Deterministic primality test for 0 <= n < 2^64.

    Reference: `is_prime64` (prime.rs:50-126) — deterministic Miller–Rabin
    with the 12-witness base set, exact for all u64.
    """
    if not 0 <= n < 1 << 64:
        raise ValueError(f"is_prime64 requires 0 <= n < 2^64, got {n}")
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    return all(_is_strong_probable_prime(n, a) for a in _MR_BASES_U64)


def largest_prime_in_arithmetic_progression64(
    factor: int, offset: int, lo: int, hi: int
) -> int | None:
    """Largest prime p = factor*x + offset with lo <= p <= hi, scanning down.

    Reference: prime.rs:130-180. Used to pick NTT-friendly primes
    p ≡ 1 (mod 2N) so that 2N-th roots of unity exist.
    """
    if factor <= 0:
        raise ValueError("factor must be positive")
    # Largest x such that factor*x + offset <= hi.
    x = (hi - offset) // factor
    while True:
        candidate = factor * x + offset
        if candidate < lo:
            return None
        if 0 <= candidate < 1 << 64 and is_prime64(candidate):
            return candidate
        x -= 1


def largest_ntt_prime(two_n: int, bits: int) -> int | None:
    """Largest prime p < 2^bits with p ≡ 1 (mod two_n) (convenience wrapper)."""
    return largest_prime_in_arithmetic_progression64(two_n, 1, 2, (1 << bits) - 1)
