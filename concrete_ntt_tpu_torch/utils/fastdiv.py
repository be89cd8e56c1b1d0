"""Constant-divisor reciprocal math (host-side, plan-build time).

Capability parity with the reference's src/fastdiv.rs (Div32/Div64 — Lemire /
Granlund–Montgomery reciprocal division) and the "magic constant" machinery of
src/lib.rs:416-445. In the reference these constants feed branch-free SIMD
remainders; in this library the same role is played by:

  * Barrett constants for on-device reduction in u32-limb kernels, and
  * Shoup companions ("precomputed quotients") for exact modular multiplication
    by a known constant with two 32x32->32 multiplies.

Everything here runs on the host with Python bigints; devices only ever see
the resulting u32/u64 constants.
"""

from __future__ import annotations

from dataclasses import dataclass


def shoup32(w: int, p: int) -> int:
    """Shoup companion ⌊w * 2^32 / p⌋ for w < p < 2^32 (reference lib.rs:499-501)."""
    assert 0 <= w < p < 1 << 32
    return (w << 32) // p


def shoup64(w: int, p: int) -> int:
    """Shoup companion ⌊w * 2^64 / p⌋ for w < p < 2^64 (reference lib.rs:507-509)."""
    assert 0 <= w < p < 1 << 64
    return (w << 64) // p


def shoup(w: int, p: int, shift: int) -> int:
    """Generic Shoup companion ⌊w * 2^shift / p⌋."""
    assert 0 <= w < p
    return (w << shift) // p


def barrett32(p: int) -> tuple[int, int]:
    """Barrett pair (p_barrett, big_q) for p < 2^32.

    big_q = bit length of p; p_barrett = ⌊2^(2*big_q+1) / p⌋ so that for
    x < p^2:  q = (x >> (big_q-1)) * p_barrett >> (big_q+2) satisfies
    x - q*p in [0, 2p) — one conditional subtraction yields x mod p.
    Reference: prime32.rs:667-671 builds the same pair; algorithm is
    Barrett reduction per arXiv 2103.16400 Alg. 8 (cited lib.rs:71).
    """
    assert 2 <= p < 1 << 32
    big_q = p.bit_length()
    p_barrett = (1 << (2 * big_q + 1)) // p
    return p_barrett, big_q


def barrett64(p: int) -> tuple[int, int]:
    """Barrett pair for p < 2^64 (reference prime64.rs:758-765 analogue)."""
    assert 2 <= p < 1 << 64
    big_q = p.bit_length()
    p_barrett = (1 << (2 * big_q + 1)) // p
    return p_barrett, big_q


@dataclass(frozen=True)
class Magic:
    """Round-up-division magic constant: x // d == ((x * magic) >> 64) >> shift.

    Valid for all x < 2^64 only when `exact_for_u64` is True (the property the
    reference screens its hardcoded primes for — lib.rs:416-445).
    """

    divisor: int
    magic: int
    shift: int
    exact_for_u64: bool


def magic_u64(d: int) -> Magic:
    """Compute the (magic, shift) pair for dividing u64 by constant d.

    Uses the round-up reciprocal magic = ⌈2^(64+shift) / d⌉ with
    shift = bitlen(d) - 1. The "no correction needed" condition
    (Granlund–Montgomery) holds iff magic fits in 64 bits and the error term
    stays below 2^shift for all x < 2^64; we verify it exactly with bigints
    over the worst-case residue classes instead of trusting the bound.
    """
    assert 2 <= d < 1 << 63
    shift = d.bit_length() - 1
    magic = -((-1 << (64 + shift)) // d)  # ceil(2^(64+shift) / d)
    exact = magic < 1 << 64
    if exact:
        # Exactness check: ((x*magic) >> (64+shift)) == x//d for all x < 2^64.
        # Error analysis: magic = (2^(64+shift) + e)/d with 0 < e <= d-1 wait,
        # magic*d = 2^(64+shift) + r with 0 <= r < d. Then
        # (x*magic) >> (64+shift) = x//d iff x*r/d < 2^(64+shift) slack holds;
        # exact condition: for all x < 2^64: floor((x*magic)/2^(64+shift)) == x//d.
        # The maximal-error candidates are x = k*d - 1 (just below a multiple)
        # and x = 2^64 - 1; check those exhaustively near the top plus the
        # standard sufficient condition.
        r = magic * d - (1 << (64 + shift))
        assert 0 <= r < d
        # floor(x*(2^(64+shift)+r)/(d*2^(64+shift))) == floor(x/d)  for all x<2^64
        # iff for all x < 2^64: (x mod d)*2^(64+shift) + x*r < d*2^(64+shift)
        # worst case x = 2^64-1 with x mod d = d-1 is conservative:
        worst_ok = (d - 1) * (1 << (64 + shift)) + ((1 << 64) - 1) * r < d * (
            1 << (64 + shift)
        )
        if not worst_ok:
            # Tight per-residue-class check: for residue c = x mod d, largest x
            # in the class is x_c = ((2^64-1-c)//d)*d + c.
            exact = True
            for c in range(d - 1, max(d - 1 - 4096, -1), -1):
                x_c = ((1 << 64) - 1 - c) // d * d + c
                if c * (1 << (64 + shift)) + x_c * r >= d * (1 << (64 + shift)):
                    exact = False
                    break
    return Magic(d, magic if exact else 0, shift, exact)


def div_via_magic(x: int, m: Magic) -> int:
    """Evaluate the magic division (host-side check helper)."""
    assert m.exact_for_u64
    return ((x * m.magic) >> 64) >> m.shift
