"""The plain reference of native128's Plan32 polymul, exact, in plain torch.

`polymul_u128`: the wrapping negacyclic product mod (X^n + 1, 2^128) of u128
polynomials, the guarantee of native128's Plan32 (the definition of the
port's `golden/polymul.py`, the negacyclic convolution with p = 0 meaning
wrapping arithmetic). Each operand is split into eight 16-bit limbs; for
each weight 2^(16·s), s < 8, the limb products a_k ⊛ b_l with k + l = s
(the 36 of weight below 2^128) are summed exactly in the residue domain of
`exact.py`'s two primes (|coefficient| < 8·n·2^32, below 2^60 for n < 2^25),
and the eight sums are carried into 16-bit result limbs, the carry out of
the top limb dropped (mod 2^128). The one departure from calling
`exact.negacyclic_conv` once a weight: each limb is transformed once and its
transform shared by every product it takes part in, as
`products.polymul_u64` does; the sums are the same.

Inputs and outputs are int64 tensors of u32 words; nothing here reads the port.
"""

from __future__ import annotations

from . import exact

LIMBS16 = 8
MASK16 = 0xFFFF


def _limbs16(words) -> list:
    return [(w >> (16 * h)) & MASK16 for w in words for h in (0, 1)]


def polymul_u128(a_words, b_words) -> tuple:
    """Four int64 words in [0, 2^32) (low first) of the wrapping product of
    two u128 polynomials given as four such words each, [..., n]."""
    a, b = _limbs16(a_words), _limbs16(b_words)
    n = a[0].shape[-1]
    if LIMBS16 * n * MASK16 ** 2 >= 1 << exact.BOUND_BITS:
        raise ValueError(f"n={n} is too large for the exact limb product")
    groups = [[] for _ in range(LIMBS16)]
    for p in exact.PRIMES:
        t = exact.tables(n, p, a[0].device)
        ah = [exact.ntt(x, t) for x in a]
        bh = [exact.ntt(x, t) for x in b]
        for s in range(LIMBS16):
            acc = None
            for k in range(s + 1):
                prod = (ah[k] * bh[s - k]) % p
                acc = prod if acc is None else (acc + prod) % p
            groups[s].append(exact.intt(acc, t))
        del ah, bh
    out, carry = [], None
    for s in range(LIMBS16):
        v = exact.crt_signed(*groups[s])
        groups[s] = None
        if carry is not None:
            v = v + carry
        out.append(v & MASK16)
        carry = v >> 16  # arithmetic shift: floor division, right for negative sums
    return tuple(out[2 * j] | (out[2 * j + 1] << 16) for j in range(4))
