"""CRT residue split and signed reconstruction, in plain torch.

Counterpart of `concrete_ntt_tpu/ops/crt.py`: the exact digit structure and
sign rule of the reference's reconstruction functions, so that results are
bit-identical even at the hairline contract boundary.

  * `split_u32` / `split_u64` / `split_u128`: values → residues mod each
    30-bit prime, the reference's plain `value % p` (native64.rs:980-993).
    The channel routes fold this split into the column matmul (K1a, K2);
    the per-channel route below 2^11 and the tests use it.
  * `split_u64_to_p50`: u64 limb pairs → residues mod each ~50-bit prime as
    limb pairs (the Plan52 stage-engine route and the tests).
  * native32: single-prime Garner digits v0, v1, v2; sign = v2 > P2/2; wrap
    u32 (`rec_u32_from3`, reconstruct_32bit_012, native32.rs:28-55).
  * native64: pair digits v0 (mod P0), v12 (mod P1·P2), v34 (mod P3·P4);
    sign = v34 > P34/2; wrap u64 (`rec_u64_from5`,
    reconstruct_32bit_01234_v2, native64.rs:91-141).
  * native128: pair digits v01, v23, v45, v67, v89 mod two-prime products;
    sign = v89 > P89/2; wrap u128 (`rec_u128_from10`,
    reconstruct_32bit_0123456789_v2, native128.rs:20-118).
  * native_binary{32,64,128}: the 2 / 3 / 5-prime variants `rec_u32_from2`,
    `rec_u64_from3`, `rec_u128_from5` (native_binary32.rs:24-…,
    native_binary64.rs:33-63, native_binary128.rs:13-66).
  * Plan52 variants: 50-bit prime channels with u64-modulus Garner
    (`rec_from1_p50_u32`, `rec_from2_p50_u32`, `rec_from2_p50_u64`,
    `rec_from3_p50_u64`; reconstruct_52bit_* in native32.rs:223-…,
    native64.rs:770-829).

Elementwise over [..., n] tensors in the int64 carrier of ops/u32.py: every
place where the JAX package's uint32 arithmetic wraps is masked to 32 bits
here. Constants are Python bigints computed per call.
"""

from __future__ import annotations

import torch

from ..utils.profiling import span
from .u32 import (
    MASK32,
    add64,
    add_limbs,
    cond_sub,
    cond_sub64,
    const64_like,
    const_limbs,
    geq64,
    mul64_u32,
    mullo64,
    mullo_limbs,
    mullo_u32,
    mulwide_u32,
    reduce_u32_mod,
    select64,
    select_limbs,
    shoup_mul,
    shoup_mul_lazy64,
    sub64,
    sub_limbs,
)

sub64_pair = sub64  # the JAX package's name for the wrapping limb-pair subtract


def split_u32(x, primes) -> list:
    """u32 values → per-channel residues mod each 30-bit prime."""
    return [reduce_u32_mod(x, p, (1 << 32) // p) for p in primes]


def split_u64(lo, hi, primes) -> list:
    """u64 limb pairs → residues mod each 30-bit prime.

    r = ((hi mod p)·(2^32 mod p) + (lo mod p)) mod p — identical value to the
    reference's plain `value % p` (native64.rs:980-993).
    """
    out = []
    for p in primes:
        m = (1 << 32) // p
        r32 = (1 << 32) % p
        r32_shoup = (r32 << 32) // p
        hi_mod = reduce_u32_mod(hi, p, m)
        t = shoup_mul(hi_mod, r32, r32_shoup, p)  # [0,p)
        lo_mod = reduce_u32_mod(lo, p, m)
        out.append(cond_sub(t + lo_mod, p))
    return out


def split_u128(limbs4, primes) -> list:
    """u128 as 4 u32 limbs → residues mod each 30-bit prime (Horner)."""
    l0, l1, l2, l3 = limbs4
    out = []
    for p in primes:
        m = (1 << 32) // p
        r32 = (1 << 32) % p
        r32_shoup = (r32 << 32) // p
        r = reduce_u32_mod(l3, p, m)
        for limb in (l2, l1, l0):
            r = shoup_mul(r, r32, r32_shoup, p)
            r = cond_sub(r + reduce_u32_mod(limb, p, m), p)
        out.append(r)
    return out


def split_u64_to_p50(lo, hi, primes64) -> list:
    """u64 limb pairs → residues mod each ~50-bit prime, as limb pairs.

    For p > 2^32: hi, lo < 2^32 < p are already reduced; r = hi·(2^32 mod p) + lo.
    """
    out = []
    z = torch.zeros_like(lo)
    for p in primes64:
        r32 = (1 << 32) % p
        ws = (r32 << 64) // p
        t = shoup_mul_lazy64((hi, z), const64_like(r32), const64_like(ws), p)  # [0, 2p)
        r = add64(cond_sub64(t, p), (lo, z))  # < p + 2^32 < 2p
        out.append(cond_sub64(r, p))
    return out


# ---------------------------------------------------------------------------
# Garner helpers
# ---------------------------------------------------------------------------


def _mul_mod32(b, a_const: int, p: int):
    """a_const·b mod p for b < 2^32 (reference mul_mod32, native32.rs:21-24)."""
    a_shoup = (a_const << 32) // p
    return shoup_mul(b, a_const, a_shoup, p)


def _mul_mod64(b_pair, a_const: int, p: int):
    """a_const·b mod p for u64 b, p < 2^62 (reference mul_mod64)."""
    a_shoup = (a_const << 64) // p
    t = shoup_mul_lazy64(b_pair, const64_like(a_const), const64_like(a_shoup), p)
    return cond_sub64(t, p)


def _pair_digit(mod_lo, mod_hi, p_lo: int, p_hi: int):
    """Two-prime Garner digit: value mod (p_lo·p_hi) as a u64 limb pair.

    v_hi = (mod_hi - v_lo)·p_lo^{-1} mod p_hi; result = v_lo + v_hi·p_lo —
    the reference's mod_pXY blocks (native64.rs:100-109).
    """
    inv = pow(p_lo, p_hi - 2, p_hi)
    diff = (2 * p_hi + mod_hi - mod_lo) & MASK32  # < 3p < 2^32
    v_hi = _mul_mod32(diff, inv, p_hi)
    prod = mulwide_u32(v_hi, p_lo)
    return add64(prod, (mod_lo, torch.zeros_like(mod_lo)))


def _sub_mod64_lazy(a_pair, b_pair, p: int):
    """(2p + a - b) used as the mul_mod64 operand (value ≡ a-b, < 3p < 2^64)."""
    return add64(sub64(a_pair, b_pair), const64_like(2 * p))


def _garner3_digits(mods, primes):
    """Single-prime Garner digits v0, v1, v2 of three 30-bit channels and
    the sign v2 > P2/2 (native32.rs:28-55, native_binary64.rs:33-63). The
    `& MASK32` stand where the JAX package's uint32 sums wrap (they cannot
    here: 2p + m - v < 3p < 2^32 and stays positive)."""
    p0, p1, p2 = primes
    m0, m1, m2 = mods
    v0 = m0
    v1 = _mul_mod32((2 * p1 + m1 - v0) & MASK32, pow(p0, p1 - 2, p1), p1)
    partial = v0 + _mul_mod32(v1, p0 % p2, p2)  # v0 + P0·v1 mod-ish; < 2^32
    v2 = _mul_mod32((2 * p2 + m2 - partial) & MASK32, pow(p0 * p1 % p2, p2 - 2, p2), p2)
    return v0, v1, v2, v2 > p2 // 2


def rec_u32_from3(mods, primes):
    """3×u32 residues → wrapping u32 (reconstruct_32bit_012, native32.rs:28-55)."""
    p0, p1, p2 = primes
    v0, v1, v2, sign = _garner3_digits(mods, primes)
    pos = (v0 + mullo_u32(v1, p0 & MASK32) + mullo_u32(v2, (p0 * p1) & MASK32)) & MASK32
    neg = (pos - ((p0 * p1 * p2) & MASK32)) & MASK32
    return torch.where(sign, neg, pos)


def rec_u32_from2(mods, primes):
    """2×u32 residues → wrapping u32 (native_binary32.rs reconstruction)."""
    p0, p1 = primes
    m0, m1 = mods
    v0 = m0
    v1 = _mul_mod32((2 * p1 + m1 - v0) & MASK32, pow(p0, p1 - 2, p1), p1)
    sign = v1 > p1 // 2
    pos = (v0 + mullo_u32(v1, p0)) & MASK32
    neg = (pos - ((p0 * p1) & MASK32)) & MASK32
    return torch.where(sign, neg, pos)


def rec_u64_from3(mods, primes):
    """3×u32 residues → wrapping u64 limb pair (native_binary64.rs:33-63)."""
    p0, p1, p2 = primes
    v0, v1, v2, sign = _garner3_digits(mods, primes)
    pos = add64(
        (v0, torch.zeros_like(v0)),
        add64(mulwide_u32(v1, p0), mul64_u32(const64_like(p0 * p1), v2)),
    )
    neg = sub64(pos, const64_like((p0 * p1 * p2) & ((1 << 64) - 1)))
    return select64(sign, neg, pos)


def _pair_digits_from5(mods, primes):
    """The v2 pairing of five 30-bit channels: digits v0 (mod P0, a limb
    pair), v12 (mod P1·P2), v34 (mod P3·P4) and the sign v34 > P34/2
    (native64.rs:91-141, native_binary128.rs:13-66)."""
    p0, p1, p2, p3, p4 = primes
    m0, m1, m2, m3, m4 = mods
    p12 = p1 * p2
    p34 = p3 * p4
    mod_p12 = _pair_digit(m1, m2, p1, p2)
    mod_p34 = _pair_digit(m3, m4, p3, p4)

    v0 = (m0, torch.zeros_like(m0))
    v12 = _mul_mod64(
        _sub_mod64_lazy(mod_p12, v0, p12), pow(p0 % p12, (p1 - 1) * (p2 - 1) - 1, p12), p12
    )
    partial = add64(v0, _mul_mod64(v12, p0 % p34, p34))
    v34 = _mul_mod64(
        _sub_mod64_lazy(mod_p34, partial, p34),
        pow((p0 * p12) % p34, (p3 - 1) * (p4 - 1) - 1, p34),
        p34,
    )
    return v0, v12, v34, geq64(v34, const64_like(p34 // 2 + 1))


def rec_u64_from5(mods, primes):
    """5×u32 residues → wrapping u64 limb pair, v2 pairing
    (reconstruct_32bit_01234_v2, native64.rs:91-141)."""
    p0, p1, p2, p3, p4 = primes
    p12 = p1 * p2
    v0, v12, v34, sign = _pair_digits_from5(mods, primes)
    mask64 = (1 << 64) - 1
    pos = add64(v0, add64(mullo64(v12, const64_like(p0)), mullo64(v34, const64_like((p0 * p12) & mask64))))
    neg = sub64(pos, const64_like((p0 * p12 * p3 * p4) & mask64))
    return select64(sign, neg, pos)


def rec_u128_from5(mods, primes):
    """5×u32 residues → wrapping u128 (4 limbs), v2 pairing
    (native_binary128.rs:13-66: digits v0, v12, v34; sign = v34 > P34/2)."""
    p0, p1, p2, p3, p4 = primes
    p12 = p1 * p2
    v0, v12, v34, sign = _pair_digits_from5(mods, primes)
    mask128 = (1 << 128) - 1
    pos = add_limbs(
        (v0[0], 0, 0, 0),
        add_limbs(
            mullo_limbs(v12, const_limbs(p0, 2), 4),
            mullo_limbs(v34, const_limbs(p0 * p12, 4), 4),
        ),
    )
    neg = sub_limbs(pos, const_limbs((p0 * p12 * p3 * p4) & mask128, 4))
    return select_limbs(sign, neg, pos)


def _pair_digits_from10(mods, primes):
    """The v2 pairing of ten 30-bit channels: the mixed-radix digits v01,
    v23, v45, v67, v89 over the pair moduli P01 … P89 (limb pairs), the
    pair moduli, and the sign v89 > P89/2 (native128.rs:20-118)."""
    assert len(primes) == 10 and len(mods) == 10
    pairs = [(primes[2 * i], primes[2 * i + 1]) for i in range(5)]
    pair_mods = [_pair_digit(mods[2 * i], mods[2 * i + 1], *pairs[i]) for i in range(5)]
    pair_p = [a * b for a, b in pairs]  # P01, P23, P45, P67, P89

    # Outer Garner over the 5 pair-moduli (digits v01, v23, v45, v67, v89).
    digits = [pair_mods[0]]
    prefix = 1  # product of pair moduli consumed so far
    for i in range(1, 5):
        prefix = prefix * pair_p[i - 1]
        pi = pair_p[i]
        # partial = Σ_{j<i} digit_j · (Π_{l<j} pairP_l) mod pi, Horner style
        acc = digits[-1]
        for j in range(i - 2, -1, -1):
            acc = add64(digits[j], _mul_mod64(acc, pair_p[j] % pi, pi))
        # acc < 2p-ish; keep lazy, _sub_mod64_lazy tolerates < 3p
        phi = pow(prefix % pi, _carmichael(pairs[i]) - 1, pi)
        digits.append(_mul_mod64(_sub_mod64_lazy(pair_mods[i], acc, pi), phi, pi))
    return digits, pair_p, geq64(digits[4], const64_like(pair_p[4] // 2 + 1))


def rec_u128_from10(mods, primes):
    """10×u32 residues → wrapping u128, v2 pairing
    (reconstruct_32bit_0123456789_v2, native128.rs:20-118). Two stage
    spans: `ntt.lift_digits` (the pair digits, the outer Garner, the sign)
    and `ntt.lift_limbs` (the four-limb multiply-accumulate by the prefix
    products, the subtraction of P, the sign select)."""
    with span("ntt.lift_digits", "lift_digits") as sp:
        digits, pair_p, sign = _pair_digits_from10(mods, primes)
        sp.io(mods, digits, sign)
    with span("ntt.lift_limbs", "lift_limbs") as sp:
        mask128 = (1 << 128) - 1
        pos = (digits[0][0], digits[0][1], 0, 0)
        pref = 1
        for i in range(1, 5):
            pref = pref * pair_p[i - 1]
            pos = add_limbs(pos, mullo_limbs(digits[i], const_limbs(pref & mask128, 4), 4))
        neg = sub_limbs(pos, const_limbs((pref * pair_p[4]) & mask128, 4))
        out = select_limbs(sign, neg, pos)
        sp.io(digits, sign, out)
    return out


def _carmichael(pair):
    a, b = pair
    return (a - 1) * (b - 1)


# ---------------------------------------------------------------------------
# Plan52 reconstructions: ~50-bit prime channels (residues as u64 limb pairs)
# ---------------------------------------------------------------------------


def rec_from1_p50_u32(mods, primes):
    """1×u64 residue (50-bit prime) → wrapping u32 (native_binary32 Plan52)."""
    (p0,) = primes
    (m0,) = mods
    sign = geq64(m0, const64_like(p0 // 2 + 1))
    pos = m0[0]
    neg = (pos - (p0 & MASK32)) & MASK32
    return torch.where(sign, neg, pos)


def _garner2_p50(mods, primes):
    """Digits v0, v1 of two 50-bit channels and the sign v1 > P1/2."""
    p0, p1 = primes
    m0, m1 = mods
    v1 = _mul_mod64(_sub_mod64_lazy(m1, m0, p1), pow(p0 % p1, p1 - 2, p1), p1)
    return m0, v1, geq64(v1, const64_like(p1 // 2 + 1))


def rec_from2_p50_u32(mods, primes):
    """2×u64 residues (50-bit primes) → wrapping u32
    (reconstruct_52bit_01, native32.rs:223-253)."""
    p0, p1 = primes
    v0, v1, sign = _garner2_p50(mods, primes)
    pos = (v0[0] + mullo_u32(v1[0], p0 & MASK32)) & MASK32
    neg = (pos - ((p0 * p1) & MASK32)) & MASK32
    return torch.where(sign, neg, pos)


def rec_from2_p50_u64(mods, primes):
    """2×u64 residues (50-bit primes) → wrapping u64 (native_binary64 Plan52)."""
    p0, p1 = primes
    v0, v1, sign = _garner2_p50(mods, primes)
    pos = add64(v0, mullo64(v1, const64_like(p0)))
    neg = sub64(pos, const64_like((p0 * p1) & ((1 << 64) - 1)))
    return select64(sign, neg, pos)


def rec_from3_p50_u64(mods, primes):
    """3×u64 residues (50-bit primes, limb pairs) → wrapping u64 limb pair
    (reconstruct_52bit_012, native64.rs:770-829). Two stage spans:
    `ntt.lift_digits` (the Garner digits v1 mod p1 and v2 mod p2, the
    partial sum, the sign) and `ntt.lift_limbs` (v0 + v1·p0 + v2·(p0·p1)
    mod 2^64, the subtraction of P, the sign select)."""
    p0, p1, p2 = primes
    m0, m1, m2 = mods
    v0 = m0
    with span("ntt.lift_digits", "lift_digits") as sp:
        v1 = _mul_mod64(_sub_mod64_lazy(m1, v0, p1), pow(p0 % p1, p1 - 2, p1), p1)
        partial = add64(v0, _mul_mod64(v1, p0 % p2, p2))
        v2 = _mul_mod64(_sub_mod64_lazy(m2, partial, p2), pow((p0 * p1) % p2, p2 - 2, p2), p2)
        sign = geq64(v2, const64_like(p2 // 2 + 1))
        sp.io(mods, (v1, v2), sign)
    with span("ntt.lift_limbs", "lift_limbs") as sp:
        mask64 = (1 << 64) - 1
        pos = add64(v0, add64(mullo64(v1, const64_like(p0)),
                              mullo64(v2, const64_like((p0 * p1) & mask64))))
        neg = sub64(pos, const64_like((p0 * p1 * p2) & mask64))
        out = select64(sign, neg, pos)
        sp.io((v0, v1, v2), sign, out)
    return out
