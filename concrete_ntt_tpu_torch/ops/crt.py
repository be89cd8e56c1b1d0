"""CRT residue split and signed reconstruction, in plain torch.

Counterpart of `concrete_ntt_tpu/ops/crt.py`: the native64 pieces, for the
Plan32 tier (five 30-bit channels) and the Plan52 tier (three 50-bit
channels).

  * `split_u64`: u64 limb pairs → residues mod each 30-bit prime, the
    reference's plain `value % p` (native64.rs:980-993). The main path folds
    this split into K1a's column matmul; the tests use it as a cross-check.
  * `rec_u64_from5`: pair digits v0 (mod P0), v12 (mod P1·P2), v34
    (mod P3·P4); sign = v34 > P34/2; wrap u64 (reconstruct_32bit_01234_v2,
    native64.rs:91-141). The exact digit structure and sign rule keep the
    results bit-identical at the hairline contract boundary.
  * `split_u64_to_p50`: u64 limb pairs → residues mod each ~50-bit prime as
    limb pairs. The Plan52 kernel routes fold this split into the column
    matmul; the stage-engine route and the tests use it.
  * `rec_from3_p50_u64`: 3×u64 residues → wrapping u64 (reconstruct_52bit_012,
    native64.rs:770-829).

Elementwise over [..., n] tensors in the int64 carrier of ops/u32.py;
constants are Python bigints computed per call.
"""

from __future__ import annotations

import torch

from .u32 import (
    MASK32,
    add64,
    cond_sub,
    cond_sub64,
    const64_like,
    geq64,
    mullo64,
    mulwide_u32,
    reduce_u32_mod,
    select64,
    shoup_mul,
    shoup_mul_lazy64,
    sub64,
)


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


def rec_u64_from5(mods, primes):
    """5×u32 residues → wrapping u64 limb pair, v2 pairing
    (reconstruct_32bit_01234_v2, native64.rs:91-141)."""
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
    sign = geq64(v34, const64_like(p34 // 2 + 1))
    mask64 = (1 << 64) - 1
    pos = add64(v0, add64(mullo64(v12, const64_like(p0)), mullo64(v34, const64_like((p0 * p12) & mask64))))
    neg = sub64(pos, const64_like((p0 * p12 * p34) & mask64))
    return select64(sign, neg, pos)


def rec_from3_p50_u64(mods, primes):
    """3×u64 residues (50-bit primes, limb pairs) → wrapping u64 limb pair
    (reconstruct_52bit_012, native64.rs:770-829)."""
    p0, p1, p2 = primes
    m0, m1, m2 = mods
    v0 = m0
    v1 = _mul_mod64(_sub_mod64_lazy(m1, v0, p1), pow(p0 % p1, p1 - 2, p1), p1)
    partial = add64(v0, _mul_mod64(v1, p0 % p2, p2))
    v2 = _mul_mod64(_sub_mod64_lazy(m2, partial, p2), pow((p0 * p1) % p2, p2 - 2, p2), p2)
    sign = geq64(v2, const64_like(p2 // 2 + 1))
    mask64 = (1 << 64) - 1
    pos = add64(v0, add64(mullo64(v1, const64_like(p0)),
                          mullo64(v2, const64_like((p0 * p1) & mask64))))
    neg = sub64(pos, const64_like((p0 * p1 * p2) & mask64))
    return select64(sign, neg, pos)
