"""u32-limb modular arithmetic primitives, in plain torch.

Counterpart of `concrete_ntt_tpu/ops/u32.py`. Only the helpers the ported
paths reach come across: the 32-bit half, the 64-bit limb helpers of
`rec_u64_from5` and of the product plan's u32-channel path (`mul64_u32`,
`add64c`, `sub64b`, `add_mod64`, `sub_mod64`), and the numpy limb
converters. `mont_mul64` and the rest of the 64-bit half wait for the
prime64 slice.

Carrier convention: torch has no `+`, `>>` or `<` for `uint32` on the CPU,
so every function here takes and returns u32 values held in `int64`
tensors, masked to [0, 2^32) after each wrapping op. Products of two u32
values are formed from 16-bit halves (as in the JAX package), so no `int64`
product ever passes 2^63. Scalars may be Python ints. `to_i64` / `to_u32`
convert at the boundary to and from `uint32` tensors.

Value representations:
  * u32 fields: int64 tensors holding [0, 2^32).
  * u64 values: little-endian limb pairs `(lo, hi)` of such tensors.
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_MASK16 = 0xFFFF


def to_i64(x: torch.Tensor) -> torch.Tensor:
    """uint32 tensor → int64 carrier (same device)."""
    if x.dtype != torch.uint32:
        raise TypeError(f"expected a uint32 tensor, got {x.dtype}")
    return x.view(torch.int32).to(torch.int64) & MASK32


def to_u32(x: torch.Tensor) -> torch.Tensor:
    """int64 carrier holding [0, 2^32) → uint32 tensor (same device)."""
    signed = torch.where(x >= (1 << 31), x - (1 << 32), x)
    return signed.to(torch.int32).view(torch.uint32)


# ---------------------------------------------------------------------------
# Wide 32x32 products via 16-bit splits
# ---------------------------------------------------------------------------


def mulhi_u32(a, b):
    """High 32 bits of the 64-bit product a*b."""
    a_lo = a & _MASK16
    a_hi = a >> 16
    b_lo = b & _MASK16
    b_hi = b >> 16
    ll = a_lo * b_lo
    lh = a_lo * b_hi
    hl = a_hi * b_lo
    hh = a_hi * b_hi
    mid = (ll >> 16) + (lh & _MASK16) + (hl & _MASK16)
    return (hh + (lh >> 16) + (hl >> 16) + (mid >> 16)) & MASK32


def mulwide_u32(a, b):
    """Full 64-bit product of u32 operands as a (lo, hi) limb pair."""
    a_lo = a & _MASK16
    a_hi = a >> 16
    b_lo = b & _MASK16
    b_hi = b >> 16
    ll = a_lo * b_lo
    lh = a_lo * b_hi
    hl = a_hi * b_lo
    hh = a_hi * b_hi
    mid = (ll >> 16) + (lh & _MASK16) + (hl & _MASK16)
    lo = ((ll & _MASK16) | (mid << 16)) & MASK32
    hi = (hh + (lh >> 16) + (hl >> 16) + (mid >> 16)) & MASK32
    return lo, hi


def mullo_u32(a, b):
    """Low 32 bits of a*b (the JAX package's wrapping u32 `*`)."""
    return (a * (b & _MASK16) + (((a * (b >> 16)) & _MASK16) << 16)) & MASK32


def cond_sub(x, m):
    """x - m if x >= m else x (single lazy-reduction step)."""
    return torch.where(x >= m, x - m, x)


def add_mod(a, b, p):
    """(a + b) mod p for a, b in [0, p), any p < 2^32."""
    s = a + b  # exact in int64: the u32 overflow case is s >= 2^32
    return torch.where(s >= p, s - p, s) & MASK32


def sub_mod(a, b, p):
    """(a - b) mod p for a, b in [0, p)."""
    d = a - b
    return torch.where(d < 0, d + p, d) & MASK32


# ---------------------------------------------------------------------------
# Shoup multiplication (one constant operand)
# ---------------------------------------------------------------------------


def shoup_mul_lazy(z, w, w_shoup, p):
    """t ≡ z*w (mod p) with t in [0, 2p), for any z < 2^32, w < p < 2^31:
    t = z*w - ⌊z*w_shoup / 2^32⌋*p, wrapping mod 2^32."""
    q = mulhi_u32(z, w_shoup)
    return (mullo_u32(z, w) - mullo_u32(q, p)) & MASK32


def shoup_mul(z, w, w_shoup, p):
    """z*w mod p, canonical [0, p)."""
    return cond_sub(shoup_mul_lazy(z, w, w_shoup, p), p)


# ---------------------------------------------------------------------------
# Montgomery multiplication (both operands variable)
# ---------------------------------------------------------------------------


def mont_neginv(p: int) -> int:
    """-p^{-1} mod 2^32 (host-side plan constant; p odd)."""
    inv = pow(p, -1, 1 << 32)
    return (-inv) % (1 << 32)


def mont_mul(a, b, p, p_neginv):
    """a*b*2^{-32} mod p, canonical [0, p), for any odd p < 2^32 (REDC)."""
    lo, hi = mulwide_u32(a, b)
    m = mullo_u32(lo, p_neginv)
    mp_hi = mulhi_u32(m, p)
    carry = (lo != 0).to(torch.int64)  # lo(ab)+lo(mp) is 0 or exactly 2^32
    s = hi + mp_hi + carry  # exact in int64: true r ∈ [0, 2p)
    return torch.where(s >= p, s - p, s) & MASK32


def reduce_u32_mod(x, p: int, m_barrett: int):
    """x mod p for any x < 2^32, p < 2^30, with m_barrett = ⌊2^32/p⌋ (host const).

    q = ⌊x·m/2^32⌋ underestimates x/p by at most 2 → two conditional subtracts.
    """
    q = mulhi_u32(x, m_barrett)
    r = (x - mullo_u32(q, p)) & MASK32
    r = cond_sub(r, 2 * p)
    return cond_sub(r, p)


# ---------------------------------------------------------------------------
# u64 limb-pair arithmetic
# ---------------------------------------------------------------------------


def add64(a, b):
    """Wrapping 64-bit add of limb pairs."""
    lo = a[0] + b[0]
    return lo & MASK32, (a[1] + b[1] + (lo >> 32)) & MASK32


def sub64(a, b):
    """Wrapping 64-bit subtract of limb pairs."""
    lo = a[0] - b[0]
    borrow = (lo < 0).to(torch.int64)
    return lo & MASK32, (a[1] - b[1] - borrow) & MASK32


def geq64(a, b):
    """a >= b for limb pairs."""
    return (a[1] > b[1]) | ((a[1] == b[1]) & (a[0] >= b[0]))


def select64(c, a, b):
    return torch.where(c, a[0], b[0]), torch.where(c, a[1], b[1])


def cond_sub64(x, m):
    """x - m if x >= m else x, for limb pairs (m may be a python int)."""
    m = const64_like(m) if isinstance(m, int) else m
    return select64(geq64(x, m), sub64(x, m), x)


def const64_like(v: int, ref=None):
    """Broadcastable (lo, hi) pair of Python ints from a python int."""
    del ref  # scalars broadcast against any shape
    return v & MASK32, (v >> 32) & MASK32


def mullo64(a, b):
    """Low 64 bits of the product of two u64 limb pairs."""
    lo, hi = mulwide_u32(a[0], b[0])
    return lo, (hi + mullo_u32(a[0], b[1]) + mullo_u32(a[1], b[0])) & MASK32


def mulwide64(a, b):
    """Full 128-bit product of two u64 limb pairs → 4 u32 limbs."""
    p0_lo, p0_hi = mulwide_u32(a[0], b[0])
    p1_lo, p1_hi = mulwide_u32(a[0], b[1])
    p2_lo, p2_hi = mulwide_u32(a[1], b[0])
    p3_lo, p3_hi = mulwide_u32(a[1], b[1])
    # column sums are exact in int64 (each term < 2^32)
    s1 = p0_hi + p1_lo + p2_lo
    s2 = p1_hi + p2_hi + p3_lo + (s1 >> 32)
    l3 = (p3_hi + (s2 >> 32)) & MASK32
    return p0_lo, s1 & MASK32, s2 & MASK32, l3


def mulhi64(a, b):
    """High 64 bits of the 128-bit product, as a limb pair."""
    _, _, l2, l3 = mulwide64(a, b)
    return l2, l3


def shoup_mul_lazy64(z, w, w_shoup, p: int):
    """t ≡ z·w (mod p), t in [0, 2p), for z < 2^64, w < p < 2^63 (limb pairs)."""
    q = mulhi64(z, w_shoup)
    return sub64(mullo64(z, w), mullo64(q, const64_like(p)))


def mul64_u32(a, b32):
    """Low 64 bits of (u64 limb pair a) * (u32 b32)."""
    lo, hi = mulwide_u32(a[0], b32)
    return lo, (hi + mullo_u32(a[1], b32)) & MASK32


def add64c(a, b):
    """Wrapping 64-bit add returning (sum pair, carry out as 0/1)."""
    lo = a[0] + b[0]
    hi = a[1] + b[1] + (lo >> 32)  # exact in int64: < 2^33
    return (lo & MASK32, hi & MASK32), hi >> 32


def sub64b(a, b):
    """Wrapping 64-bit subtract returning (difference pair, borrow out as bool)."""
    return sub64(a, b), ~geq64(a, b)


def add_mod64(a, b, p: int):
    """(a + b) mod p for limb pairs in [0, p), any p < 2^64."""
    s, carry = add64c(a, b)
    # on a carry the true sum s + 2^64 lies in [2^64, 2p): subtract p once
    # as the wrapping add of 2^64 - p; otherwise one conditional subtract
    return select64(carry != 0, add64(s, const64_like((1 << 64) - p)), cond_sub64(s, p))


def sub_mod64(a, b, p: int):
    """(a - b) mod p for limb pairs in [0, p)."""
    d, borrow = sub64b(a, b)
    return select64(borrow, add64(d, const64_like(p)), d)


# ---------------------------------------------------------------------------
# Host conversion helpers (numpy)
# ---------------------------------------------------------------------------


def np_u64_to_limbs(x):
    """NumPy uint64 array → stacked (..., 2) uint32 little-endian limbs."""
    x = np.asarray(x, dtype=np.uint64)
    return np.stack(
        [(x & np.uint64(0xFFFFFFFF)).astype(np.uint32), (x >> np.uint64(32)).astype(np.uint32)],
        axis=-1,
    )


def limbs_to_np_u64(limbs):
    """(..., 2) uint32 limb array → NumPy uint64."""
    limbs = np.asarray(limbs)
    return limbs[..., 0].astype(np.uint64) | (limbs[..., 1].astype(np.uint64) << np.uint64(32))


def np_u128_to_limbs(values):
    """Iterable of python ints (< 2^128) → (..., 4) uint32 limbs."""
    vals = list(values)
    out = np.zeros((len(vals), 4), dtype=np.uint32)
    for i, v in enumerate(vals):
        v = int(v)
        for k in range(4):
            out[i, k] = (v >> (32 * k)) & 0xFFFFFFFF
    return out


def limbs_to_py_u128(limbs):
    """(..., 4) uint32 limbs → list of python ints."""
    flat = np.asarray(limbs, dtype=np.uint32).reshape(-1, 4)
    return [
        int(r[0]) | (int(r[1]) << 32) | (int(r[2]) << 64) | (int(r[3]) << 96)
        for r in flat
    ]
