"""u32-limb modular arithmetic primitives, in plain torch.

Counterpart of `concrete_ntt_tpu/ops/u32.py`: the 32-bit half, the 64-bit
limb-pair half (Shoup, Montgomery and Goldilocks multiplies of the prime64
plan and of the 64-bit four-step engine), the generic N-limb helpers of the
u128 lifts, and the numpy limb converters.

Carrier convention: torch has no `+`, `>>` or `<` for `uint32` on the CPU,
so every function here takes and returns u32 values held in `int64`
tensors, masked to [0, 2^32) after each wrapping op. Products of two u32
values are formed from 16-bit halves (as in the JAX package), so no `int64`
product ever passes 2^63. Scalars may be Python ints. `to_i64` / `to_u32`
convert at the boundary to and from `uint32` tensors.

Value representations:
  * u32 fields: int64 tensors holding [0, 2^32).
  * u64 values: little-endian limb pairs `(lo, hi)` of such tensors.
  * u128 values: little-endian tuples of four such tensors.
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_MASK16 = 0xFFFF


DEFAULT_DEVICE = "cuda"  # every plan computes on the card unless told otherwise


def check_device(device) -> torch.device:
    """`device` as a torch.device; raises where it is the card and there is
    none, so that no plan carries on on the CPU by itself."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"the plan's device is {device!r} but torch.cuda.is_available() is False; "
            'construct the plan with device="cpu" to compute on the CPU'
        )
    return dev


def input_tensor(x, device) -> torch.Tensor:
    """A plan's input as a tensor: a numpy array (the host-convenience
    format) is moved to the plan's `device`; a tensor computes on the device
    it is on."""
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x)).to(check_device(device))
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"expected a tensor or a numpy array, got {type(x).__name__}")
    return x


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


def mont_neginv64(p: int) -> int:
    """-p^{-1} mod 2^64 (host-side; p odd)."""
    return (-pow(p, -1, 1 << 64)) % (1 << 64)


def mont_mul64(a, b, p, p_neginv):
    """a·b·2^{-64} mod p for odd p < 2^64 (REDC), limb pairs.

    With a·b < 2^64·p (one operand < p) REDC's t = (a·b + m·p)/2^64 < 2p and
    the result is canonical. For two arbitrary u64 operands t can pass 2^64:
    on that overflow the wrapped sum gets 2^64 - p added (t - p), else one
    conditional subtract, and the result may land in [p, 2p) — the JAX
    package's bit pattern, which the channel-grid kernel K7d reproduces.
    `p` and `p_neginv` are Python ints."""
    l0, l1, l2, l3 = mulwide64(a, b)
    m = mullo64((l0, l1), const64_like(p_neginv))
    mp_hi = mulhi64(m, const64_like(p))
    # low 64 bits of T + m·p are zero; carry out iff T_lo != 0
    carry = ((l0 != 0) | (l1 != 0)).to(torch.int64)
    s, c1 = add64c((l2, l3), mp_hi)
    s2, c2 = add64c(s, (carry, 0))
    over = (c1 | c2) != 0
    return select64(over, add64(s2, const64_like((1 << 64) - p)), cond_sub64(s2, p))


def shoup_mul_u32_lazy64(z32, w, w_shoup, p: int):
    """t ≡ z·w (mod p), t in [0, 2p), for a u32 operand z against a u64
    constant w < p < 2^63 with companion w_shoup = ⌊w·2^64/p⌋ (limb pairs of
    tensors or Python ints). z < 2^32 makes the quotient
    q = ⌊z·w_shoup/2^64⌋ a single u32: the top limb of the 96-bit product."""
    w_lo, w_hi = w
    wsh_lo, wsh_hi = w_shoup
    lo1, hi1 = mulwide_u32(z32, wsh_hi)
    q = (hi1 + ((lo1 + mulhi_u32(z32, wsh_lo)) >> 32)) & MASK32
    return sub64(mul64_u32((w_lo, w_hi), z32), mul64_u32(const64_like(p), q))


# ---------------------------------------------------------------------------
# Generic N-limb arithmetic (u128 and mixed-width products; wrapping)
# ---------------------------------------------------------------------------


def add_limbs(a: tuple, b: tuple) -> tuple:
    """Wrapping multi-limb add (lengths must match; final carry dropped)."""
    assert len(a) == len(b)
    out = []
    carry = 0
    for x, y in zip(a, b):
        s = x + y + carry  # exact in int64: < 2^33
        out.append(s & MASK32)
        carry = s >> 32
    return tuple(out)


def sub_limbs(a: tuple, b: tuple) -> tuple:
    """Wrapping multi-limb subtract."""
    assert len(a) == len(b)
    out = []
    borrow = 0
    for x, y in zip(a, b):
        d = x - y - borrow  # exact in int64: > -2^33
        out.append(d & MASK32)
        borrow = (d < 0).to(torch.int64)
    return tuple(out)


def mullo_limbs(a: tuple, b: tuple, out_len: int) -> tuple:
    """Low `out_len` limbs of the product of limb tuples a and b (wrapping).

    Schoolbook by columns: limb k sums the low halves of the partial
    products a[i]·b[j] with i + j == k, the high halves of those with
    i + j == k - 1 and the carry of limb k - 1 (exact in int64: a dozen
    terms below 2^32). The limbs of b may be Python ints (`const_limbs`); a
    zero constant limb contributes nothing and is skipped."""
    cols = [[] for _ in range(out_len)]
    for i, x in enumerate(a[:out_len]):
        for j, y in enumerate(b[: out_len - i]):
            if isinstance(y, int) and y == 0:
                continue
            lo, hi = mulwide_u32(x, y)
            cols[i + j].append(lo)
            if i + j + 1 < out_len:
                cols[i + j + 1].append(hi)
    out = []
    carry = torch.zeros_like(a[0])
    for terms in cols:
        s = carry
        for t in terms:
            s = s + t
        out.append(s & MASK32)
        carry = s >> 32
    return tuple(out)


def select_limbs(c, a: tuple, b: tuple) -> tuple:
    """Per-limb where(c, a, b)."""
    return tuple(torch.where(c, x, y) for x, y in zip(a, b))


def const_limbs(v: int, length: int) -> tuple:
    """`length` little-endian u32 limbs of a Python int, as Python ints."""
    return tuple((v >> (32 * k)) & MASK32 for k in range(length))


# ---------------------------------------------------------------------------
# Goldilocks prime p = 2^64 - 2^32 + 1 (reference: prime64::Solinas,
# generic_solinas.rs:103-128). With φ = 2^32: 2^64 ≡ φ-1, 2^96 ≡ -1, so a
# 128-bit product (l0, l1, l2, l3) reduces with shifts and adds only.
# ---------------------------------------------------------------------------

GOLDILOCKS_P = (1 << 64) - (1 << 32) + 1


def gl_reduce128_lazy(l0, l1, l2, l3):
    """4-limb value mod Goldilocks as a u64 representative (< 2^64, possibly
    >= p: one cond_sub64 from canonical)."""
    # t0 = (l0, l1) - l3: on a borrow the wrapped value is 2^64 too large,
    # and 2^64 ≡ φ-1, so subtract φ-1
    t0, b1 = sub64b((l0, l1), (l3, 0))
    t0 = select64(b1, sub64(t0, (MASK32, 0)), t0)
    # t1 = l2·(φ-1) = (l2 << 32) - l2, exact in 64 bits
    t1 = sub64((0, l2), (l2, 0))
    t2, c2 = add64c(t0, t1)
    return select64(c2 != 0, add64(t2, (MASK32, 0)), t2)


def gl_reduce128(l0, l1, l2, l3):
    """4-limb value mod Goldilocks, canonical [0, p)."""
    return cond_sub64(gl_reduce128_lazy(l0, l1, l2, l3), GOLDILOCKS_P)


def gl_mul_lazy(a, b):
    """a·b mod Goldilocks as a u64 representative (4 wide multiplies)."""
    return gl_reduce128_lazy(*mulwide64(a, b))


def gl_mul(a, b):
    """a·b mod Goldilocks, canonical, for any u64 limb pairs a, b."""
    return gl_reduce128(*mulwide64(a, b))


def gl_add(a, b):
    """(a + b) mod Goldilocks for a, b in [0, p)."""
    return add_mod64(a, b, GOLDILOCKS_P)


def gl_sub(a, b):
    """(a - b) mod Goldilocks for a, b in [0, p)."""
    return sub_mod64(a, b, GOLDILOCKS_P)


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
