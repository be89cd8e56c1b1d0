"""Garner lifts whose mixed-radix accumulation is an int8 GEMM.

Counterpart of `concrete_ntt_tpu/crt_mxu.py`. A lift has two phases:

  1. digit extraction (the reference's v2 pairing: pair digits and the
     outer Garner, native64.rs:91-141 / native128.rs:20-118): sequential
     modular algebra, here the port's `ops/crt.py` helpers unchanged;
  2. the mixed-radix accumulation  Σ_i digit_i · (Π_{j<i} P_j)  mod 2^w: a
     linear map from the digits' bytes to the result's bytes with constant
     integer coefficients.

Phase 2 is an int8 matrix product: the digits' bytes, each xor 128 (byte -
128 as int8), times the constant [K, 4·out_limbs + 1] int8 matrix of
`_mixed_radix_matrix` (the JAX package's: entry (k, c) is byte c of
256^b · prefix_i mod 2^w, minus 128; the last column is ones and gives Σx),
accumulated in int32. The offsets are repaired per column, t_c = acc_c +
128·Σx + const_c, which is the exact byte column Σ byte·coefficient in
[0, 2^31). Where the JAX package then sweeps the columns a byte at a time,
each limb's four columns here combine as Σ t_c·2^(8(c mod 4)) (< 2^57,
exact in int64) and the carry runs a limb at a time: the same base-2^32
digits. Wrapping mod 2^w drops the last carry.

The product is `torch._int_mm` (int8 x int8 -> int32) on every device: a
library call outside any kernel, as the JAX package leaves this product to
`lax.dot_general`. On the card it takes more than 16 rows and a depth and a
width that are multiples of 8, so `_mixed_radix_operand` pads the matrix
with zero rows and columns (a padded row is zero in the Σx column too, so it
enters no sum), `_mixed_radix_mxu` pads the operand's bytes with zero
columns, and `ops/mxu32.int_mm` pads fewer than 17 rows with zero rows.
The matrix is held column-major, the layout of the int8 GEMM's second
operand.

No route takes these lifts: the plans use `ops/crt.py`. They are
bit-identical to its `rec_u64_from5`, `rec_u128_from5` and
`rec_u128_from10` on every input. The JAX package's module keeps them off by
default on a TPU v5e measurement; `chip_smoke.py`'s `stages` phase gives the
H100's A/B (PERF.md).

Values are u32 fields in int64 carriers (`ops/u32.py`), as in `ops/crt.py`.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from .ops import crt
from .ops.mxu32 import int_mm
from .ops.u32 import (
    MASK32,
    const64_like,
    const_limbs,
    select64,
    select_limbs,
    sub64,
    sub_limbs,
    to_u32,
)

@lru_cache(maxsize=32)
def _mixed_radix_matrix(limb_counts: tuple, prefixes: tuple, out_limbs: int):
    """Constant int8 matrix [K, 4·out_limbs + 1] and int64 correction row.

    Row (i, li, b) maps byte b of limb li of digit i; column c accumulates
    byte c of Σ digit_i · prefix_i mod 2^(32·out_limbs). The extra OUTPUT
    column holds Σx for the offset repair (its matrix entries are +1)."""
    ncol = 4 * out_limbs
    mask = (1 << (32 * out_limbs)) - 1
    rows = []
    for nlimb, pref in zip(limb_counts, prefixes):
        for li in range(nlimb):
            for b in range(4):
                cval = ((pref & mask) << (8 * (4 * li + b))) & mask
                rows.append([(cval >> (8 * c)) & 0xFF for c in range(ncol)])
    m = np.array(rows, dtype=np.int64)  # [K, ncol] raw bytes 0..255
    k = m.shape[0]
    mat = np.concatenate(
        [(m - 128).astype(np.int8), np.ones((k, 1), dtype=np.int8)], axis=1
    )
    # Σ_k (x+128)(c-128+128) = acc + 128·Σx + (128·Σ_k (c_k-128) + K·2^14)
    const_col = (128 * (m - 128).sum(axis=0) + k * 16384).astype(np.int64)
    assert const_col.min() >= 0 and const_col.max() + k * 255 * 255 + 128 * k * 255 < (1 << 31)
    return mat, const_col.astype(np.uint32)


def _pad8(v: int) -> int:
    return -(-v // 8) * 8


@lru_cache(maxsize=32)
def _mixed_radix_operand(limb_counts: tuple, prefixes: tuple, out_limbs: int, device: str):
    """(matrix, const) on `device`: `_mixed_radix_matrix`'s matrix padded
    with zeros to [K8, N8] (multiples of 8), column-major (an [N8, K8]
    tensor seen transposed), and its correction row as int64 [4·out_limbs]."""
    mat, const_col = _mixed_radix_matrix(limb_counts, prefixes, out_limbs)
    k, n = mat.shape
    padded = np.zeros((_pad8(n), _pad8(k)), dtype=np.int8)
    padded[:n, :k] = mat.T
    return (torch.from_numpy(padded).to(device).t(),
            torch.from_numpy(const_col.astype(np.int64)).to(device))


def _mixed_radix_mxu(digits, prefixes, out_limbs: int):
    """Σ digit_i · prefix_i mod 2^(32·out_limbs) by an int8 GEMM.

    digits: list of little-endian u32 limb tuples ([..., n] int64
    carriers); prefixes: python ints. Returns an out_limbs tuple of int64
    carriers."""
    shape = digits[0][0].shape
    mat, const = _mixed_radix_operand(tuple(len(d) for d in digits),
                                      tuple(int(p) for p in prefixes), out_limbs,
                                      str(digits[0][0].device))
    limbs = to_u32(torch.stack([limb for d in digits for limb in d], dim=-1))
    # little-endian bytes: column 4·(limb index) + b is byte b of that limb,
    # the matrix's row order
    x = (limbs.view(torch.uint8) ^ 128).view(torch.int8)
    x = x.reshape(-1, x.shape[-1])
    rows = x.shape[0]
    if mat.shape[0] > x.shape[1]:
        x = F.pad(x, (0, mat.shape[0] - x.shape[1]))
    acc = int_mm(x, mat).to(torch.int64)
    ncol = 4 * out_limbs
    t = (acc[:, :ncol] + (acc[:, ncol:ncol + 1] << 7) + const).reshape(rows, out_limbs, 4)
    v = t[..., 0] + (t[..., 1] << 8) + (t[..., 2] << 16) + (t[..., 3] << 24)
    out, carry = [], 0
    for i in range(out_limbs):
        s = v[:, i] + carry
        out.append((s & MASK32).reshape(shape))
        carry = s >> 32
    return tuple(out)


def rec_u64_from5(mods, primes):
    """Twin of ops.crt.rec_u64_from5 (bit-identical): the crt digits, the
    u64 accumulation as an int8 GEMM."""
    p0, p1, p2, p3, p4 = primes
    v0, v12, v34, sign = crt._pair_digits_from5(mods, primes)
    pref = p0 * p1 * p2
    pos = _mixed_radix_mxu([v0[:1], v12, v34], [1, p0, pref], 2)
    neg = sub64(pos, const64_like((pref * p3 * p4) & ((1 << 64) - 1)))
    return select64(sign, neg, pos)


def rec_u128_from5(mods, primes):
    """Twin of ops.crt.rec_u128_from5 (native_binary128's lift)."""
    p0, p1, p2, p3, p4 = primes
    v0, v12, v34, sign = crt._pair_digits_from5(mods, primes)
    pref = p0 * p1 * p2
    pos = _mixed_radix_mxu([v0[:1], v12, v34], [1, p0, pref], 4)
    neg = sub_limbs(pos, const_limbs((pref * p3 * p4) & ((1 << 128) - 1), 4))
    return select_limbs(sign, neg, pos)


def rec_u128_from10(mods, primes):
    """Twin of ops.crt.rec_u128_from10 (native128's lift, the north-star
    shape): one [K = 40, 16 (+1)] int8 GEMM replaces the four u64 x u128
    `mullo_limbs` accumulation chains."""
    digits, pair_p, sign = crt._pair_digits_from10(mods, primes)
    prefixes = [1]
    for pp in pair_p[:4]:
        prefixes.append(prefixes[-1] * pp)
    pos = _mixed_radix_mxu(digits, prefixes, 4)
    neg = sub_limbs(pos, const_limbs((prefixes[-1] * pair_p[4]) & ((1 << 128) - 1), 4))
    return select_limbs(sign, neg, pos)
