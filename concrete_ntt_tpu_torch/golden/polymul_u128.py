"""The wrapping negacyclic product mod (X^n + 1, 2^128), exact, in plain torch.

The definition of `golden/polymul.py::negacyclic_convolution_wrapping(…,
128)` (the reference's oracle with p = 0: wrapping u128 arithmetic,
native128.rs:359-…), c[k] = Σ_{i<=k} a[i]·b[k-i] - Σ_{i>k} a[i]·b[n+k-i]
mod 2^128, computed on whole batches of planar u128 polynomials with torch
integer operations only; it imports nothing of the port, for the tests that
hold `native128.Plan32` to it. The departure from the bigint oracle is the
arithmetic, not the result: each operand is split into eight 16-bit limbs;
for each weight 2^(16·s), s < 8, the limb products a_k ⊛ b_l with k + l = s
(the 36 of weight below 2^128) are summed as a schoolbook in int64, exact
while 8·n·(2^16 - 1)^2 < 2^63 (n < 2^28); the eight sums are carried into
16-bit result limbs and the carry out of the top limb is dropped (mod
2^128). The schoolbook is a matrix product with the negacyclic matrix of
each b limb, so it holds n·n int64 entries a polynomial: for the CPU tests'
sizes, not a card's.
"""

from __future__ import annotations

import torch

LIMBS16 = 8


def _to_i64(x: torch.Tensor) -> torch.Tensor:
    """uint32 tensor → int64 with the same value."""
    return x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _limbs16(parts) -> torch.Tensor:
    """Planar u128 (four uint32 [..., n], little-endian) → int64 16-bit
    limbs [..., 8, n]."""
    words = [_to_i64(p) for p in parts]
    return torch.stack([(w >> (16 * h)) & 0xFFFF for w in words for h in (0, 1)], dim=-2)


def _negacyclic_matrix(b: torch.Tensor) -> torch.Tensor:
    """[..., n] → [..., n, n] with a ⊛ b = a @ M: M[i, j] = b[j - i] for
    j >= i, -b[n + j - i] below the diagonal (X^n = -1)."""
    n = b.shape[-1]
    i = torch.arange(n, device=b.device)
    diff = i[None, :] - i[:, None]
    sign = torch.where(diff >= 0, 1, -1).to(torch.int64)
    return b[..., diff % n] * sign


def negacyclic_polymul_u128(lhs, rhs) -> tuple:
    """Planar u128 polynomials (four uint32 tensors [..., n] each side, low
    word first) → their wrapping negacyclic product, four uint32 [..., n]."""
    if len(lhs) != 4 or len(rhs) != 4:
        raise ValueError("expected four uint32 limb planes a side")
    a, b = _limbs16(lhs), _limbs16(rhs)  # [..., 8, n]
    n = a.shape[-1]
    if LIMBS16 * n * 0xFFFF ** 2 >= 1 << 63:
        raise ValueError(f"n={n} is too large for the int64 schoolbook")
    sums = torch.zeros_like(a)  # [..., s, n]: Σ_{k+l=s} a_k ⊛ b_l
    for k in range(LIMBS16):  # b_k times every a limb of weight below 2^128
        m = _negacyclic_matrix(b[..., k, :])
        sums[..., k:, :] += torch.matmul(a[..., :LIMBS16 - k, :], m)
    out, carry = [], torch.zeros_like(sums[..., 0, :])
    for s in range(LIMBS16):
        v = sums[..., s, :] + carry
        out.append(v & 0xFFFF)
        carry = v >> 16  # arithmetic shift: floor division, right for negative sums
    return tuple((out[2 * j] | (out[2 * j + 1] << 16)).to(torch.uint32) for j in range(4))
