"""The plain reference of each call the benchmark times, exact, in plain torch.

* `polymul_u64`: the wrapping negacyclic product mod (X^n + 1, 2^64) of u64
  polynomials, the guarantee of native64's Plan32. Each operand is split
  into four 16-bit limbs; the limb products of one weight 2^(16·s), s < 4,
  are summed exactly (`exact.negacyclic_conv`, |coefficient| < 4·n·2^32),
  and the four sums are carried into 16-bit result limbs, the carry out of
  the top limb dropped (mod 2^64).
* `external_product`: acc + Σ_i d_i ⊛ K_ij mod (X^n + 1, P), the NTT-PBS
  step of a GLWE accumulator with k = 1 and one decomposition level over
  the prime P = 2^64 - 2^32 + 1, for signed digits |d| <= 2^22 and key
  polynomials in [0, P). The key is split into four 16-bit limbs, each
  Σ_i d_i ⊛ K_ij,l is exact (|coefficient| <= 2·n·2^38), and the limb
  sums are folded mod P with 2^64 ≡ 2^32 - 1 (`canon_gl`). By linearity it
  also takes a sum of many steps at once (a list of terms).

Inputs and outputs are int64 tensors; nothing here reads the port.
"""

from __future__ import annotations

import torch

from . import exact

MASK16 = 0xFFFF
MASK32 = 0xFFFFFFFF
P_GL = (1 << 64) - (1 << 32) + 1


def _limbs16(lo: torch.Tensor, hi: torch.Tensor) -> list:
    return [lo & MASK16, lo >> 16, hi & MASK16, hi >> 16]


def polymul_u64(a_lo, a_hi, b_lo, b_hi) -> tuple:
    """(lo, hi) int64 limbs of the wrapping product of two u64 polynomials
    given as int64 limbs in [0, 2^32), [..., n]."""
    a, b = _limbs16(a_lo, a_hi), _limbs16(b_lo, b_hi)
    n = a_lo.shape[-1]
    if 4 * n * (MASK16 ** 2) >= 1 << exact.BOUND_BITS:
        raise ValueError(f"n={n} is too large for the exact limb product")
    groups = [[] for _ in range(4)]
    for p in exact.PRIMES:
        t = exact.tables(n, p, a_lo.device)
        ah = [exact.ntt(x, t) for x in a]
        bh = [exact.ntt(x, t) for x in b]
        for s in range(4):
            acc = None
            for k in range(s + 1):
                prod = (ah[k] * bh[s - k]) % p
                acc = prod if acc is None else (acc + prod) % p
            groups[s].append(exact.intt(acc, t))
    conv = [exact.crt_signed(*g) for g in groups]
    out, carry = [], torch.zeros_like(conv[0])
    for s in range(4):
        v = conv[s] + carry
        out.append(v & MASK16)
        carry = v >> 16  # arithmetic shift: floor division, right for negative sums
    return out[0] | (out[1] << 16), out[2] | (out[3] << 16)


def canon_gl(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """(lo, hi) int64 halves in [0, 2^32) of a + b·2^32 mod P, the
    canonical residue in [0, P), for int64 a, b with |a|, |b| < 2^62. Each
    pass carries a's high part into b and folds b's high part h back with
    h·2^64 ≡ h·2^32 - h (mod P); |h| falls by 2^32 a pass."""
    for _ in range(8):
        b = b + (a >> 32)
        a = a & MASK32
        h = b >> 32  # floor: right for negative b
        b = (b & MASK32) + h
        a = a - h
        if not bool(((a < 0) | (a > MASK32) | (b < 0) | (b > MASK32)).any()):
            break
    else:
        raise ArithmeticError("the Goldilocks carry did not settle")
    over = (b == MASK32) & (a >= 1)  # a + b·2^32 >= P: subtract P once
    return torch.where(over, a - 1, a), torch.where(over, torch.zeros_like(b), b)


def _term_sums(digits, k_lo, k_hi) -> torch.Tensor:
    """Σ_i d_i ⊛ K_ij,l exact, [B, 2(j), 4(l), n]: the key's 16-bit limbs
    l < 4, |coefficient| <= 2·n·2^22·2^16."""
    n = digits.shape[-1]
    if 2 * n * (1 << 22) * (1 << 16) >= 1 << exact.BOUND_BITS:
        raise ValueError(f"n={n} is too large for the exact limb product")
    key_limbs = torch.stack([k_lo & MASK16, k_lo >> 16, k_hi & MASK16, k_hi >> 16], dim=2)
    sums = []
    for p in exact.PRIMES:
        t = exact.tables(n, p, digits.device)
        dh = exact.ntt(digits % p, t)  # [B, 2(i), n]
        kh = exact.ntt(key_limbs, t).view(k_lo.shape[0], 2, 2, 4, n)  # [., i, j, l, n]
        s = (dh[:, 0, None, None] * kh[:, 0]) % p + (dh[:, 1, None, None] * kh[:, 1]) % p
        sums.append(exact.intt(s % p, t))
    return exact.crt_signed(*sums)


def external_product(acc, terms) -> tuple:
    """acc + Σ over `terms` of Σ_i d_i ⊛ K_ij mod (X^n + 1, P), P = 2^64 -
    2^32 + 1, for a GLWE accumulator with k = 1 and one decomposition level.

    acc: (lo, hi) int64 halves [B, 2, n] of values in [0, P); terms: pairs
    (digits, (k_lo, k_hi)) of signed digits [B, 2, n], |d| <= 2^22, and key
    halves [B or 1, 4, n] of values in [0, P), K_ij at 2i + j. Returns the
    canonical (lo, hi) [B, 2, n]."""
    a, b = acc
    for digits, (k_lo, k_hi) in terms:
        s0, s1, s2, s3 = _term_sums(digits, k_lo, k_hi).unbind(2)
        # s0 + s1·2^16 + s2·2^32 + s3·2^48, with s3's part above 2^64 folded
        a = a + s0 + ((s1 & MASK16) << 16) - (s3 >> 16)
        b = b + (s1 >> 16) + s2 + ((s3 & MASK16) << 16) + (s3 >> 16)
        a, b = canon_gl(a, b)
    return canon_gl(a, b)


def key_sum(counts, k_lo, k_hi) -> tuple:
    """Σ_r counts[r]·K_r mod P as canonical (lo, hi) halves, for key halves
    [R, ...] and small non-negative int64 counts [R]."""
    w = counts.view(-1, *([1] * (k_lo.dim() - 1)))
    return canon_gl((w * k_lo).sum(0), (w * k_hi).sum(0))
