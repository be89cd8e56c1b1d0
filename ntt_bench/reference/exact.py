"""Exact negacyclic convolution of small signed integer polynomials, plain torch.

The benchmark's yardstick for every product the port computes. It shares no
code, table or prime with the port: two 31-bit primes that are not the port's
(15·2^27 + 1 and 27·2^26 + 1, each a 2n-th root of unity for n up to 2^25),
a textbook radix-2 transform (Gentleman-Sande forward, natural order in,
bit-reversed out; Cooley-Tukey inverse back), the negacyclic twist by a
2n-th root, and Garner's two-prime CRT to a signed int64. Every product of
two residues is below 2^62, so int64 holds it without overflow.

`negacyclic_conv(pairs)` is exact while every output coefficient lies in
(-2^60, 2^60); callers split wide operands into limbs to keep it there.
"""

from __future__ import annotations

from functools import lru_cache

import torch

PRIMES = (2013265921, 1811939329)
BOUND_BITS = 60  # |coefficient| < 2^60 is recovered exactly (p0·p1 > 2^61)


def _root_2n(p: int, n: int) -> int:
    """A primitive 2n-th root of unity mod p (n a power of two)."""
    if (p - 1) % (2 * n):
        raise ValueError(f"no 2n-th root of unity mod {p} for n={n}")
    for g in range(2, p):
        psi = pow(g, (p - 1) // (2 * n), p)
        if pow(psi, n, p) == p - 1:
            return psi
    raise ValueError(f"no primitive 2n-th root mod {p}")


@lru_cache(maxsize=16)
def _host_tables(n: int, p: int):
    """Python-int tables: twist ψ^j, untwist ψ^-j·n^-1, and one twiddle row
    per stage (ω^(j·n/2h), j < h) for each direction."""
    psi = _root_2n(p, n)
    psi_inv = pow(psi, p - 2, p)
    n_inv = pow(n, p - 2, p)
    omega, omega_inv = psi * psi % p, psi_inv * psi_inv % p
    twist = [pow(psi, j, p) for j in range(n)]
    untwist = [pow(psi_inv, j, p) * n_inv % p for j in range(n)]
    fwd, inv = {}, {}
    h = n // 2
    while h >= 1:
        step = n // (2 * h)
        w, wi = pow(omega, step, p), pow(omega_inv, step, p)
        fwd[h] = [pow(w, j, p) for j in range(h)]
        inv[h] = [pow(wi, j, p) for j in range(h)]
        h //= 2
    return twist, untwist, fwd, inv


class _Tables:
    def __init__(self, n: int, p: int, device):
        twist, untwist, fwd, inv = _host_tables(n, p)
        as_t = lambda v: torch.tensor(v, dtype=torch.int64, device=device)  # noqa: E731
        self.n, self.p = n, p
        self.twist, self.untwist = as_t(twist), as_t(untwist)
        self.fwd = {h: as_t(v) for h, v in fwd.items()}
        self.inv = {h: as_t(v) for h, v in inv.items()}


_DEVICE_TABLES: dict = {}


def tables(n: int, p: int, device) -> _Tables:
    key = (n, p, str(device))
    if key not in _DEVICE_TABLES:
        _DEVICE_TABLES[key] = _Tables(n, p, device)
    return _DEVICE_TABLES[key]


def _mulmod(a: torch.Tensor, b: torch.Tensor, p: int) -> torch.Tensor:
    return (a * b) % p


def ntt(x: torch.Tensor, t: _Tables) -> torch.Tensor:
    """Negacyclic forward transform of int64 residues [..., n] in [0, p):
    twist, then Gentleman-Sande stages; output in bit-reversed order."""
    p, n = t.p, t.n
    lead = x.shape[:-1]
    x = _mulmod(x, t.twist, p).reshape(-1, n)
    rows = x.shape[0]
    h = n // 2
    while h >= 1:
        x = x.view(rows, n // (2 * h), 2, h)
        u, v = x[:, :, 0], x[:, :, 1]
        s = u + v
        s = torch.where(s >= p, s - p, s)
        d = u - v
        d = torch.where(d < 0, d + p, d)
        x = torch.stack((s, _mulmod(d, t.fwd[h], p)), dim=2).view(rows, n)
        h //= 2
    return x.reshape(*lead, n)


def intt(x: torch.Tensor, t: _Tables) -> torch.Tensor:
    """Inverse of `ntt`, scaled by n^-1: bit-reversed in, natural order out."""
    p, n = t.p, t.n
    lead = x.shape[:-1]
    x = x.reshape(-1, n)
    rows = x.shape[0]
    h = 1
    while h < n:
        x = x.view(rows, n // (2 * h), 2, h)
        u, v = x[:, :, 0], _mulmod(x[:, :, 1], t.inv[h], p)
        s = u + v
        s = torch.where(s >= p, s - p, s)
        d = u - v
        d = torch.where(d < 0, d + p, d)
        x = torch.stack((s, d), dim=2).view(rows, n)
        h *= 2
    return _mulmod(x, t.untwist, p).reshape(*lead, n)


def crt_signed(r0: torch.Tensor, r1: torch.Tensor) -> torch.Tensor:
    """The signed integer in (-p0·p1/2, p0·p1/2) with residues r0, r1."""
    p0, p1 = PRIMES
    m = p0 * p1
    c = pow(p0, p1 - 2, p1)
    t = _mulmod((r1 - r0) % p1, torch.full_like(r1, c), p1)
    v = r0 + p0 * t
    return torch.where(v > m // 2, v - m, v)


def negacyclic_conv(pairs) -> torch.Tensor:
    """Σ a ⊛ b over `pairs` of int64 polynomials [..., n] (broadcasting),
    mod X^n + 1, as exact int64. Each output coefficient must lie in
    (-2^60, 2^60)."""
    pairs = list(pairs)
    n = pairs[0][0].shape[-1]
    device = pairs[0][0].device
    res = []
    for p in PRIMES:
        t = tables(n, p, device)
        acc = None
        for a, b in pairs:
            prod = _mulmod(ntt(a % p, t), ntt(b % p, t), p)
            acc = prod if acc is None else (acc + prod) % p
        res.append(intt(acc, t))
    return crt_signed(*res)


def u32_to_i64(x: torch.Tensor) -> torch.Tensor:
    """uint32 tensor → int64 with the same value."""
    return x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
