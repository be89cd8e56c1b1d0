"""The control: the reference's products computed in float64 instead of exact
integers, as an FFT backend would (tfhe-rs's own external product runs on a
float64 FFT). Operands are rounded to float64, multiplied through a twisted
complex FFT and rounded back, so every result is close to the exact one and
wrong in its low bits. `correct` has to come out false when this stands in
for the port; `ntt_bench/control.py` and `tests/test_control.py` show that it
does.
"""

from __future__ import annotations

import math

import torch

from . import products


def negacyclic_conv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The float64 negacyclic product of float64 [..., n] tensors,
    rounded to whole numbers."""
    n = a.shape[-1]
    j = torch.arange(n, dtype=torch.float64, device=a.device)
    twist = torch.polar(torch.ones_like(j), j * (math.pi / n))
    fa = torch.fft.fft(a.to(torch.complex128) * twist)
    fb = torch.fft.fft(b.to(torch.complex128) * twist)
    return torch.round((torch.fft.ifft(fa * fb) * twist.conj()).real)


def polymul_u64(a_lo, a_hi, b_lo, b_hi) -> tuple:
    """(lo, hi) int64 limbs of the product mod 2^64, through float64."""
    a = a_lo.to(torch.float64) + a_hi.to(torch.float64) * 2.0 ** 32
    b = b_lo.to(torch.float64) + b_hi.to(torch.float64) * 2.0 ** 32
    v = torch.remainder(negacyclic_conv(a, b), 2.0 ** 64)
    hi = torch.clamp(torch.floor(v / 2.0 ** 32), 0, 2.0 ** 32 - 1)
    lo = torch.clamp(v - hi * 2.0 ** 32, 0, 2.0 ** 32 - 1)
    return lo.to(torch.int64), hi.to(torch.int64)


def external_product(acc, digits, key) -> tuple:
    """acc + Σ_i d_i ⊛ K_ij mod P with the products in float64 (shapes as
    one term of `products.external_product`): the key's values rounded to
    float64, the sums taken mod 2^64 in float64 and folded into P."""
    d = digits.to(torch.float64)
    k = (key[0].to(torch.float64) + key[1].to(torch.float64) * 2.0 ** 32).view(key[0].shape[0], 2, 2, -1)
    s = negacyclic_conv(d[:, 0, None], k[:, 0]) + negacyclic_conv(d[:, 1, None], k[:, 1])
    v = torch.remainder(s, 2.0 ** 64)
    hi = torch.clamp(torch.floor(v / 2.0 ** 32), 0, 2.0 ** 32 - 1)
    lo = torch.clamp(v - hi * 2.0 ** 32, 0, 2.0 ** 32 - 1)
    return products.canon_gl(acc[0] + lo.to(torch.int64), acc[1] + hi.to(torch.int64))
