"""Routing of the prime32 CRT-channel transforms.

Counterpart of the channel-grid routes of `concrete_ntt_tpu/ops/ntt_dispatch.py`
(`try_fwd32_wide_all` :125, `try_inv32_all` :219, `try_polymul32_stacked`
:248-305). The JAX package routes on the backend and environment knobs;
here the route is the device of the operand, inside ops/mxu32_cuda.py: a
CUDA tensor launches K1a / K1b, a CPU tensor runs their plain torch twins.
There is no knob and no hybrid or presplit branch (both are off in the
reference's 'auto'). Where the JAX functions return None for "not
applicable", these raise NotImplementedError naming the ROADMAP item, and
they return the stacked [C, B, n] tensor rather than a list of channels.
"""

from __future__ import annotations

from . import mxu32_cuda
from .u32 import MASK32, mulhi_u32, mullo_u32, mulwide_u32, to_i64, to_u32


def _primes(plans) -> tuple:
    return tuple(pl.p for pl in plans)


def try_fwd32_wide_all(parts, plans):
    """Fused residue split + forward NTT for a CRT plan's prime32 channels:
    little-endian uint32 limb tuple of [B, n] → [C, B, n] NTT-domain
    residues. The per-coefficient `% p` split (native64.rs:980-993) is folded
    into K1a's column matmul as extra operand digit planes."""
    return mxu32_cuda.fwd_wide_multi(tuple(parts), _primes(plans))


def try_inv32_all(stacked, plans, scales=None):
    """Unnormalized (unless scaled) inverse NTTs of all channels:
    [C, B, n] uint32, any u32 representatives → standard-order canonical."""
    if scales is None:
        scales = (1,) * len(plans)
    return mxu32_cuda.inv_multi(stacked, _primes(plans), tuple(scales))


def try_polymul32_stacked(parts_l, parts_r, plans, rhs_binary=False):
    """End-to-end stacked negacyclic polymul over plan32 CRT channels: K1a on
    both operands, the pointwise Montgomery product per channel (plain
    torch, as the reference's XLA elementwise stage), then K1b with
    n^-1 * 2^32 folded into the inverse column matrix. Returns
    standard-order residues [C, B, n] (uint32)."""
    primes = _primes(plans)
    n = parts_l[0].shape[-1]
    fl = mxu32_cuda.fwd_wide_multi(tuple(parts_l), primes)
    fr = mxu32_cuda.fwd_wide_multi(
        tuple(parts_r[:1]) if rhs_binary else tuple(parts_r), primes
    )
    c = len(primes)
    a, b = to_i64(fl), to_i64(fr)
    pv = a.new_tensor(primes).reshape(c, 1, 1)
    nv = a.new_tensor([pl.p_neginv for pl in plans]).reshape(c, 1, 1)
    # Montgomery product a*b*2^-32 mod p (any-u32 representative out).
    lo, hi = mulwide_u32(a, b)
    m = mullo_u32(lo, nv)
    # REDC carry: lo(a·b) + lo(m·p) is 0 or exactly 2^32 (m·p ≡ -lo mod 2^32),
    # so the carry is just (lo != 0). Its premise: canonical fwd outputs.
    t = (hi + mulhi_u32(m, pv) + (lo != 0).to(lo.dtype)) & MASK32
    scales = tuple(
        pow(n, pl.p - 2, pl.p) * pow(2, 32, pl.p) % pl.p for pl in plans
    )
    return mxu32_cuda.inv_multi(to_u32(t), primes, scales)
