"""Prime32 butterfly regimes, in plain torch.

Counterpart of `concrete_ntt_tpu/ops/butterflies32.py`: three regimes chosen
by the size of the modulus (reference prime32.rs:713-755):

  * p < 2^30  — Harvey lazy reduction in [0, 4p)   (less_than_30bit.rs)
  * p < 2^31  — lazy reduction in [0, 2p)          (less_than_31bit.rs)
  * p >= 2^31 — canonical [0, p) every stage with Montgomery-form twiddles
    (the JAX package's replacement of the reference's Lemire engine)

Every butterfly takes and returns 1-tuples (engine convention, ops/engine.py)
of u32 values held in int64 carriers (ops/u32.py). Where the JAX code relies
on u32 wraparound (`x0 - t + 2p`, the sum whose overflow the generic regime
tests with `y0 < x0`), the carrier masks to 32 bits at the same point, so
the results are bit-for-bit those of the JAX butterflies on any u32 input,
not only on values inside the regime's bounds.
"""

from __future__ import annotations

import torch

from .u32 import MASK32, cond_sub, mont_mul, shoup_mul_lazy


def make_fwd_lt30(p: int):
    two_p = 2 * p

    def butterfly(z0, z1, w):
        (x0,), (x1,), (wv, ws) = z0, z1, w
        x0 = cond_sub(x0, two_p)  # [0,4p) -> [0,2p)
        t = shoup_mul_lazy(x1, wv, ws, p)  # [0,2p)
        return ((x0 + t) & MASK32,), ((x0 - t + two_p) & MASK32,)  # both [0,4p)

    def last_butterfly(z0, z1, w):
        (x0,), (x1,), (wv, ws) = z0, z1, w
        x0 = cond_sub(cond_sub(x0, two_p), p)  # [0,p)
        t = cond_sub(shoup_mul_lazy(x1, wv, ws, p), p)  # [0,p)
        y0 = cond_sub((x0 + t) & MASK32, p)
        y1 = cond_sub((x0 - t + p) & MASK32, p)
        return (y0,), (y1,)

    return butterfly, last_butterfly


def make_inv_lt30(p: int):
    two_p = 2 * p

    def butterfly(z0, z1, w):
        # y0 = (z0+z1) reduced to [0,2p); y1 = (z0-z1+2p)·w via Shoup, [0,2p)
        (x0,), (x1,), (wv, ws) = z0, z1, w
        y0 = cond_sub((x0 + x1) & MASK32, two_p)
        t = (x0 - x1 + two_p) & MASK32  # [0,4p)
        return (y0,), (shoup_mul_lazy(t, wv, ws, p),)

    def last_butterfly(z0, z1, w):
        (y0,), (y1,) = butterfly(z0, z1, w)
        return (cond_sub(y0, p),), (cond_sub(y1, p),)

    return butterfly, last_butterfly


def make_fwd_lt31(p: int):
    """[0,2p)-invariant variant for 2^30 <= p < 2^31 (less_than_31bit.rs)."""

    def butterfly(z0, z1, w):
        (x0,), (x1,), (wv, ws) = z0, z1, w
        x0 = cond_sub(x0, p)  # [0,2p) -> [0,p)
        t = cond_sub(shoup_mul_lazy(x1, wv, ws, p), p)  # [0,p)
        return ((x0 + t) & MASK32,), ((x0 - t + p) & MASK32,)  # both [0,2p)

    def last_butterfly(z0, z1, w):
        (y0,), (y1,) = butterfly(z0, z1, w)
        return (cond_sub(y0, p),), (cond_sub(y1, p),)

    return butterfly, last_butterfly


def make_inv_lt31(p: int):
    def butterfly(z0, z1, w):
        # y0 = cond_sub(z0+z1), y1 = (z0-z1+p)·w canonical
        (x0,), (x1,), (wv, ws) = z0, z1, w
        y0 = cond_sub((x0 + x1) & MASK32, p)
        t = (x0 - x1 + p) & MASK32  # [0,2p)
        return (y0,), (cond_sub(shoup_mul_lazy(t, wv, ws, p), p),)

    return butterfly, butterfly  # already canonical per stage


def make_fwd_generic32(p: int, p_neginv: int):
    """p >= 2^31: twiddles stored as w·2^32 mod p, so mont_mul(z1, w_mont)
    = z1·w mod p; canonical [0,p) every stage."""

    def butterfly(z0, z1, w):
        (x0,), (x1,), (wm,) = z0, z1, w
        t = mont_mul(x1, wm, p, p_neginv)
        s = x0 + t  # exact; the u32 sum overflowed iff s >= 2^32
        y0 = torch.where(s > MASK32, s - p, cond_sub(s, p)) & MASK32
        y1 = torch.where(x0 >= t, x0 - t, x0 - t + p) & MASK32
        return (y0,), (y1,)

    return butterfly, butterfly


def make_inv_generic32(p: int, p_neginv: int):
    def butterfly(z0, z1, w):
        (x0,), (x1,), (wm,) = z0, z1, w
        s = x0 + x1
        y0 = torch.where(s > MASK32, s - p, cond_sub(s, p)) & MASK32
        d = torch.where(x0 >= x1, x0 - x1, x0 - x1 + p) & MASK32
        return (y0,), (mont_mul(d, wm, p, p_neginv),)

    return butterfly, butterfly


def make(p: int, variant: str, p_neginv: int, direction: str):
    """(butterfly, last_butterfly) of one regime and direction."""
    if direction == "fwd":
        if variant == "lt30":
            return make_fwd_lt30(p)
        if variant == "lt31":
            return make_fwd_lt31(p)
        return make_fwd_generic32(p, p_neginv)
    if variant == "lt30":
        return make_inv_lt30(p)
    if variant == "lt31":
        return make_inv_lt31(p)
    return make_inv_generic32(p, p_neginv)
