"""Routing of the prime32 and prime64 transforms.

Counterpart of `concrete_ntt_tpu/ops/ntt_dispatch.py`, four parts of it:

  * the single-prime tiers `fwd32` / `inv32` (:502-549) that
    `prime32.Plan.fwd/inv` call: `tier32` picks the four-step kernel K2
    where `mxu32.applicable` holds (odd p >= 2^26, 2^11 <= n <= 2^17), else
    the butterfly kernel K4 up to 2^17 (where the reference's Pallas kernel
    stops at 2^15, its `_fwd_xla` / `_inv_xla` stage engine computes the
    same function), above it the stage engine on the operand's device
    ("stage"). The TPU's two-pass tier, two `pass_matmod` passes
    for 2048 <= n < 2^14 (`passes_engine`, :60-77), is cut there by VMEM
    (`mxu32_pallas.fused_applicable`); K2 serves those sizes whole on the
    card, so they take K2 here;
  * the channel routes of the CRT plans' prime32 channels
    (`try_fwd32_wide_all` :125, `try_fwd32_perchannel_all` :156,
    `try_pointwise_inv32_all` :180, `try_inv32_all` :219,
    `try_polymul32_stacked` :248-305): `route32` picks the channel grid
    (K1a-K1d) or K2 once per channel;
  * the single-prime 64-bit tier `try_fwd64` / `try_inv64` (:397-409) that
    `prime64.Plan` calls: `tier64` picks the four-step kernel K5 where
    `mxu64.applicable` holds (odd 2^33 < p < 2^64, 2^11 <= n <= 2^15), the
    stage-split hybrid (`ops/stagesplit.py`: butterfly prefix + K5 with
    block tables, tier "K5h") for the same moduli above 2^15, else the stage
    engine (`ops/butterflies64.py`, plain torch: the JAX package has no
    Pallas kernel there). The reference's 'auto' takes the 64-bit hybrid
    above 2^14 (`_hybrid64_wanted` :356-369), where its whole-transform
    kernel meets a VMEM cliff; the card has none and K5 serves 2^15
    directly, so the hybrid starts above 2^15 here. The TPU's cuts between
    its whole-transform kernel and two passes (`fused_applicable`,
    `_fused64_profitable`) are VMEM and lane limits and are not carried
    over, and neither is the hybrid's hardware-parity marker
    (`_hybrid_deployable`: Mosaic plumbing);
  * the Plan52 channel routes (`try_fwd64_wide_all` :412,
    `try_pointwise_inv64_all` :440): `route64` picks the channel grid
    (K7a, K7d) where `mxu64.multi_applicable` holds, else K5 once per
    channel; above 2^15 the channel-grid hybrid (K7c / K7d with block
    tables, :426-433, :452-462) or the single-prime hybrid per channel.

The JAX package routes on the backend and environment knobs; here the route
is the device of the operand, inside the kernel modules: a CUDA tensor
launches the kernel or raises, a CPU tensor runs its plain torch twin, so
the CPU takes the same tier as the card at every n. There is no knob. The
32-bit hybrid (`stagesplit.engine32_fused`, the `*_hybrid32` functions) and
the presplit inverse (`mxu32_cuda.inv_multi_presplit`) are ported and, as in
the reference's 'auto' (:81-122), no route here takes them: K1 / K2 serve
n = 2^16 and 2^17 directly. Where the JAX functions
return None for "not applicable", the 32-bit ones raise NotImplementedError
naming the ROADMAP row (a caller that has another path asks `route32`
first: `product.py` its prime32 plans, the native plans their per-channel
route below 2^11) and the 64-bit single-prime ones return None (the caller's other
path is the stage engine); all return stacked [C, B, n] tensors rather than
lists of channels.
"""

from __future__ import annotations

import torch

from ..utils.profiling import span
from . import butterfly32_cuda, mxu32, mxu32_cuda, mxu64, mxu64_cuda, pointwise_cuda, stagesplit
from .u32 import mont_mul, mont_mul64, mont_neginv, mont_neginv64, to_i64, to_u32


def _primes(plans) -> tuple:
    return tuple(pl.p for pl in plans)


def route32(n: int, primes: tuple) -> str | None:
    """The channel route of a CRT plan's prime32 channels, decided before
    any launch and the same on the CPU as on the card: "K1" (the channel
    grid: every prime 2^29 < p < 2^30, 2^11 <= n <= 2^17), "K2" (the
    four-step once per channel, where `mxu32.applicable` holds for every
    prime: odd p >= 2^26, the same sizes), or None (no channel route: a caller with another
    path takes it, as `product.py` its prime32 plans)."""
    if not primes or n & (n - 1) or not mxu32_cuda.MIN_N <= n <= mxu32_cuda.MAX_N:
        return None
    if all((1 << 29) < p < (1 << 30) for p in primes):
        return "K1"
    variants = ("lt30", "lt31", "generic")
    if all(mxu32.applicable(n, p, variants[mxu32_cuda.regime(p)]) for p in primes):
        return "K2"
    return None


def no_route32(n: int, primes: tuple) -> NotImplementedError:
    """The error of a transform that no prime32 channel route serves."""
    return NotImplementedError(
        f"n = {n}, primes {primes}: no prime32 channel route (the channel grid "
        "K1 takes 30-bit primes, the per-channel four-step K2 odd p >= 2^26, "
        "both at 2^11 <= n <= 2^17; the 64-bit routes K7 / K5 are `route64`'s); "
        "below 2^11 a native plan runs each channel's prime32 plan itself"
    )


def _route(n: int, primes: tuple) -> str:
    route = route32(n, primes)
    if route is None:
        raise no_route32(n, primes)
    return route


def try_fwd32_wide_all(parts, plans):
    """Fused residue split + forward NTT for a CRT plan's prime32 channels:
    little-endian uint32 limb tuple of [B, n] → [C, B, n] NTT-domain
    residues. The per-coefficient `% p` split (native64.rs:980-993) is folded
    into the column matmul as extra operand digit planes (K1a, or K2's
    `fwd_wide` once per channel)."""
    n, primes = parts[0].shape[-1], _primes(plans)
    if _route(n, primes) == "K1":
        return mxu32_cuda.fwd_wide_multi(tuple(parts), primes)
    return torch.stack([mxu32_cuda.fwd_wide(tuple(parts), n=n, p=p) for p in primes])


def try_fwd32_perchannel_all(stacked, plans):
    """Forward NTTs of per-channel operands ([C, B, n], any u32
    representatives) → [C, B, n] NTT-domain residues: K1c, or K2 once per
    channel. Serves the product plan's Bounded forward, whose centred
    residues differ per channel."""
    n, primes = stacked.shape[-1], _primes(plans)
    if _route(n, primes) == "K1":
        return mxu32_cuda.fwd_multi_perchannel(stacked, primes)
    return torch.stack([mxu32_cuda.fwd(stacked[i], n=n, p=p) for i, p in enumerate(primes)])


def _pointwise_scales(n: int, primes: tuple) -> tuple:
    """n^-1 * 2^32 mod p: the normalization and the compensation of the
    bare Montgomery product's 2^-32, folded into the inverse."""
    return tuple(pow(n, p - 2, p) * pow(2, 32, p) % p for p in primes)


def try_pointwise_inv32_all(fl, fr, plans):
    """Pointwise product + normalize + inverse NTT of all channels: fl, fr
    [C, B, n] (any u32 representatives) → standard-order canonical residues
    [C, B, n]. The product is a bare Montgomery multiply (a*b*2^-32); 2^32
    and n^-1 fold into the inverse column matrix — the reference's fused
    mul_assign_normalize + inv (native64.rs:1062-1069). K1d does both in
    one kernel; on the K2 route the product is plain torch per channel."""
    n, primes = fl.shape[-1], _primes(plans)
    scales = _pointwise_scales(n, primes)
    if _route(n, primes) == "K1":
        with span("ntt.transform", "transform") as sp:  # the product fused into the inverse
            out = mxu32_cuda.pointwise_inv_multi(fl, fr, primes, scales)
            sp.io(fl, fr, out)
        return out
    with span("ntt.pointwise", "pointwise") as sp:
        a, b = to_i64(fl), to_i64(fr)
        prods = [to_u32(mont_mul(a[i], b[i], p, mont_neginv(p))) for i, p in enumerate(primes)]
        sp.io(fl, fr, prods)
    with span("ntt.transform", "transform") as sp:
        out = torch.stack([mxu32_cuda.inv(v, n=n, p=p, scale=s)
                           for v, p, s in zip(prods, primes, scales)])
        sp.io(prods, out)
    return out


def try_inv32_all(stacked, plans, scales=None):
    """Unnormalized (unless scaled) inverse NTTs of all channels:
    [C, B, n] uint32, any u32 representatives → standard-order canonical
    (K1b, or K2 once per channel)."""
    n, primes = stacked.shape[-1], _primes(plans)
    scales = tuple(scales) if scales is not None else (1,) * len(primes)
    if _route(n, primes) == "K1":
        return mxu32_cuda.inv_multi(stacked, primes, scales)
    return torch.stack([mxu32_cuda.inv(stacked[i], n=n, p=p, scale=s)
                        for i, (p, s) in enumerate(zip(primes, scales))])


def try_polymul32_stacked(parts_l, parts_r, plans, rhs_binary=False):
    """End-to-end stacked negacyclic polymul over plan32 CRT channels: K1a on
    both operands, the pointwise Montgomery product of every channel
    (`pointwise_mont32`, one streaming kernel where the reference has an XLA
    elementwise stage), then K1b with n^-1 * 2^32 folded into the inverse column
    matrix. Returns standard-order residues [C, B, n] (uint32)."""
    primes = _primes(plans)
    n = parts_l[0].shape[-1]
    parts_r = tuple(parts_r[:1]) if rhs_binary else tuple(parts_r)
    with span("ntt.transform", "transform") as sp:
        fl = mxu32_cuda.fwd_wide_multi(tuple(parts_l), primes)
        sp.io(parts_l, fl)
    with span("ntt.transform", "transform") as sp:
        fr = mxu32_cuda.fwd_wide_multi(parts_r, primes)
        sp.io(parts_r, fr)
    with span("ntt.pointwise", "pointwise") as sp:
        prod = pointwise_mont32(fl, fr, primes)
        sp.io(fl, fr, prod)
    with span("ntt.transform", "transform") as sp:
        out = mxu32_cuda.inv_multi(prod, primes, _pointwise_scales(n, primes))
        sp.io(prod, out)
    return out


def pointwise_mont32(fl, fr, primes: tuple):
    """The stacked polymul's pointwise stage: the bare Montgomery product
    a·b·2^-32 mod p of each channel, [C, B, n] uint32 operands -> [C, B, n]
    uint32 in K1d's form (`ops/pointwise_cuda.py`): one launch of the kernel
    for CUDA tensors, its plain twin for CPU ones. The forward transforms'
    outputs (< p) make it canonical; the scaled inverse takes any
    representative, so the polymul's bits do not depend on it."""
    if fl.device.type == "cuda":
        return pointwise_cuda.mont_mul32(fl, fr, primes)
    return pointwise_cuda.mont_mul32_plain(fl, fr, primes)


def tier32(n: int, p: int, variant: str) -> str:
    """The prime32 tier for (n, p): "K2" (the four-step kernel, or its plain
    twin on the CPU) where `mxu32.applicable` holds; else "K4" (the butterfly
    kernel, or its plain twin, the stage engine) up to
    `butterfly32_cuda.MAX_N` = 2^17 (the reference's Pallas kernel stops at
    2^15 and its XLA stage engine computes the same function above), and
    above it "stage": the stage engine in plain torch on the operand's
    device. Decided before any launch from (n, p) alone, so the same on
    every device."""
    if mxu32.applicable(n, p, variant):
        return "K2"
    return "K4" if n <= butterfly32_cuda.MAX_N else "stage"


def fwd32(x, tbl, *, p, variant, p_neginv):
    """Forward NTT of one prime: [B, n] uint32 -> bit-reversed [0, p)."""
    n = x.shape[-1]
    tier = tier32(n, p, variant)
    if tier == "K2":
        return mxu32_cuda.fwd(x, n=n, p=p)
    run = butterfly32_cuda.try_fwd if tier == "K4" else butterfly32_cuda.fwd_plain
    return run(x, tbl, p=p, variant=variant, p_neginv=p_neginv)


def inv32(x, tbl, *, p, variant, p_neginv):
    """Unnormalized inverse NTT of one prime: [B, n] uint32 bit-reversed ->
    standard order [0, p)."""
    n = x.shape[-1]
    tier = tier32(n, p, variant)
    if tier == "K2":
        return mxu32_cuda.inv(x, n=n, p=p)
    run = butterfly32_cuda.try_inv if tier == "K4" else butterfly32_cuda.inv_plain
    return run(x, tbl, p=p, variant=variant, p_neginv=p_neginv)


# ---------------------------------------------------------------------------
# prime64: the single-prime tier and the Plan52 channel routes
# ---------------------------------------------------------------------------


def tier64(n: int, p: int, device=None) -> str:
    """The prime64 tier for (n, p): "K5" (the four-step kernel, or its plain
    twin on the CPU) up to 2^15, "K5h" (the stage-split hybrid around K5
    with block tables, or its plain twin) above, both for the moduli the
    four-step takes, else "stage" (the stage engine in plain torch).
    Decided before any launch, and the same on every device (`device` is
    accepted and not read)."""
    if n <= mxu64_cuda.MAX_N:
        return "K5" if mxu64.applicable(n, p) else "stage"
    return "K5h" if stagesplit.applicable64(n, p) else "stage"


def try_fwd64(limbs, n: int, p: int):
    """Four-step forward for prime64, (lo, hi) [B, n] uint32 -> (lo, hi)
    bit-reversed [0, p); None where the stage engine serves (n, p)."""
    tier = tier64(n, p)
    if tier == "K5":
        return mxu64_cuda.fwd(tuple(limbs), n=n, p=p)
    if tier == "K5h":
        return stagesplit.engine64_fused.fwd(tuple(limbs), n=n, p=p)
    return None


def try_inv64(limbs, n: int, p: int, scale: int = 1):
    """Four-step inverse for prime64 (a scale folded into A_inv); None where
    the stage engine serves (n, p)."""
    tier = tier64(n, p)
    if tier == "K5":
        return mxu64_cuda.inv(tuple(limbs), n=n, p=p, scale=scale)
    if tier == "K5h":
        return stagesplit.engine64_fused.inv(tuple(limbs), n=n, p=p, scale=scale)
    return None


def route64(n: int, primes: tuple) -> str | None:
    """The channel route of a CRT plan's prime64 (Plan52) channels, decided
    before any launch and the same on the CPU as on the card. For
    2^11 <= n <= 2^15: "K7" (the channel grid: `mxu64.multi_applicable`) or
    "K5" (the four-step once per channel where `mxu64.applicable` holds for
    every prime). Above 2^15: "K7h" (the channel-grid hybrid,
    `stagesplit.multi_hybrid_applicable64`) or "K5h" (the single-prime hybrid
    once per channel). Else None (each channel's prime64 plan: the stage
    engine)."""
    if not primes or n & (n - 1) or n < mxu64_cuda.MIN_N:
        return None
    if n > mxu64_cuda.MAX_N:
        if stagesplit.multi_hybrid_applicable64(n, primes):
            return "K7h"
        return "K5h" if all(stagesplit.applicable64(n, p) for p in primes) else None
    if mxu64.multi_applicable(n, primes):
        return "K7"
    return "K5" if all(mxu64.applicable(n, p) for p in primes) else None


def _stack_channels(outs: list) -> tuple:
    return tuple(torch.stack([o[i] for o in outs]) for i in range(2))


def _engine64(route: str):
    """The single-prime engine of a per-channel route."""
    return mxu64_cuda if route == "K5" else stagesplit.engine64_fused


def try_fwd64_wide_all(parts, plans):
    """Fused residue split + forward NTT for a CRT plan's prime64 channels:
    (lo, hi) [B, n] uint32 -> (lo, hi) of [C, B, n] NTT-domain residues. The
    four-step takes any u64 representative, so the per-coefficient `mod p`
    split disappears (K7a, or K5 once per channel; above 2^15 the hybrids).
    None without a route."""
    n, primes = parts[0].shape[-1], _primes(plans)
    route = route64(n, primes)
    if route is None:
        return None
    if route == "K7":
        return mxu64_cuda.fwd_multi(tuple(parts), primes)
    if route == "K7h":
        return stagesplit.fwd_multi_hybrid64(tuple(parts), primes, n=n)
    return _stack_channels([_engine64(route).fwd(tuple(parts), n=n, p=p) for p in primes])


def _pointwise_scales64(n: int, primes: tuple) -> tuple:
    """n^-1 * 2^64 mod p: the normalization and the compensation of the bare
    Montgomery product's 2^-64, folded into the inverse."""
    return tuple(pow(n, p - 2, p) * pow(2, 64, p) % p for p in primes)


def try_pointwise_inv64_all(fl, fr, plans):
    """Pointwise Montgomery product + normalized inverse NTT of all Plan52
    channels: fl, fr = (lo, hi) of [C, B, n] uint32 -> (lo, hi) of [C, B, n]
    standard-order canonical residues. K7d does both in one kernel (with
    block tables inside the channel-grid hybrid); on the per-channel routes
    the product is plain torch. None without a route."""
    n, primes = fl[0].shape[-1], _primes(plans)
    route = route64(n, primes)
    if route is None:
        return None
    scales = _pointwise_scales64(n, primes)
    if route in ("K7", "K7h"):
        with span("ntt.transform", "transform") as sp:  # the product fused into the inverse
            if route == "K7":
                out = mxu64_cuda.pointwise_inv_multi(tuple(fl), tuple(fr), primes, scales)
            else:
                out = stagesplit.pointwise_inv_multi_hybrid64(tuple(fl), tuple(fr), primes,
                                                              scales, n=n)
            sp.io(fl, fr, out)
        return out
    with span("ntt.pointwise", "pointwise") as sp:
        a, b = tuple(map(to_i64, fl)), tuple(map(to_i64, fr))
        prods = [tuple(to_u32(t) for t in mont_mul64((a[0][i], a[1][i]), (b[0][i], b[1][i]),
                                                     p, mont_neginv64(p)))
                 for i, p in enumerate(primes)]
        sp.io(fl, fr, prods)
    with span("ntt.transform", "transform") as sp:
        out = _stack_channels([_engine64(route).inv(v, n=n, p=p, scale=s)
                               for v, p, s in zip(prods, primes, scales)])
        sp.io(prods, out)
    return out
