"""Shared machinery for the native (CRT wrapping-arithmetic) NTT plans.

Counterpart of `concrete_ntt_tpu/_native_common.py`, in two tiers: Plan32
(k 30-bit prime32 channels) and Plan52 (k 50-bit prime64 channels). A plan
splits wrapping values into residues over its primes, transforms each
channel, and lifts the residues back with a signed CRT reconstruction.

Data conventions (the JAX package's, so that tests compare like with like):
  * u64-width values: a planar tuple `(lo, hi)` of uint32 tensors [..., n]
    (the performance format: the kernels consume it as it is), a numpy
    uint64 array [..., n], or a uint32 limb tensor [..., n, 2];
  * Plan32 NTT-domain residues: uint32 tensors [k, ..., n], channel-leading;
  * Plan52 NTT-domain residues: uint32 tensors [k, ..., n, 2].

A plan has a device, given at construction and by default the card
("cuda"): numpy input is moved there, a tensor computes on the device it is
on (CUDA tensors through the kernels K1a / K1b, K7a / K7d / K5; CPU
tensors through their plain torch twins). With the default and no GPU a
numpy call raises; the CPU is what a caller asks for with `device="cpu"`.
Output stays on the computing device, except the numpy format.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from . import prime32, prime64
from .ops import crt as crt_ops
from .ops import ntt_dispatch
from .ops.u32 import (
    DEFAULT_DEVICE,
    input_tensor,
    limbs_to_np_u64,
    np_u64_to_limbs,
    to_i64,
    to_u32,
)


def _marshal_in(x, width: int, n: int, device=DEFAULT_DEVICE):
    """→ (contiguous uint32 limb tensors tuple, lead shape, format tag)."""
    nlimbs = width // 32
    if (
        isinstance(x, (list, tuple))
        and len(x) == nlimbs
        and all(isinstance(e, torch.Tensor) and e.dim() >= 1 for e in x)
    ):
        if any(a.dtype != torch.uint32 or a.shape != x[0].shape for a in x):
            raise TypeError(f"planar limbs must be {nlimbs} same-shape uint32 tensors")
        if x[0].shape[-1] != n:
            raise ValueError(f"transform axis must be n={n}, got {tuple(x[0].shape)}")
        lead = tuple(x[0].shape[:-1])
        return tuple(a.reshape(-1, n).contiguous() for a in x), lead, "planar"
    if isinstance(x, np.ndarray) and x.dtype == np.uint64 and width == 64:
        limbs = input_tensor(np_u64_to_limbs(x), device)
        fmt = "np64"
    elif isinstance(x, torch.Tensor):
        limbs = x
        if limbs.dtype != torch.uint32 or limbs.shape[-1] != nlimbs:
            raise TypeError(f"expected uint32 limb tensor [..., {n}, {nlimbs}]")
        fmt = "limbs"
    else:
        raise TypeError(
            f"expected a planar tuple of {nlimbs} uint32 tensors, a numpy uint64 "
            f"array or a uint32 limb tensor [..., {n}, {nlimbs}]"
        )
    if limbs.dim() < 2 or limbs.shape[-2] != n:
        raise ValueError(f"transform axis must be n={n}, got {tuple(limbs.shape)}")
    lead = tuple(limbs.shape[:-2])
    limbs = limbs.reshape(-1, n, nlimbs)
    return tuple(limbs[..., i].contiguous() for i in range(nlimbs)), lead, fmt


def _marshal_out(parts: tuple, lead, fmt: str, n: int):
    if fmt == "planar":
        return tuple(p.reshape(*lead, n) for p in parts)
    out = torch.stack(parts, dim=-1).reshape(*lead, n, len(parts))
    if fmt == "np64":
        return limbs_to_np_u64(out.cpu().numpy())
    return out


def _fmt_of(x) -> str:
    if isinstance(x, np.ndarray) and x.dtype == np.uint64:
        return "np64"
    if isinstance(x, (list, tuple)):
        return "planar"
    return "limbs"


@dataclass(frozen=True)
class NativePlanBase:
    """k-channel CRT plan: split → k prime NTTs → pointwise → k inverse NTTs
    → signed wrapping reconstruction (reference call stack SURVEY.md §3.3)."""

    n: int
    width: int  # the wrapping arithmetic width (64 in this port so far)
    primes: tuple
    plans: tuple = field(repr=False)  # underlying prime32 / prime64 Plans
    tier: str = "plan32"  # "plan32" (u32 channels) | "plan52" (u64 limb-pair channels)
    device: str = DEFAULT_DEVICE

    def _residues_in(self, ntt):
        """Validate/flatten user-provided NTT-domain residues."""
        if isinstance(ntt, np.ndarray):
            ntt = input_tensor(np.array(ntt), self.device)  # a writable copy
        if not isinstance(ntt, torch.Tensor) or ntt.dtype != torch.uint32:
            raise TypeError("expected NTT-domain residues as a uint32 tensor")
        trail = (self.n,) if self.tier == "plan32" else (self.n, 2)
        k = len(self.primes)
        if (ntt.dim() < 1 + len(trail) or ntt.shape[0] != k
                or tuple(ntt.shape[-len(trail):]) != trail):
            raise ValueError(
                f"expected residues [k={k}, ..., {', '.join(map(str, trail))}], "
                f"got {tuple(ntt.shape)}"
            )
        lead = tuple(ntt.shape[1:-len(trail)])
        return ntt.reshape(k, -1, *trail).contiguous(), lead

    def _lift(self, residues, lead, fmt: str):
        """Standard-order residues (uint32 [k, B, n], or a (lo, hi) pair of
        such for plan52) → wrapping values in `fmt`."""
        k = len(self.primes)
        if self.tier == "plan32":
            mods = to_i64(residues)
            mods = [mods[i] for i in range(k)]
        else:
            lo, hi = to_i64(residues[0]), to_i64(residues[1])
            mods = [(lo[i], hi[i]) for i in range(k)]
        value_parts = self._reconstruct(mods)
        return _marshal_out(tuple(to_u32(v) for v in value_parts), lead, fmt, self.n)

    def _reconstruct(self, residues):
        raise NotImplementedError

    # -- plan52: the per-channel route (no channel route: the stage engine) ----

    def _fwd52_channels(self, parts):
        """(lo, hi) [B, n] → (lo, hi) of [k, B, n]: explicit residue split,
        then each channel's prime64 plan."""
        res = crt_ops.split_u64_to_p50(to_i64(parts[0]), to_i64(parts[1]), self.primes)
        outs = [pl.fwd_pair(to_u32(r[0]), to_u32(r[1])) for pl, r in zip(self.plans, res)]
        return tuple(torch.stack([o[i] for o in outs]) for i in range(2))

    def _fwd52(self, parts):
        out = ntt_dispatch.try_fwd64_wide_all(parts, self.plans)
        return out if out is not None else self._fwd52_channels(parts)

    def _pointwise_inv52(self, fl, fr):
        """Per-channel pointwise·n^-1 then inverse NTT → standard-order
        residues (lo, hi) of [k, B, n]: K7d (or plain mont_mul64 + K5) on a
        channel route, else each plan's mul_assign_normalize and inverse."""
        fused = ntt_dispatch.try_pointwise_inv64_all(fl, fr, self.plans)
        if fused is not None:
            return fused
        outs = []
        for i, pl in enumerate(self.plans):
            limbs = lambda pair: torch.stack([pair[0][i], pair[1][i]], dim=-1)
            prod = pl.mul_assign_normalize(limbs(fl), limbs(fr))
            outs.append(pl.inv_pair(prod[..., 0].contiguous(), prod[..., 1].contiguous()))
        return tuple(torch.stack([o[i] for o in outs]) for i in range(2))

    # -- transforms -------------------------------------------------------------

    def fwd(self, x):
        """value array [..., n] → NTT-domain residues [k, ..., n] (plan32) or
        [k, ..., n, 2] (plan52), uint32."""
        parts, lead, _ = _marshal_in(x, self.width, self.n, self.device)
        k = len(self.primes)
        if self.tier == "plan32":
            return ntt_dispatch.try_fwd32_wide_all(parts, self.plans).reshape(k, *lead, self.n)
        return torch.stack(self._fwd52(parts), dim=-1).reshape(k, *lead, self.n, 2)

    def inv(self, ntt, out_format: str | None = None):
        """NTT-domain residues → wrapping values (signed CRT lift),
        unnormalized as the reference's: inv(fwd(x)) == n·x (wrapping).
        out_format: "limbs" (default, [..., n, 2]), "planar" or "np64"."""
        arr, lead = self._residues_in(ntt)
        if self.tier == "plan32":
            stacked = ntt_dispatch.try_inv32_all(arr, self.plans)
        else:
            outs = [pl.inv_pair(arr[i, ..., 0].contiguous(), arr[i, ..., 1].contiguous())
                    for i, pl in enumerate(self.plans)]
            stacked = tuple(torch.stack([o[i] for o in outs]) for i in range(2))
        return self._lift(stacked, lead, out_format or "limbs")

    def negacyclic_polymul(self, lhs, rhs, rhs_binary: bool = False):
        """Wrapping negacyclic product (reference native64.rs:1042-1069) in
        the format of `lhs`. rhs_binary: rhs holds {0, 1} coefficients, so
        its low limb is its residue in every channel (plan52 transforms it
        like any operand: the forward's result is canonical either way)."""
        parts_l, lead, _ = _marshal_in(lhs, self.width, self.n, self.device)
        parts_r, _, _ = _marshal_in(rhs, self.width, self.n, self.device)
        if self.tier == "plan32":
            stacked = ntt_dispatch.try_polymul32_stacked(
                parts_l, parts_r, self.plans, rhs_binary
            )
        else:
            stacked = self._pointwise_inv52(self._fwd52(parts_l), self._fwd52(parts_r))
        return self._lift(stacked, lead, _fmt_of(lhs))

    # -- accessors (parity with ntt_0()..ntt_k(), native64.rs:950-969) --------

    def ntt(self, i: int):
        return self.plans[i]


def build_plans32(n: int, primes, device=DEFAULT_DEVICE) -> tuple:
    plans = tuple(prime32.Plan.try_new(n, p, device) for p in primes)
    if any(p is None for p in plans):
        return ()
    return plans


def build_plans52(n: int, primes, device=DEFAULT_DEVICE) -> tuple:
    plans = tuple(prime64.Plan.try_new(n, p, device) for p in primes)
    if any(p is None for p in plans):
        return ()
    return plans
